"""What the port's measuring entry points share: the JAX scripts' default
config and scenes (the port's own copies), the device check, a timer, and
the card's name and power limit.

Every entry point runs on the card unless ``--device cpu`` asks for the
host; with no card it exits 2 with the device check's message, as
``runtime/cli.py`` does. Nothing falls back to the CPU."""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from blah2_tpu_torch.capture.source import Source
from blah2_tpu_torch.config import Config, config_from_dict
from blah2_tpu_torch.device import resolve_device
from blah2_tpu_torch.dsp.pipeline import CpiPipeline
from blah2_tpu_torch.ops.pack12 import MAX12, MIN12, pack12_quads

#: The reference's default geometry (``config/config.yml``): 2 MHz and
#: 0.75 s CPIs, 1.5 Msample CPIs.
DEFAULT_FS = 2_000_000
DEFAULT_CPI = 0.75
#: The reference's real-time rate in Msamples/s (RSPduo at 2 MHz), the
#: denominator of ``vs_baseline`` for throughputs.
REALTIME_MSPS = 2.0


def default_config(fs: int = DEFAULT_FS, cpi: float = DEFAULT_CPI) -> Config:
    """The benches' config, a copy of ``__graft_entry__.py:19-33``: the
    reference's default windows (delay −10..400, Doppler ±200 Hz, Wiener
    lags −10..400, CA-CFAR) at sample rate ``fs`` and CPI ``cpi``."""
    return config_from_dict({
        "capture": {"fs": fs, "fc": 204_640_000},
        "process": {
            "data": {"cpi": cpi, "buffer": 2},
            "ambiguity": {"delayMin": -10, "delayMax": 400,
                          "dopplerMin": -200, "dopplerMax": 200},
            "clutter": {"enable": True, "delayMin": -10, "delayMax": 400},
            "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                          "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                          "nCentroid": 6},
        },
    })


def add_device_args(parser: argparse.ArgumentParser, fs: int,
                    cpi: float) -> None:
    """``--device``, and ``--fs`` and ``--cpi`` with the script's own
    geometry ``fs`` and ``cpi`` as their defaults."""
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card, cuda; cpu "
                             "runs on the host)")
    parser.add_argument("--fs", type=int, default=fs,
                        help="sample rate override (a CPU run takes "
                             "200000)")
    parser.add_argument("--cpi", type=float, default=cpi,
                        help="CPI length override in seconds (a CPU run "
                             "takes 0.1)")


def device_or_exit(device) -> torch.device:
    """``device`` as a torch device. Where it needs a card (the default)
    and none is present, print why and exit 2."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        raise SystemExit(2) from None


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (its first card);
    None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_detail(device: torch.device) -> dict:
    """``device`` (the card's name, or ``cpu``) and ``card`` (its
    ``nvidia-smi`` name and power limit, None on the CPU) for a result's
    ``detail``."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return {"device": name, "card": card_line(device)}


def free_ports(n: int) -> List[int]:
    """``n`` distinct localhost ports the system hands out free (each
    bound to port 0, then released)."""
    socks = []
    try:
        for _ in range(n):
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            socks.append(sock)
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def emit(result: dict) -> dict:
    """Print ``result`` as one JSON line and return it."""
    print(json.dumps(result), flush=True)
    return result


def at(sorted_values: list, fraction: float):
    """The JAX scripts' percentile: ``sorted_values[int(len · fraction)]``."""
    return sorted_values[int(len(sorted_values) * fraction)]


# -- scenes ---------------------------------------------------------------

def _planes_i12(v: np.ndarray) -> np.ndarray:
    """Unit-variance complex64 samples as (n, 2) int16 planes of 12-bit
    ADC counts: scaled by 400 and clipped as the ADC clips."""
    p = CpiPipeline.to_planes(v) * 400.0
    return np.clip(p, MIN12, MAX12).astype(np.int16)


def packed12_scene(n: int, fs: float, n_buf: int = 8,
                   seed: int = 0) -> List[np.ndarray]:
    """``bench.py:58-79``'s buffers: ``n_buf`` CPIs of direct path plus a
    target at delay 37 and 60 Hz, each the packed-12 bytes of its
    [i1, q1, i2, q2] quads."""
    rng = np.random.default_rng(seed)
    bufs = []
    for _ in range(n_buf):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
        y = (0.1 * np.roll(x, 37) * np.exp(2j * np.pi * 60.0 *
                                           np.arange(n) / fs)
             + 2.0 * x
             + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
        quads = np.ascontiguousarray(
            np.concatenate([_planes_i12(x), _planes_i12(y)], axis=1))
        bufs.append(pack12_quads(quads))
    return bufs


def record_scene(cfg: Config, path: str) -> str:
    """``bench_runtime.py:43-65``'s recording, written under ``path``: two
    CPIs of clutter and a target at delay 37 and 60 Hz in 12-bit ADC counts
    (scaled by 300, clipped), which the runtime's replay loops. Returns the
    file's name."""
    n, fs = cfg.n_samples, cfg.capture.fs
    rng = np.random.default_rng(7)
    src = Source("RspDuo", fs, cfg.capture.fc, path=path)
    fname = src.open_record_file()
    for k in range(2):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        t = (k * n + np.arange(n)) / fs
        y = (2.0 * x + 0.1 * np.roll(x, 37) *
             np.exp(2j * np.pi * 60.0 * t) +
             1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))

        def adc(v):
            return (np.clip(v.real * 300.0, -2047, 2047) +
                    1j * np.clip(v.imag * 300.0, -2047, 2047))
        src.record(adc(x), adc(y))
    src.close_record_file()
    return fname


def scaling_batch(rng: np.random.Generator, b: int, n: int):
    """``bench_scaling.py:115-116``'s step batch: ``b`` CPIs of complex64
    noise ``xb`` and ``yb = 2 xb + 0.1 · xb`` delayed by 31 samples, drawn
    from ``rng`` (one generator, seed 0, for the whole sweep)."""
    xb = (rng.standard_normal((b, n)) +
          1j * rng.standard_normal((b, n))).astype(np.complex64)
    yb = (2.0 * xb + 0.1 * np.roll(xb, 31, axis=1)).astype(np.complex64)
    return xb, yb


# -- time on the device ---------------------------------------------------

def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Milliseconds of work on ``device``: between two CUDA events on a
    card (what was enqueued between them), by the host clock around the
    work on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"

    def ms(self, fn: Callable[[], object], n: int = 1) -> float:
        """Milliseconds per call over ``n`` back-to-back calls of ``fn``."""
        synchronize(self.device)
        if not self.on_card:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return 1e3 * (time.perf_counter() - t0) / n
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
