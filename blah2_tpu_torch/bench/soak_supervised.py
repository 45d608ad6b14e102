"""Supervised bounded-lifetime soak: radar restarts under the watchdog's bound
(counterpart of ``tools/soak_supervised.py``).

The reference keeps its radar alive with a restart contract
(`script/blah2_rspduo_restart.bash:6-17`, ``deploy/watchdog.bash``): the
processor is restarted when the map goes stale for more than 60 s, while
the API stays up. This tool demonstrates that contract for the port:

  - ONE standalone API process (``python -m blah2_tpu_torch.net.api``: TCP
    ingest and stashes) stays up for the whole soak, so products and
    stashes survive radar restarts;
  - the radar runs as a sequence of bounded-lifetime CLI workers
    (``python -m blah2_tpu_torch.runtime.cli --no-api --tcp-egress --cpis
    N``), the supervisor starting the next when one exits cleanly;
  - the supervisor samples each worker's RSS from ``/proc/<pid>/status``
    (the sawtooth) and polls ``/api/timestamp`` to time every product gap,
    the gaps across restarts among them. A restart's gap on the card holds
    the torch import, the CUDA context, loading the kernels from
    ``blah2_tpu_torch/build/``, pinned buffers, cuFFT plans and the first
    CPI.

The scene, geometry and config document are the JAX tool's
(``bench_runtime.py``'s default config and recording, ``bench/common.py``).
On a card both kernels are built before the first worker starts, as
``chip_smoke.py`` does; the build (a fresh checkout's cold ``nvcc``) and the
first worker's time to its first product are reported apart
(``kernel_build_s``, ``first_product_s``).

Failures (an empty ``failures`` list is the contract demonstrated):
  - a product gap of 60 s or more (the deployed watchdog's bound);
  - an RSS sample at or over the cap (``--rss-cap-mb``, default
    :data:`RSS_CAP_MB`);
  - a worker exiting non-zero or past its deadline, or fewer CPIs than
    asked;
  - fewer product updates seen than cycles.

    python -m blah2_tpu_torch.bench.soak_supervised --cycles 4 \
        --cpis-per-cycle 80
    python -m blah2_tpu_torch.bench.soak_supervised --device cpu --fs 200000 \\
        --cpi 0.1 --cycles 2 --cpis-per-cycle 3

Prints one JSON line per cycle, then the result line; exits 1 on a failure.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import yaml

from blah2_tpu_torch.bench.common import (DEFAULT_CPI, DEFAULT_FS,
                                          add_device_args, default_config,
                                          device_detail, device_or_exit, emit,
                                          free_ports, record_scene)
from blah2_tpu_torch.bench.soak import rss_mb
from blah2_tpu_torch.config import Config
from blah2_tpu_torch.net.topology import wait_for_ports

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: The deployed watchdog's staleness bound (``deploy/watchdog.bash``).
WATCHDOG_S = 60.0
#: The RSS cap in MB: ``bench.soak``'s first window on the card, 5,622.25 MB
#: (NVIDIA H100 80GB HBM3, 700.00 W; the process that holds the runtime, a
#: CUDA context and an in-process API), plus a margin of 25 % for a worker's
#: own pinned buffers and allocator pools, rounded down. A process that grows
#: by 1.4 GB in a cycle trips it.
RSS_CAP_MB = 7000.0
#: Seconds between RSS samples and between polls of ``/api/timestamp``.
RSS_EVERY_S = 0.5
POLL_EVERY_S = 0.2
#: Longest a worker may run, and the API may take to open its ports.
WORKER_SECONDS = 900.0
API_SECONDS = 120.0
PRODUCTS = ("map", "detection", "track", "timestamp", "timing", "iqdata")


def config_doc(cfg: Config, scene: str, ports: List[int]) -> dict:
    """``tools/soak_supervised.py:114-142``'s one config for both processes:
    the looped replay of ``scene``, the geometry of ``cfg``, its detector and
    tracker, and the API and six product ports ``ports[0:7]`` (config port
    ``ports[7]``) on localhost."""
    amb, clut = cfg.process.ambiguity, cfg.process.clutter
    return {
        "capture": {"fs": cfg.capture.fs, "fc": cfg.capture.fc,
                    "device": {"type": "RspDuo"},
                    "replay": {"state": True, "loop": True, "file": scene}},
        "process": {
            "data": {"cpi": cfg.process.data.cpi, "buffer": 2},
            "ambiguity": {"delayMin": amb.delay_min,
                          "delayMax": amb.delay_max,
                          "dopplerMin": amb.doppler_min,
                          "dopplerMax": amb.doppler_max},
            "clutter": {"enable": True, "delayMin": clut.delay_min,
                        "delayMax": clut.delay_max},
            "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                          "nTrain": 10, "minDelay": 5, "minDoppler": 15,
                          "nCentroid": 16},
            "tracker": {"enable": True,
                        "initiate": {"M": 3, "N": 5, "maxAcc": 2.0},
                        "delete": 8, "smooth": "none"},
        },
        "network": {"ip": "127.0.0.1",
                    "ports": dict(zip(("api",) + PRODUCTS + ("config",),
                                      ports))},
    }


#: The radar worker's program: the CLI.
CLI = (sys.executable, "-m", "blah2_tpu_torch.runtime.cli")


def worker_command(cfg_path: str, cpis: int, device,
                   launcher: Sequence[str] = CLI) -> List[str]:
    """One bounded-lifetime radar worker: ``launcher`` (the CLI, or a
    program that runs the CLI's entry point on the arguments that follow
    it) with TCP egress and no API, ``cpis`` CPIs, no staged samples
    (``tools/soak_supervised.py:160-164``), on ``device`` (None: the
    card)."""
    cmd = [*launcher, "-c", cfg_path, "--no-api", "--tcp-egress", "--cpis",
           str(cpis), "--staged-sample-every", "0", "--quiet"]
    return cmd + (["--device", str(device)] if device is not None else [])


def last_stamp(text: str) -> int:
    """The last millisecond timestamp in the API's timestamp product. Its
    listener publishes every chunk it receives (`api/server.js:166-176`),
    so stamps sent close together arrive joined ("<ms><ms>")."""
    return int(re.findall(r"\d{13}", text)[-1])


class TimestampWatcher(threading.Thread):
    """Polls ``/api/timestamp``; records (host clock s, timestamp ms) at
    every change."""

    def __init__(self, url: str, interval: float = POLL_EVERY_S):
        super().__init__(daemon=True)
        self.url = url
        self.interval = interval
        self.events: list = []
        self._halt = threading.Event()

    def run(self) -> None:
        last = None
        while not self._halt.is_set():
            try:
                with urllib.request.urlopen(self.url, timeout=2) as r:
                    ts = r.read().decode().strip()
                if ts and ts != last:
                    last = ts
                    self.events.append((time.perf_counter(),
                                        last_stamp(ts)))
            except (OSError, IndexError):
                pass
            self._halt.wait(self.interval)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=10)


def build_kernels(device) -> Optional[dict]:
    """On a card: build both kernels (one ``nvcc`` each, started together)
    before any worker, as ``chip_smoke.py`` does. Returns the seconds and
    whether any library was missing (a cold build); None on the CPU."""
    if device.type != "cuda":
        return None
    from blah2_tpu_torch.ops import _build

    names = ("detect", "halo")
    cold = not all(os.path.exists(_build.library_path(n)) for n in names)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    return {"seconds": time.perf_counter() - t0, "cold": cold}


def split_events(events, starts_ms):
    """The product events of each worker: a product belongs to the last
    worker started at or before its timestamp (its CPI's extraction)."""
    per = [[] for _ in starts_ms]
    for t, ts in events:
        k = max((i for i, s in enumerate(starts_ms) if s <= ts), default=None)
        if k is not None:
            per[k].append(t)
    return per


def main(argv=None, launcher: Sequence[str] = CLI) -> dict:
    """The soak on ``argv``; each worker runs ``launcher`` (see
    :func:`worker_command`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(ap, fs=DEFAULT_FS, cpi=DEFAULT_CPI)
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--cpis-per-cycle", type=int, default=80)
    ap.add_argument("--rss-cap-mb", type=float, default=RSS_CAP_MB)
    ap.add_argument("--api-port", type=int, default=None,
                    help="API port; the products take the next seven "
                         "(default: free ports)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)

    cfg0 = default_config(args.fs, args.cpi)
    budget_ms = 1e3 * cfg0.n_samples / cfg0.capture.fs
    ports = (list(range(args.api_port, args.api_port + 8))
             if args.api_port else free_ports(8))
    build = build_kernels(dev)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cycles: list = []
    fails: list = []
    starts_ms: list = []
    t_starts: list = []
    with tempfile.TemporaryDirectory(prefix="soak_supervised_") as tmp:
        scene = record_scene(cfg0, tmp)
        cfg_path = os.path.join(tmp, "soak_config.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config_doc(cfg0, scene, ports), f)
        api = subprocess.Popen(
            [sys.executable, "-m", "blah2_tpu_torch.net.api", "-c",
             cfg_path], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        watcher = TimestampWatcher(
            f"http://127.0.0.1:{ports[0]}/api/timestamp")
        t_soak0 = time.perf_counter()
        try:
            # The senders connect within seconds of the worker's start:
            # the API's ingest must be open before the first one.
            wait_for_ports(ports[:7], lambda: api.poll() is None,
                           API_SECONDS)
            watcher.start()
            cmd = worker_command(cfg_path, args.cpis_per_cycle, args.device,
                                 launcher)
            for c in range(args.cycles):
                t_c0 = time.perf_counter()
                starts_ms.append(int(time.time() * 1000))
                t_starts.append(t_c0)
                w = subprocess.Popen(cmd, cwd=REPO, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                out_lines: list = []
                reader = threading.Thread(
                    target=lambda p=w, o=out_lines: o.extend(p.stdout),
                    daemon=True)
                reader.start()
                rss = []
                while w.poll() is None:
                    if time.perf_counter() - t_c0 > WORKER_SECONDS:
                        w.kill()
                        fails.append(f"cycle {c}: worker ran past "
                                     f"{WORKER_SECONDS} s")
                        break
                    v = rss_mb(w.pid)
                    if v > 10.0:  # past the exec
                        rss.append(v)
                    time.sleep(RSS_EVERY_S)
                rc = w.wait()
                reader.join(timeout=10)
                cycles.append(emit({
                    "cycle": c,
                    "exit_code": rc,
                    "wall_s": time.perf_counter() - t_c0,
                    "rss_mb_first": rss[0] if rss else None,
                    "rss_mb_max": max(rss) if rss else None,
                    "rss_mb_last": rss[-1] if rss else None,
                    "rss_samples": len(rss),
                    "products_seen_so_far": len(watcher.events),
                }))
                if rc != 0:
                    fails.append(f"cycle {c}: worker exited {rc}: "
                                 + "".join(out_lines)[-2000:].strip())
                    break
            # The last products cross the API's ingest on its threads.
            time.sleep(4 * POLL_EVERY_S)
        finally:
            watcher.stop()
            api.terminate()
            try:
                api.wait(timeout=15)
            except subprocess.TimeoutExpired:
                api.kill()
                api.wait()
        wall_total = time.perf_counter() - t_soak0

    events = watcher.events
    times = [t for t, _ in events]
    gaps = [b - a for a, b in zip(times, times[1:])]
    max_gap = max(gaps) if gaps else None
    per_worker = split_events(events, starts_ms)
    # Each restart's gap: the last product of one worker to the first of
    # the next; each worker's first product after its start.
    restart_gaps = [nxt[0] - prev[-1] for prev, nxt in
                    zip(per_worker, per_worker[1:]) if prev and nxt]
    first_product = [ev[0] - t0 if ev else None
                     for ev, t0 in zip(per_worker, t_starts)]
    cpis_done = sum(args.cpis_per_cycle for c in cycles
                    if c["exit_code"] == 0)
    rss_max = max((c["rss_mb_max"] or 0.0) for c in cycles) if cycles \
        else 0.0
    if max_gap is not None and max_gap >= WATCHDOG_S:
        fails.append(f"product gap {max_gap:.1f} s >= watchdog "
                     f"{WATCHDOG_S:.0f} s bound")
    if rss_max >= args.rss_cap_mb:
        fails.append(f"rss {rss_max} MB >= cap {args.rss_cap_mb} MB")
    if cpis_done < args.cycles * args.cpis_per_cycle:
        fails.append(f"{cpis_done} CPIs done of "
                     f"{args.cycles * args.cpis_per_cycle} asked")
    if len(events) < len(cycles):
        fails.append("API saw fewer product updates than cycles "
                     f"({len(events)} < {len(cycles)})")
    result = {
        "metric": "supervised_restart_soak",
        "value": cpis_done,
        "unit": "CPIs across restart cycles",
        "vs_baseline": (max_gap or 0.0) / WATCHDOG_S,
        "detail": {
            "what": "bounded-lifetime radar workers restarted every "
                    f"{args.cpis_per_cycle} CPIs under a supervisor; the "
                    "standalone API (3-process topology) holds products and "
                    "stashes across restarts; gap criterion = the deployed "
                    "watchdog's 60 s staleness bound (deploy/watchdog.bash)",
            "cycles": cycles,
            "n_cycles": len(cycles),
            "cpis_per_cycle": args.cpis_per_cycle,
            "n_cpis_processed": cpis_done,
            "n_product_updates_observed": len(events),
            "realtime_budget_ms": budget_ms,
            "product_gap_s_max": max_gap,
            "inter_restart_gaps_s": restart_gaps,
            "first_product_s": first_product[0] if first_product else None,
            "first_product_s_per_cycle": first_product,
            "kernel_build_s": build["seconds"] if build else None,
            "kernel_build_cold": build["cold"] if build else None,
            "rss_cap_mb": args.rss_cap_mb,
            "rss_mb_max_observed": rss_max,
            "rss_sawtooth_first_per_cycle":
                [c["rss_mb_first"] for c in cycles],
            "rss_sawtooth_last_per_cycle":
                [c["rss_mb_last"] for c in cycles],
            "wall_total_s": wall_total,
            "failures": fails,
            **device_detail(dev),
        },
    }
    emit(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    raise SystemExit(1 if main()["detail"]["failures"] else 0)
