#!/usr/bin/env python3
"""Which stage of the port's complex64 CPI sets the error of the map's
deep cells.

    python3 tools/torch_stage_precision.py                 # card, then CPU
    python3 tools/torch_stage_precision.py --small --devices cpu
    python3 tools/torch_stage_precision.py --nfft-seg 16200,16384
    python3 tools/torch_stage_precision.py --mesh 1x4 --nfft-seg 18000,18432

Runs one CPI (the two-target scene of ``chip_smoke.py``, at the default
config, or at the verify recipe's 20,000-sample scene with ``--small``)
through the clutter filter and the ambiguity stage of ``blah2_tpu_torch`` in
complex128. Then it runs the CPI again with one stage at a time in
complex64 (its inputs rounded to complex64, its output widened back) and the
rest in complex128, and last with every stage in complex64. For each
variant and device it prints one JSON line: the largest error of
10·log10|z| against the same device's all-complex128 map over three sets of
cells (those no more than 10 dB under the map's mean, the deeper ones, and
the zero-Doppler cells at the clutter lags). The stages are the pipeline's
own methods: the all-complex64 variant must give ``CpiPipeline.cross_map``'s
map bit for bit, and the script fails if it does not. ``--nfft-seg`` runs
the whole table once for each segment FFT size given (the clutter filter's
own pick when omitted); the map's value does not depend on that size, its
rounding does. On a card, each size also gets a ``timing`` line: the
complex64 clutter filter's device time per call (``torch.profiler``, the
sum of its kernels over 10 calls) and its time per call by CUDA events.

``--mesh CxP`` runs the sharded pipeline (``parallel/sharded.py``) instead,
with C × P logical ranks on the device: per segment FFT size, the complex64
map against the complex128 one over the same three sets of cells, and the
clutter stage's device and event times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The stages of the clutter filter's segmented path, then the map.
STAGES = ("lags", "factor", "solve", "fir", "ambiguity")

SMALL = {
    "capture": {"fs": 200_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.1},
        "ambiguity": {"delayMin": -10, "delayMax": 100, "dopplerMin": -200,
                      "dopplerMax": 200},
        "clutter": {"enable": True, "delayMin": -10, "delayMax": 100},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2, "nTrain": 6,
                      "minDelay": 5, "minDoppler": 15, "nCentroid": 6},
    },
}


def staged_map(p64, p128, x, y, low):
    """The cross-ambiguity map with the stages named in ``low`` run in
    complex64 and the others in complex128, widened to complex128.

    ``factor`` is the Cholesky factorisation alone (its triangular solves in
    complex128); ``solve`` is the whole normal-equation solve."""
    import torch

    from blah2_tpu_torch.ops.toeplitz import hermitian_toeplitz

    def pipe(stage):
        return p64 if stage in low else p128

    def cast(stage, *ts):
        dt = torch.complex64 if stage in low else torch.complex128
        return [t.to(dt) for t in ts]

    xs128 = p128.clutter._shifted(x)
    wh = pipe("lags").clutter
    xs, yy = cast("lags", xs128, y)
    a, b = wh._segmented_lags(xs, yy, wh._segment_spectra(xs))
    if "solve" in low or "factor" not in low:
        a, b = cast("solve", a, b)
        w, ok = pipe("solve").clutter._solve(a, b)
    else:
        # The factor in complex64, its triangular solves in complex128.
        mat = hermitian_toeplitz(a.to(torch.complex128))
        chol, info = torch.linalg.cholesky_ex(mat.to(torch.complex64))
        w = torch.cholesky_solve(b.to(torch.complex128)[:, None],
                                 chol.to(torch.complex128))[:, 0]
        ok = info == 0
    if not bool(ok):
        raise RuntimeError(f"clutter solve failed with {sorted(low)} low")
    wh = pipe("fir").clutter
    xs, yy, w = cast("fir", xs128, y, w)
    yf = yy - wh._segmented_fir(wh._segment_spectra(xs), w)
    xa, yf = cast("ambiguity", x, yf)
    return pipe("ambiguity").ambiguity(xa, yf).to(torch.complex128)


def cell_sets(db, pipe, cfg):
    """Masks of the map's cells: within 10 dB of the mean, deeper, and the
    zero-Doppler cells at the clutter lags."""
    import numpy as np

    amb = pipe.ambiguity
    null = np.zeros(db.shape, dtype=bool)
    delay = amb.delay_axis.cpu().numpy()
    null[amb.doppler_axis.cpu().numpy() == 0.0, :] = \
        (delay >= cfg.process.clutter.delay_min) \
        & (delay < cfg.process.clutter.delay_max)
    bulk = (db >= db.mean() - 10.0) & ~null
    return {"bulk": bulk, "deep": ~bulk & ~null, "clutter_lags": null}


def stage_times(fn, device, n=10):
    """Device ms per call of ``fn`` (the profiler's kernel time summed over
    ``n`` calls) and ms per call by CUDA events over the same count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not str(device).startswith("cuda"):
        return {}
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return {"device_ms": busy_us / n / 1e3,
            "event_ms": start.elapsed_time(end) / n}


def run_sharded(device, cfg, quads, card, shape, nfft_seg=None):
    """The sharded complex64 map against the complex128 one on a
    ``shape`` mesh of logical ranks on ``device``, and the clutter stage's
    times."""
    import numpy as np
    import torch

    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    mesh = make_radar_mesh(*shape, devices=[device] * (shape[0] * shape[1]))
    xb = np.repeat((quads[:, 0] + 1j * quads[:, 1])[None], shape[0], axis=0)
    yb = np.repeat((quads[:, 2] + 1j * quads[:, 3])[None], shape[0], axis=0)
    maps, times = {}, {}
    for dt in (torch.complex128, torch.complex64):
        sp = ShardedCpiPipeline(cfg, mesh, dtype=dt)
        if nfft_seg:
            if nfft_seg < sp.seg_len + sp.nb - 1:
                raise ValueError(f"segment FFT size {nfft_seg} is too short")
            sp.nfft_seg = nfft_seg
        xp, yp = sp.shard_inputs(xb, yb)
        maps[dt] = sp(xp, yp).db_map[0].double().cpu().numpy()
        if dt == torch.complex64:
            from blah2_tpu_torch.device import complex_of_parts

            xs = [complex_of_parts(p[..., 0], p[..., 1], dt) for p in xp]
            ys = [complex_of_parts(p[..., 0], p[..., 1], dt) for p in yp]
            times = stage_times(lambda: sp._clutter_block(xs, ys), device)
            size = sp.nfft_seg
    ref = maps[torch.complex128]
    err = np.abs(maps[torch.complex64] - ref)
    sets = cell_sets(ref, sp, cfg)
    line = {"device": device, "mesh": f"{shape[0]}x{shape[1]}",
            "complex64": "all", "nfft_seg": size,
            "cells": {k: int(m.sum()) for k, m in sets.items()}}
    line.update({f"{k}_max_err_db": float(err[m].max())
                 for k, m in sets.items()})
    line.update({f"clutter_{k}": v for k, v in times.items()})
    if card:
        line["card"] = card
    print(json.dumps(line), flush=True)


def run(device, cfg, quads, card, nfft_seg=None):
    import numpy as np
    import torch

    from blah2_tpu_torch.device import complex_of_parts
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    p64 = CpiPipeline(cfg, fused_detect=False, device=device)
    p128 = CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                       device=device)
    if not p128.clutter.n_seg:
        raise RuntimeError("the clutter filter is not on its segmented path")
    wh = p128.clutter
    if nfft_seg:
        if nfft_seg < wh.n_samples // wh.n_seg + wh.n_bins - 1:
            raise ValueError(f"segment FFT size {nfft_seg} is too short")
        p64.clutter.nfft_seg = p128.clutter.nfft_seg = nfft_seg
    q = torch.from_numpy(quads).to(device)
    x = complex_of_parts(q[:, 0], q[:, 1], torch.complex128)
    y = complex_of_parts(q[:, 2], q[:, 3], torch.complex128)

    def db_of(z):
        return 10.0 * np.log10(np.abs(z.cpu().numpy()))

    ref = db_of(staged_map(p64, p128, x, y, set()))
    sets = cell_sets(ref, p128, cfg)
    low_all = set(STAGES) - {"factor"}
    z_all = staged_map(p64, p128, x, y, low_all)
    z_pipe, _ = p64.cross_map(x.to(torch.complex64), y.to(torch.complex64))
    if not torch.equal(z_all, z_pipe.to(torch.complex128)):
        raise RuntimeError("the staged complex64 map is not cross_map's")
    for name in STAGES + ("all",):
        low = low_all if name == "all" else {name}
        err = np.abs(db_of(staged_map(p64, p128, x, y, low)) - ref)
        line = {"device": device, "complex64": name,
                "nfft_seg": p128.clutter.nfft_seg,
                "cells": {k: int(m.sum()) for k, m in sets.items()}}
        line.update({f"{k}_max_err_db": float(err[m].max())
                     for k, m in sets.items()})
        if card:
            line["card"] = card
        print(json.dumps(line), flush=True)
    x64, y64 = x.to(torch.complex64), y.to(torch.complex64)
    times = stage_times(lambda: p64.clutter(x64, y64), device)
    if times:
        print(json.dumps({"device": device, "timing": "clutter filter",
                          "complex64": "all",
                          "nfft_seg": p64.clutter.nfft_seg, **times,
                          "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="cuda,cpu",
                    help="comma-separated devices to run on, in order")
    ap.add_argument("--small", action="store_true",
                    help="the 20,000-sample verify scene, not the default "
                         "config")
    ap.add_argument("--nfft-seg", default="",
                    help="comma-separated segment FFT sizes to run at")
    ap.add_argument("--mesh", default="",
                    help="CxP: the sharded pipeline on C x P logical ranks")
    args = ap.parse_args()
    import torch

    from blah2_tpu_torch.config import config_from_dict, load_config
    from chip_smoke import default_scene

    cfg = config_from_dict(SMALL) if args.small else \
        load_config(os.path.join(ROOT, "config", "config.yml"))
    quads, _ = default_scene(cfg)
    for device in args.devices.split(","):
        card = None
        if device.startswith("cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device")
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0]
        for size in args.nfft_seg.split(",") if args.nfft_seg else [None]:
            size = int(size) if size else None
            if args.mesh:
                shape = tuple(int(v) for v in args.mesh.split("x"))
                run_sharded(device, cfg, quads, card, shape, size)
            else:
                run(device, cfg, quads, card, size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
