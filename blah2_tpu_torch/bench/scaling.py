"""Scaling harness: sharded-pipeline samples/s across mesh sizes
(counterpart of ``bench_scaling.py``).

It runs the port's sharded CPI pipeline (clutter + ambiguity + detection,
``parallel/sharded.py``, at the JAX defaults: the ``ppermute`` halo
exchange and the unfused detector) over growing meshes and prints one JSON
line per mesh size with throughput and efficiency relative to the smallest
swept size (the line's ``efficiency_baseline_devices`` says which).

Axes:
  --mode dp     scale the ``cpi`` axis (CPI-batch data parallelism)
  --mode sp     scale the ``pulse`` axis (overlap-save halo exchange and
                the reduction of the Doppler stage)
  --mode both   a balanced (cpi × pulse) factorisation per size

Without ``--virtual`` the ranks are this process's cards, one each (the CPU
is one device). ``--virtual N`` makes N logical ranks on the one device
(``parallel/mesh.py``), as one card holds a 1 × 4 mesh: that checks the
sharding and the collectives at any size, but the ranks share one device,
so its efficiency says what the split costs, not how cards scale.

    python -m blah2_tpu_torch.bench.scaling --virtual 4          # one card
    python -m blah2_tpu_torch.bench.scaling --device cpu --fs 200000 \
        --virtual 4

Each line also gives the step's detections per CPI and noise powers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from blah2_tpu_torch.bench.common import (add_device_args, at, default_config,
                                          device_detail, device_or_exit, emit,
                                          scaling_batch, synchronize)
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline


def _balanced(n: int):
    """(cpi, pulse) factorisation closest to square with cpi ≥ pulse."""
    best = (n, 1)
    k = 1
    while k * k <= n:
        if n % k == 0:
            best = (n // k, k)
        k += 1
    return best


def _detections(out, b: int) -> list:
    """Per CPI of the step, its detections' (row, col) cells."""
    det = out.detections
    valid = det.valid.cpu()
    row, col = det.row.cpu(), det.col.cpu()
    return [[[int(r), int(c)] for r, c in zip(row[i][valid[i]],
                                              col[i][valid[i]])]
            for i in range(b)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(ap, fs=2_000_000, cpi=0.1)
    ap.add_argument("--virtual", type=int, default=0,
                    help="N logical ranks on the one device")
    ap.add_argument("--mode", choices=("dp", "sp", "both"), default="both")
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="rank counts to sweep (default: 1, 2, 4, .. up "
                         "to the ranks available)")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cpis-per-step", type=int, default=None,
                    help="CPI batch per step (default: the cpi-axis size)")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    if args.virtual:
        ranks = [dev] * args.virtual
    elif dev.type == "cuda" and dev.index is None:
        ranks = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        ranks = [dev]
    sizes = args.sizes
    if not sizes:
        sizes, s = [], 1
        while s <= len(ranks):
            sizes.append(s)
            s *= 2

    cfg = default_config(args.fs, args.cpi)
    n = cfg.n_samples
    rng = np.random.default_rng(0)
    detail = device_detail(dev)
    platform = "gpu" if dev.type == "cuda" else "cpu"

    lines = []
    base_sps = base_devices = None
    for nd in sizes:
        if args.mode == "dp":
            shape = (nd, 1)
        elif args.mode == "sp":
            shape = (1, nd)
        else:
            shape = _balanced(nd)
        mesh = make_radar_mesh(*shape, devices=ranks[:nd])
        pipe = ShardedCpiPipeline(cfg, mesh)
        b = args.cpis_per_step or max(1, shape[0])
        b = -(-b // shape[0]) * shape[0]
        xs, ys = pipe.shard_inputs(*scaling_batch(rng, b, n))

        def step():
            out = pipe(xs, ys)
            for d in mesh.distinct_devices():
                synchronize(d)
            return out

        out = step()  # plans, kernel builds, warm caches
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            out = step()
            times.append(time.perf_counter() - t0)
        dt = at(sorted(times), 0.5)
        sps = b * n / dt
        if base_sps is None:
            # per-rank baseline at the SMALLEST SWEPT size
            base_devices = nd
            base_sps = sps / nd
        lines.append(emit({
            "metric": "sharded_cpi_throughput",
            "devices": nd,
            "mesh": {"cpi": shape[0], "pulse": shape[1]},
            "cpis_per_step": b,
            "value": sps / 1e6,
            "unit": "Msamples/s",
            "scaling_efficiency": sps / (base_sps * nd),
            "efficiency_baseline_devices": base_devices,
            "step_ms_median": 1e3 * dt,
            "platform": platform,
            "virtual": bool(args.virtual),
            **detail,
            "detections": _detections(out, b),
            "noise_power_db": out.noise_power.cpu().tolist(),
        }))
    return lines


if __name__ == "__main__":
    main()
