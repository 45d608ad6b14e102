#!/usr/bin/env python3
"""Which stage of the port's complex64 CPI sets the error of the map's
deep cells.

    python3 tools/torch_stage_precision.py                 # card, then CPU
    python3 tools/torch_stage_precision.py --small --devices cpu
    python3 tools/torch_stage_precision.py --nfft-seg 16200,16384

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
rounding does.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="cuda,cpu",
                    help="comma-separated devices to run on, in order")
    ap.add_argument("--small", action="store_true",
                    help="the 20,000-sample verify scene, not the default "
                         "config")
    ap.add_argument("--nfft-seg", default="",
                    help="comma-separated segment FFT sizes to run at")
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
            run(device, cfg, quads, card, int(size) if size else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
