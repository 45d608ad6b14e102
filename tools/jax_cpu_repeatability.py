#!/usr/bin/env python3
"""Does the JAX package give the same CPI map on every call on XLA's CPU
backend?

    JAX_PLATFORMS=cpu python3 tools/jax_cpu_repeatability.py [--calls 30]
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_cpu_multi_thread_eigen=false \\
        python3 tools/jax_cpu_repeatability.py

Calls the complex64 ``CpiPipeline`` of ``tests/test_pallas_detect.py::
test_fused_in_pipeline_matches_xla_pipeline`` (fs 40 kHz, CPI 0.5 s, the
same seeded scene) ``--calls`` times in one process, with ``use_pallas``
off and on (the Pallas kernel in interpret mode), and prints one JSON line
per setting: how many calls gave a dB map other than the first call's, and
the largest difference. That test compares one call of each setting at
2e-4 dB, so it fails whenever its two calls land on different results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=30)
    args = ap.parse_args()

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from blah2_tpu.config import config_from_dict
    from blah2_tpu.dsp.pipeline import CpiPipeline

    cfg = config_from_dict({
        "capture": {"fs": 40_000, "fc": 100_000_000},
        "process": {
            "data": {"cpi": 0.5, "buffer": 2},
            "ambiguity": {"delayMin": -5, "delayMax": 40,
                          "dopplerMin": -50, "dopplerMax": 50},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 40},
            "detection": {"enable": True, "pfa": 1e-3, "nGuard": 2,
                          "nTrain": 6, "minDelay": 3, "minDoppler": 10,
                          "nCentroid": 6},
        },
    })
    rng = np.random.default_rng(7)
    n = cfg.n_samples
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    y = (0.2 * np.roll(x, 9) + 3.0 * x
         + 0.01 * (rng.standard_normal(n)
                   + 1j * rng.standard_normal(n))).astype(np.complex64)
    for use_pallas in (False, True):
        pipe = CpiPipeline(cfg, use_pallas=use_pallas)
        first = np.asarray(pipe(x, y).db_map)
        diffs = [float(np.abs(np.asarray(pipe(x, y).db_map) - first).max())
                 for _ in range(args.calls - 1)]
        print(json.dumps({
            "use_pallas": use_pallas, "calls": args.calls,
            "calls_unlike_first": sum(d > 0.0 for d in diffs),
            "max_diff_db": max(diffs, default=0.0),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
