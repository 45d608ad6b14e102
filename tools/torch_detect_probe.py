#!/usr/bin/env python3
"""Device time of the detect kernel (``blah2_tpu_torch/csrc/detect.cu``)
by tile shape and by phase, on one NVIDIA card.

    python3 tools/torch_detect_probe.py [--tiles 24x48,16x72,32x36,12x96]
                                        [--block-tiles 24,32,40]

Builds the kernel source with other tile constants (``-DDETECT_TILE_ROWS``,
``-DDETECT_TILE_COLS``), and cut after each of its phases
(``-DDETECT_CUT=n`` returns after phase n), with ``nvcc`` runs started
together, into ``blah2_tpu_torch/build/probe/``. Runs each on a complex64
301 x 411 map with the default config's detector (few hits) and with a
loose one (many hits), and prints one JSON line: the profiler's device
time per call in us for every variant and map, with the card's name and
power limit. Each variant is checked against ``detect_plain`` first (the
cut copies excepted). The row-block mode's tile rows
(``-DDETECT_BLOCK_TILE_ROWS``) are timed the same way on the row-sharded
path's blocks: the map in 4 blocks of 76 rows (a 1 x 4 mesh) and in 4
blocks of 151 rows (a 2 x 2 mesh, two cpi rows), each with its halo rows,
checked against ``detect_rows_plain``. It needs a card and exits 2
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: The phase cuts, by the phase after which each build returns.
CUTS = {"loads": 1, "cfar": 2, "row_max": 3, "cells": 4}


def variants(tiles, tile0):
    """{name: (nvcc defines, (tile rows, tile cols))}."""
    out = {f"{tr}x{tc}": ((f"-DDETECT_TILE_ROWS={tr}",
                           f"-DDETECT_TILE_COLS={tc}"), (tr, tc))
           for tr, tc in tiles}
    for name, phase in CUTS.items():
        out[f"{tile0[0]}x{tile0[1]}-to-{name}"] = (
            (f"-DDETECT_CUT={phase}",), tile0)
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", default="24x48,16x72,32x36,12x96")
    ap.add_argument("--block-tiles", default="24,32,40")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_detect_probe: needs a CUDA card", file=sys.stderr)
        return 2

    import chip_smoke
    from blah2_tpu_torch.config import Config
    from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor
    from blah2_tpu_torch.ops import _build
    from blah2_tpu_torch.ops import detect as tdetect

    tiles = [tuple(int(v) for v in t.split("x"))
             for t in args.tiles.split(",")]
    todo = variants(tiles, (tdetect.TILE_ROWS, tdetect.TILE_COLS))
    block_rows = [int(v) for v in args.block_tiles.split(",") if v]
    for tr in block_rows:
        todo[f"rows{tr}"] = ((f"-DDETECT_BLOCK_TILE_ROWS={tr}",),
                             (tdetect.TILE_ROWS, tdetect.TILE_COLS))
    cu = os.path.join(_build.CSRC_DIR, "detect.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)

    def build(name):
        lib = os.path.join(out_dir, f"libdetect-{name}.so")
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                               *todo[name][0], "-o", lib, cu],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {proc.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(todo)) as pool:
        libs = dict(pool.map(build, todo))

    dev = torch.device("cuda", 0)
    cfg = Config()
    amb = AmbiguityProcessor(-10, 400, -200, 200, cfg.capture.fs,
                             cfg.n_samples, device=dev)
    default = tdetect.FusedDetector.from_config(cfg.process, amb, device=dev)
    loose = tdetect.FusedDetector(1e-2, 1, 3, 0, 0.0, 6, 6, 1 / 0.75,
                                  amb.delay_axis, amb.doppler_axis,
                                  device=dev)
    rng = np.random.default_rng(0)
    nr, nc = amb.n_doppler_bins, amb.n_delay_bins
    z = torch.from_numpy((rng.standard_normal((nr, nc))
                          + 1j * rng.standard_normal((nr, nc)))
                         .astype(np.complex64)).to(dev)
    result = {}
    for name, path in libs.items():
        if name.startswith("rows"):
            result.update(block_variant(name, ctypes.CDLL(path), z, default,
                                        args.reps))
            continue
        lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.detect_launch.argtypes = [vp, ci] + [vp] * 7 + [ci] * 9 + [vp]
        lib.detect_scratch_words.argtypes = [ci, ci, ci]
        lib.detect_scratch_words.restype = ctypes.c_longlong
        tr, tc = todo[name][1]
        for label, fd in (("default", default), ("loose", loose)):
            g, t, wr, wc = fd.n_guard, fd.n_train, fd.win_rows, fd.win_cols
            smem = tdetect.tile_geometry(nr, nc, g, t, wr, wc, tr,
                                         tc).smem_bytes
            scratch = torch.zeros(lib.detect_scratch_words(1, nr, nc),
                                  dtype=torch.int32, device=dev)
            maps = torch.empty(2, nr, nc, device=dev)
            stats = torch.empty(2, device=dev)

            def run():
                err = lib.detect_launch(
                    z.data_ptr(), 1, fd._scale.data_ptr(),
                    fd._cell_ok.data_ptr(), maps[0].data_ptr(),
                    maps[1].data_ptr(), scratch.data_ptr(),
                    stats[0].data_ptr(), stats[1].data_ptr(), 1, nr, nc, g,
                    t, wr, wc, smem, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            if "-to-" not in name:
                want = tdetect.detect_plain(z, fd._scale, fd._cell_ok, g, t,
                                            wr, wc)
                if not torch.equal(maps[1], want.keep) or abs(
                        float(stats[0] - want.noise)) > 1e-4:
                    raise RuntimeError(f"{name} {label}: differs from plain")
            prof = chip_smoke.device_profile(run, args.reps)
            result[f"{name} {label}"] = sum(
                t for t, _ in prof.values()) / args.reps
    print(json.dumps({"device_us_per_call": result,
                      "card": chip_smoke.card_line()}))
    return 0


def block_variant(name, lib, z, fd, reps) -> dict:
    """Device us per call of a build of the row-block mode, on the map in
    4 blocks of 76 rows and in 4 blocks of 151 (two maps of 2 blocks)."""
    import torch

    import chip_smoke
    from blah2_tpu_torch.ops import detect as tdetect

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.detect_launch_blocks.argtypes = (
        [ci, ctypes.POINTER(vp), ctypes.POINTER(ci), ci] + [vp] * 7
        + [ci] * 9 + [vp])
    lib.detect_block_tile_rows.restype = ci
    lib.detect_block_scratch_words.argtypes = [ci, ci, ci]
    lib.detect_block_scratch_words.restype = ctypes.c_longlong
    tr = lib.detect_block_tile_rows()
    nr, nc = z.shape
    g, t, wr, wc = fd.n_guard, fd.n_train, fd.win_rows, fd.win_cols
    out = {}
    for label, n_split, copies in (("4x76", 4, 1), ("4x151", 2, 2)):
        blocks, first = [], []
        for _ in range(copies):
            b, f = chip_smoke.row_blocks(z, n_split, wr, fill=0.0)
            blocks += b
            first += f
        kept = blocks[0][1].shape[0]
        n = len(blocks)
        smem = tdetect.tile_geometry(kept, nc, g, t, wr, wc,
                                     tr).smem_bytes
        scratch = torch.zeros(lib.detect_block_scratch_words(n, kept, nc),
                              dtype=torch.int32, device=z.device)
        maps = torch.empty(2, n, kept, nc, device=z.device)
        stats = torch.empty(2, n, device=z.device)
        ptrs = (vp * (3 * n))(*[b[k].data_ptr() for k in range(3)
                                for b in blocks])
        rows0 = (ci * n)(*first)

        def run():
            err = lib.detect_launch_blocks(
                n, ptrs, rows0, 1, fd._scale.data_ptr(),
                fd._cell_ok.data_ptr(), maps[0].data_ptr(),
                maps[1].data_ptr(), scratch.data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr(), kept, nr, nc, g, t, wr, wc, smem,
                z.device.index, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        want = tdetect.detect_rows_plain(
            torch.stack([torch.cat(b) for b in blocks]), first, nr,
            fd._scale, fd._cell_ok, g, t, wr, wc)
        if not torch.equal(maps[1], want.keep):
            raise RuntimeError(f"{name} {label}: differs from plain")
        prof = chip_smoke.device_profile(run, reps)
        out[f"{name} {label} ({n} blocks, "
            f"{n * -(-kept // tr) * -(-nc // 48)} CUDA blocks)"] = sum(
                t for t, _ in prof.values()) / reps
    return out


if __name__ == "__main__":
    sys.exit(main())
