#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blah2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It builds the CUDA kernels from ``blah2_tpu_torch/csrc`` (the fused
detector and the halo exchange, both ``nvcc`` runs started together),
holds each against its plain PyTorch version (the halo kernel's flag
protocol too: a one-card plan made to take its semaphores, replayed from a
CUDA graph), runs the golden recording and
the default config (1.5 Msample CPIs, a 301 x 411 map) through the
single-device pipeline's entry points (each captured as a CUDA graph at
its first call and replayed after), the graphs against the eager calls bit
for bit at the default config and for ECA-B, NLMS, OS-CFAR and nSub 4, one
CPI with sub-CPI spectra, the radar runtime on a replay of the default
config (chunked pinned ingest, deferred fetch, staged samples; the graph
loop against the eager loop), then the default config through the
sharded pipeline on 1 x 4 and 2 x 2 meshes of logical ranks on the one
card (its step captured as a CUDA graph at its first call and replayed
after; every algorithm of the sharded path eager against the graph bit for
bit, both kernels inside the replays against their plain versions), times
the paths with CUDA events and the profiler; then the
alternative algorithms (ECA-B, NLMS, OS-CFAR) on the single-device path,
ECA-B, NLMS and nSub 4 on the sharded path, the runtime in mesh mode and
over two processes, then each measuring entry point of
``blah2_tpu_torch/bench`` at cut counts, then the system as it is deployed:
the 3-process topology (this process's radar sending over TCP into a
standalone API process), the supervised restart soak, the dry run
(``blah2_tpu_torch.entry.dryrun_multichip(4)``), where the machine has two
or more cards the step as one CUDA graph over them (in a process that sees
them all), and the scaling projection with its times measured, and prints
as its last line
``{"ok": true, "device": {...}}``. Every failed check raises, so the
script exits non-zero and prints no result. It imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM memory rate and float32 (non-tensor-core) peak, NVIDIA data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=3):
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_times(fn, n, warmup):
    """Per-call ms of ``fn()`` by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


# Profiled windows a check may take before the profiler's trace must hold
# every launch the wrappers made (see profiled_whole).
PROFILE_TRIES = 3
# Every profiled window opens and closes with markers: a burst of launches
# of torch.cuda._sleep's spin kernel and of device-to-device copies of
# MARKER_BYTES bytes, which nothing else launches, waited for. The counts
# leave them out. In whole runs of this script the trace lost records at a
# window's edges now and then: at the opening edge the first device record,
# in some windows the next ones too, whatever their kind (once all six
# opening markers, over 3 ms); at the closing edge the host's records of
# the last launches (PERF.md, Findings). The markers take those places:
# each spins about 2 ms, so that a burst spans more than the longest
# opening loss seen.
MARKER_CYCLES = 4_000_000
MARKER_LAUNCHES = 3
MARKER_BYTES = 4099
_MARKER_BUF: list = []
#: Each profiled window's edges (split_markers), in order; the last is the
#: window profiled_whole reports on a shortfall.
PROFILE_LOG: list = []


def shortfall(seen, want, what):
    """[message] where the profiler's trace saw ``seen`` of the ``want``
    launches (or copies) the wrappers made, else []."""
    return [] if seen == want else [
        f"the profiler saw {seen} {what}, the wrappers made {want}"]


def profiled_whole(window, what):
    """``window()`` profiles one window and returns (result, shortfalls),
    the shortfalls as messages. A window whose trace lacks a record is
    profiled again, up to PROFILE_TRIES windows in all, and the check
    fails after that, each short window's edges printed."""
    for attempt in range(1, PROFILE_TRIES + 1):
        result, short = window()
        if not short:
            return result
        edges = PROFILE_LOG[-1] if PROFILE_LOG else {}
        print(f"note: {what}, profiled window {attempt} of {PROFILE_TRIES}: "
              f"{'; '.join(short)}; edges {json.dumps(edges)}")
    check(False, f"{what}: {'; '.join(short)}, in each of {PROFILE_TRIES} "
          f"profiled windows")


def _is_marker(record):
    return "spin_kernel" in record["name"] or (
        "DtoD" in record["name"]
        and record["args"].get("bytes") == MARKER_BYTES)


def split_markers(trace):
    """Take the markers' device records out of a window's trace (see
    profile_window) and return where its records sit against its
    launches: the markers seen before the window's own first record and
    after its last, of the 2 x MARKER_LAUNCHES launched at each edge; the
    launch calls made under a graph's stream capture, which launch
    nothing; and each other launch call (CUDA runtime or driver) with no
    device record, by its place among them (the opening markers' first)
    and its host time after the first, in us."""
    kinds = ("kernel", "gpu_memcpy", "gpu_memset")
    marks = [r for k in kinds for r in trace[k] if _is_marker(r)]
    for k in kinds:
        trace[k] = [r for r in trace[k] if not _is_marker(r)]
    own = [r for k in kinds for r in trace[k]]
    first = min((r["ts"] for r in own), default=float("inf"))
    runtime = trace["cuda_runtime"] + trace["cuda_driver"]
    spans = list(zip(
        sorted(c["ts"] for c in runtime if "BeginCapture" in c["name"]),
        sorted(c["ts"] for c in runtime if "EndCapture" in c["name"])))
    calls = sorted((c for c in runtime if any(
        k in c["name"] for k in ("Launch", "Memcpy", "Memset"))),
        key=lambda c: c["ts"])
    captured = [c for c in calls if any(a < c["ts"] < b for a, b in spans)]
    calls = [c for c in calls if c not in captured]
    seen = {r["args"].get("correlation") for r in own + marks}
    t0 = calls[0]["ts"] if calls else 0.0
    opening = sum(r["ts"] < first for r in marks)
    return {
        "opening_markers": [opening, 2 * MARKER_LAUNCHES],
        "closing_markers": [len(marks) - opening, 2 * MARKER_LAUNCHES],
        "calls": len(calls), "captured_calls": len(captured),
        "lost": [{"at": i, "of": len(calls), "call": c["name"],
                  "after_us": round(c["ts"] - t0, 1)}
                 for i, c in enumerate(calls)
                 if c["args"].get("correlation") not in seen],
    }


def markers():
    """One burst of markers, waited for: MARKER_LAUNCHES spin kernels and
    copies of MARKER_BYTES in turn."""
    import torch

    if not _MARKER_BUF:
        _MARKER_BUF.append(torch.zeros((2, MARKER_BYTES), dtype=torch.uint8,
                                       device="cuda"))
    buf = _MARKER_BUF[0]
    for _ in range(MARKER_LAUNCHES):
        torch.cuda._sleep(MARKER_CYCLES)
        buf[1].copy_(buf[0])
    torch.cuda.synchronize()


def profile_window(fn, cpu=True):
    """Profile one call of ``fn`` (torch.profiler; CUDA activity, and the
    host's operators where ``cpu``), the window opened and closed by
    markers. Returns ``(fn(), trace)``, the trace's device events without
    the markers; the window's edges (split_markers) go to PROFILE_LOG."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    markers()  # the buffer made, the kernel and the copy loaded
    with profile(activities=acts) as prof:
        markers()
        result = fn()
        torch.cuda.synchronize()
        markers()
    trace = trace_events(prof)
    PROFILE_LOG.append(split_markers(trace))
    return result, trace


def device_profile(fn, n):
    """Device time by kernel over ``n`` calls of ``fn`` in one profiled
    window: {kernel name: (total us, launches)}, read from the profiler's
    trace of device activity (markers left out)."""
    def calls():
        for _ in range(n):
            fn()

    _, trace = profile_window(calls)
    by_name: dict = {}
    for ev in trace["kernel"] + trace["gpu_memcpy"] + trace["gpu_memset"]:
        tot, cnt = by_name.get(ev["name"], (0.0, 0))
        by_name[ev["name"]] = (tot + ev["dur"], cnt + 1)
    return by_name


def top(by_name, n, k):
    """The ``k`` costliest kernels per call: [name, us, launches]."""
    return [[name[:80], round(t / n, 2), c // n] for name, (t, c) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:k]]


def power_map(z):
    """|z|^2 in torch ops, as the fused detector formed it before its
    kernel took the complex64 map."""
    return z.real * z.real + z.imag * z.imag


def row_blocks(m, n_blocks, win_rows, fill=7.0):
    """Map ``m`` (nr, nc) cut into ``n_blocks`` row blocks of R = ceil(nr /
    n_blocks) rows as the row-sharded path hands them to the detect
    kernel: per block its (above, kept, below) row parts, views of one
    padded copy (zeros past the map's edges, ``fill`` in the phantom rows
    past its end, which the kernel must treat as outside the map), and
    each block's first map row."""
    import torch

    nr, nc = m.shape
    r_len = -(-nr // n_blocks)
    wr = win_rows
    padded = torch.cat([m.new_zeros((wr, nc)), m,
                        m.new_full((n_blocks * r_len - nr, nc), fill),
                        m.new_zeros((wr, nc))])
    blocks = [(padded[d * r_len:d * r_len + wr],
               padded[wr + d * r_len:wr + (d + 1) * r_len],
               padded[wr + (d + 1) * r_len:2 * wr + (d + 1) * r_len])
              for d in range(n_blocks)]
    return blocks, [d * r_len for d in range(n_blocks)]


def row_block_check(fd, m, n_blocks, what):
    """The detect kernel's row-block mode on ``m`` cut in ``n_blocks``
    against detect_rows_plain and against the kernel's map mode on the
    whole map: one launch; keep equal to both, db the map mode's bits on
    the map's rows and -inf on the phantom rows; the block sums within
    1e-6 of the plain twin's, the maxima equal. Returns the largest
    difference in dB (the sums' as a per-cell mean)."""
    import torch

    from blah2_tpu_torch.ops.detect import detect, detect_rows_plain

    nr, nc = m.shape
    blocks, first = row_blocks(m, n_blocks, fd.win_rows)
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
          fd.win_cols)
    launches, rows = detect.launches, detect.row_launches
    got = detect.rows(blocks, first, nr, *kw)
    torch.cuda.synchronize()
    check(detect.launches == launches + 1 and detect.row_launches == rows + 1,
          f"{what}: {detect.launches - launches} launches")
    want = detect_rows_plain(torch.stack([torch.cat(b) for b in blocks]),
                             first, nr, *kw)
    whole = detect(m.contiguous(), *kw)
    torch.cuda.synchronize()
    db = got.db.reshape(-1, nc)
    check(torch.equal(got.keep, want.keep), f"{what}: keep differs from "
          f"the plain twin")
    check(torch.equal(got.keep.reshape(-1, nc)[:nr], whole.keep)
          and torch.equal(db[:nr], whole.db), f"{what}: differs from the "
          f"map mode")
    check(bool(torch.isneginf(db[nr:]).all())
          and not bool(got.keep.reshape(-1, nc)[nr:].any()),
          f"{what}: phantom rows inside the map")
    check(torch.equal(got.maxes, want.maxes), f"{what}: block maxima")
    rel = float(((got.sums.double() - want.sums.double()).abs()
                 / want.sums.double().abs().clamp(min=1.0)).max())
    check(rel <= 1e-6, f"{what}: block sums differ by {rel} (relative)")
    per_cell = float((got.sums.double() - want.sums.double()).abs().max()
                     ) / (got.db.shape[1] * nc)
    d_db = float((db[:nr] - want.db.reshape(-1, nc)[:nr]).abs().max())
    return max(d_db, per_cell), int(got.keep.sum())


def detect_against_plain(m, fd, what):
    """The detect kernel against detect_plain on map ``m`` (complex64 or
    float32 power; a map or a stack) with ``fd``'s constants: one launch,
    the same kept cells, dB map, noise and raw max within 1e-4 dB. Returns
    (the largest difference, the kernel's result)."""
    import torch

    from blah2_tpu_torch.ops.detect import detect, detect_plain

    args = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
            fd.win_cols)
    launches = detect.launches
    got = detect(m, *args)
    want = detect_plain(m, *args)
    torch.cuda.synchronize()
    check(detect.launches == launches + 1,
          f"{what}: {detect.launches - launches} launches")
    check(torch.equal(got.keep, want.keep), f"{what}: keep differs")
    e = max(float((got.db - want.db).abs().max()),
            float((got.noise - want.noise).abs().max()),
            float((got.rawmax - want.rawmax).abs().max()))
    check(e <= 1e-4, f"{what}: db/noise/rawmax differ by {e} dB")
    return e, got


def phase_kernel_vs_plain(dev):
    """The kernel against detect_plain on the card, on the complex64 map
    and on its float32 power: random 301 x 411 maps with targets, the tie
    case, more hits than capacity, a ragged 37 x 53 map, centroid windows
    wider than a tile, and a stack of two; one launch a call. Then its
    row-block mode against detect_rows_plain and its map mode on those
    maps cut in row blocks. Returns the two modes' largest differences."""
    import numpy as np
    import torch

    from blah2_tpu_torch.config import Config
    from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor
    from blah2_tpu_torch.ops.detect import FusedDetector, detect

    cfg = Config()
    amb = AmbiguityProcessor(-10, 400, -200, 200, cfg.capture.fs,
                             cfg.n_samples, device=dev)
    nr, nc = amb.n_doppler_bins, amb.n_delay_bins
    check((nr, nc) == (301, 411), f"default geometry {(nr, nc)}")
    default = FusedDetector.from_config(cfg.process, amb, device=dev)
    loose = FusedDetector(1e-2, 1, 3, 0, 0.0, 6, 6, 1 / 0.75,
                          amb.delay_axis, amb.doppler_axis, device=dev)
    rng = np.random.default_rng(1)

    def noise_map():
        return (rng.standard_normal((nr, nc))
                + 1j * rng.standard_normal((nr, nc))).astype(np.complex64)

    targets = noise_map()
    for r, c, a in [(150, 200, 80.0), (40, 30, 60.0), (250, 400, 40.0),
                    (151, 201, 30.0)]:
        targets[r, c] += a
    tie = np.full((nr, nc), 0.05 + 0j, dtype=np.complex64)
    tie[200, 200] = tie[200, 205] = 50.0
    ragged = (rng.standard_normal((37, 53))
              + 1j * rng.standard_normal((37, 53))).astype(np.complex64)
    ragged[0, 52] += 30.0
    ragged[36, 3] += 30.0
    wide_z = noise_map()[:64, :200].copy()
    wide_z[30, 100] += 40.0
    wide_z[33, 150] += 45.0
    small = FusedDetector(1e-2, 1, 3, 0, 0.0, 6, 6, 2.0,
                          np.arange(-10, 43), 2.0 * np.arange(-18, 19),
                          device=dev)
    # Centroid windows of 41 x 147 cells: wider than a 24 x 48 tile.
    wide = FusedDetector(1e-2, 1, 3, 0, 0.0, 74, 21, 2.0,
                         np.arange(-10, 190), 2.0 * np.arange(-32, 32),
                         device=dev)
    check((wide.win_rows, wide.win_cols) == (20, 73), "wide windows")
    cases = [("targets", targets, default), ("tie", tie, loose),
             ("overflow", noise_map(), loose), ("ragged", ragged, small),
             ("wide", wide_z, wide)]
    err = 0.0
    for name, z, fd in cases:
        zc = torch.from_numpy(z).to(dev)
        for kind, m in (("complex64", zc), ("float32",
                                            power_map(zc).contiguous())):
            e, got = detect_against_plain(m, fd, f"{name} {kind}")
            err = max(err, e)
        n_keep = int(got.keep.sum())
        _, _, _, det = fd(zc)
        count = int(det.count)
        check(count == n_keep, f"{name}: count {count} != kept {n_keep}")
        print(f"kernel_vs_plain {name}: kept={n_keep} max_abs_err_db={e:.3g}")
        if name == "tie":
            cols = sorted(det.col[det.valid].tolist())
            check(cols == [200, 205], f"tie: kept columns {cols}")
        if name == "overflow":
            check(count > fd.max_detections,
                  f"overflow: {count} hits within capacity")
            check(bool(det.valid.all()), "overflow: capacity not filled")

    # A (2, nr, nc) stack in one call: the tie map and an overflowing map.
    zs = torch.from_numpy(np.stack([tie, noise_map()])).to(dev)
    args = (loose._scale, loose._cell_ok, loose.n_guard, loose.n_train,
            loose.win_rows, loose.win_cols)
    for kind, m in (("complex64", zs),
                    ("float32", power_map(zs).contiguous())):
        e, got = detect_against_plain(m, loose, f"stack {kind}")
        err = max(err, e)
        for i in range(2):
            one = detect(m[i].contiguous(), *args)
            check(torch.equal(one.keep, got.keep[i])
                  and torch.equal(one.noise, got.noise[i]),
                  f"stack {kind}: map {i} differs from its own call")
    _, _, _, det = loose(zs)
    cols = sorted(det.col[0][det.valid[0]].tolist())
    check(cols == [200, 205], f"stack: tie kept columns {cols}")
    check(int(det.count[1]) > loose.max_detections
          and bool(det.valid[1].all()), "stack: overflow map not capped")
    print(f"kernel_vs_plain stack of 2: kept={int(got.keep.sum())} "
          f"max_abs_err_db={e:.3g}")

    # The row-block mode: the maps cut in row blocks, first, middle and
    # last, halo rows past the map's edges and phantom rows past its end
    # (the default map in 4 blocks of 76 rows, as a 1 x 4 mesh holds it;
    # the wide case's 20 halo rows reach past a whole 16-row block).
    rows_err = 0.0
    for name, z, fd in cases:
        zc = torch.from_numpy(z).to(dev)
        n_blocks = 3 if name == "ragged" else 4
        for kind, m in (("complex64", zc), ("float32",
                                            power_map(zc).contiguous())):
            e, kept = row_block_check(fd, m, n_blocks,
                                      f"row blocks {name} {kind}")
            rows_err = max(rows_err, e)
        print(f"kernel_vs_plain row blocks {name}: {n_blocks} blocks, "
              f"kept={kept} max_abs_err_db={e:.3g}")
    return err, rows_err


def phase_golden(dev, root):
    """The golden recording at complex64 through call_quad on the card,
    against the frozen oracle (bounds of tests/test_golden_parity.py)."""
    import numpy as np

    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    gdir = os.path.join(root, "tests", "golden")
    with open(os.path.join(gdir, "golden.json")) as f:
        g = json.load(f)
    cmap = np.load(os.path.join(gdir, "oracle_map.npy"))
    raw = np.fromfile(os.path.join(gdir, "golden_scene.rspduo.iq"),
                      dtype=np.int16)
    amb, clu, det = g["ambiguity"], g["clutter"], g["detection"]
    cfg = config_from_dict({
        "capture": {"fs": g["scene"]["fs"], "fc": 204_640_000},
        "process": {
            "data": {"cpi": g["scene"]["cpi_s"], "buffer": 2},
            "ambiguity": {"delayMin": amb["delay_min"],
                          "delayMax": amb["delay_max"],
                          "dopplerMin": amb["doppler_min"],
                          "dopplerMax": amb["doppler_max"]},
            "clutter": {"enable": True, "delayMin": clu["delay_min"],
                        "delayMax": clu["delay_max"]},
            "detection": {"enable": True, "pfa": det["pfa"],
                          "nGuard": det["n_guard"], "nTrain": det["n_train"],
                          "minDelay": det["min_delay"],
                          "minDoppler": det["min_doppler"],
                          "nCentroid": det["n_centroid"]},
        },
    })
    n = cfg.n_samples
    quads = raw[: n * 4].reshape(n, 4)
    pipe = CpiPipeline(cfg, device=dev)
    check(pipe.fused_detector is not None, "cuda pipeline is not fused")
    out = pipe.call_quad(quads)
    ref_db = 10 * np.log10(np.abs(cmap))
    dmax = float(np.abs(out.db_map.cpu().numpy() - ref_db).max())
    dn = abs(float(out.noise_power) - g["noise_power_db"])
    dx = abs(float(out.max_power) - g["max_power_db"])
    print(f"golden complex64: map_err_db={dmax:.4g} noise_err_db={dn:.3g} "
          f"max_err_db={dx:.3g} clutter_ok={bool(out.clutter_ok)}")
    check(bool(out.clutter_ok), "golden: clutter solve failed")
    check(dmax < 0.05, f"golden map off by {dmax} dB")
    check(dn < 1e-3 and dx < 1e-3, f"golden noise/max off by {dn}/{dx} dB")
    v = out.detections.valid.cpu().numpy()
    got = sorted(zip(out.detections.delay.cpu().numpy()[v],
                     out.detections.doppler.cpu().numpy()[v]))
    want = sorted((d, f) for d, f, _ in g["interpolated"])
    check(len(got) == len(want), f"golden detections {got} != {want}")
    for (d, f), (wd, wf) in zip(got, want):
        check(abs(d - wd) < 1e-2 and abs(f - wf) < 1e-1,
              f"golden detection {(d, f)} != {(wd, wf)}")


# Limits (card-vs-CPU, card-vs-complex128) in dB on the default config's
# complex64 map for the cells the 0.05 dB bound leaves out, about twice the
# readings on an H100 with the card's 16,384-point clutter segments (0.094
# and 0.038 dB on the deeper cells, 0.181 and 0.253 dB on the clutter lags;
# PERF.md, Findings).
DEEP_LIMITS_DB = {"deeper cells": (0.19, 0.08),
                  "zero-Doppler clutter lags": (0.36, 0.5)}


_SCENES: dict = {}


def default_scene(cfg, seed=11):
    """Two injected targets in a 1.5 Msample CPI, as 12-bit int16 quads
    (made once per geometry and seed; read-only)."""
    key = (cfg.n_samples, cfg.capture.fs, seed)
    if key not in _SCENES:
        _SCENES[key] = _make_scene(cfg, seed)
    return _SCENES[key]


def _make_scene(cfg, seed):
    import numpy as np

    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi

    # Receiver noise of about 4.5 ADC steps (0.03 x 150) under a direct
    # path 40 dB above it, as a 12-bit front end is set up in practice, and
    # targets 30 and 34 dB under the noise per sample (about 32 and 28 dB
    # over it after the CPI's 62 dB of integration).
    targets = [TargetSpec(60, -77.0, 1e-3), TargetSpec(250, 112.0, 6e-4)]
    x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs, targets,
                         clutter_amplitude=3.0, noise_amplitude=0.03,
                         seed=seed)
    quads = np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                      axis=1) * 150.0), -2048, 2047)
    return quads.astype(np.int16), targets


def found(out, targets, res):
    v = out.detections.valid.cpu().numpy()
    dets = list(zip(out.detections.delay.cpu().numpy()[v],
                    out.detections.doppler.cpu().numpy()[v]))
    return [any(abs(d - t.delay_bins) <= 1.0
                and abs(f - t.doppler_hz) <= 2 * res for d, f in dets)
            for t in targets], dets


def cell_masks(amb, cfg, db, noise):
    """The cells of a default-config map that the 0.05 dB bound covers
    (no more than 10 dB under the mean, not a clutter lag), and the
    zero-Doppler cells at the clutter lags (see phase_default)."""
    import numpy as np

    null = np.zeros(db.shape, dtype=bool)
    delay = amb.delay_axis.cpu().numpy()
    null[amb.doppler_axis.cpu().numpy() == 0.0, :] = \
        (delay >= cfg.process.clutter.delay_min) \
        & (delay < cfg.process.clutter.delay_max)
    return (db >= noise - 10.0) & ~null, null


def phase_default(dev, root):
    """The default config on the card through call_quad12 and __call__."""
    import numpy as np
    import torch

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops import detect as detect_mod
    from blah2_tpu_torch.ops.pack12 import pack12_quads

    cfg = load_config(os.path.join(root, "config", "config.yml"))
    check(cfg.n_samples == 1_500_000, f"n_samples {cfg.n_samples}")
    quads, targets = default_scene(cfg)
    packed = torch.from_numpy(pack12_quads(quads)).to(dev)
    pipe = CpiPipeline(cfg, device=dev)
    res = pipe.ambiguity.doppler_resolution
    check(pipe.fused_detector is not None, "cuda pipeline is not fused")
    check(tuple(pipe.ambiguity._doppler_dft.shape) == (301, 301), "geometry")

    # The main path: counts at 0 just before, read just after.
    detect_mod.detect.launches = 0
    out12 = pipe.call_quad12(packed)
    torch.cuda.synchronize()
    launches = detect_mod.detect.launches
    check(launches >= 1, "the main path did not launch the detect kernel")

    out = pipe(quads[:, :2], quads[:, 2:])
    ok12, dets12 = found(out12, targets, res)
    ok, dets = found(out, targets, res)
    print(f"default call_quad12: detections={dets12} "
          f"noise_db={float(out12.noise_power):.4f} "
          f"max_db={float(out12.max_power):.4f} "
          f"clutter_ok={bool(out12.clutter_ok)} launches={launches}")
    check(bool(out12.clutter_ok), "default: clutter solve failed")
    check(all(ok12), f"call_quad12 missed a target: {dets12}")
    check(all(ok), f"__call__ missed a target: {dets}")
    for k in ("row", "col", "valid", "count"):
        check(torch.equal(getattr(out.detections, k),
                          getattr(out12.detections, k)),
              f"call_quad12 and __call__ disagree on {k}")
    d_entries = float((out.db_map - out12.db_map).abs().max())
    check(d_entries <= 1e-4, f"entries' maps differ by {d_entries} dB")

    t0 = time.perf_counter()
    cpu = CpiPipeline(cfg, fused_detect=True, device="cpu").call_quad12(
        pack12_quads(quads))
    t_cpu = time.perf_counter() - t0
    # Both complex64 maps against a complex128 run of the same CPI.
    f64 = CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                      device="cpu").call_quad(quads).db_map.numpy()
    card_db, cpu_db = out12.db_map.cpu().numpy(), cpu.db_map.numpy()
    # Two complex64 maps of a 1.5 Msample CPI agree to 0.05 dB only where a
    # cell is not far below the map's mean: a cell's rounding error is a
    # share of the whole map's norm (and of the solved clutter weights),
    # not of the cell. So the 0.05 dB bound holds for every cell no more
    # than 10 dB under the mean (noise_power). The zero-Doppler cells at the
    # clutter lags are the deepest: the Wiener filter makes the residual
    # orthogonal to the reference there, so they hold only what is left of
    # a cancellation. The deeper cells and the clutter lags have limits of
    # their own (DEEP_LIMITS_DB), against the CPU and against complex128.
    noise = float(out12.noise_power)
    bulk, null = cell_masks(pipe.ambiguity, cfg, card_db, noise)
    diff = np.abs(cpu_db - card_db)
    d_bulk = float(diff[bulk].max())
    ok_cpu, dets_cpu = found(cpu, targets, res)
    print(f"default card vs cpu: bulk map_err_db={d_bulk:.4g} over "
          f"{int(bulk.sum())} of {bulk.size} cells; noise_err_db="
          f"{abs(float(cpu.noise_power) - noise):.3g}; cpu_s={t_cpu:.2f}")
    for name, m in (("other cells >= noise-10 dB", bulk),
                    ("deeper cells", ~bulk & ~null),
                    ("zero-Doppler clutter lags", null)):
        r, c = np.unravel_index(np.argmax(np.where(m, diff, -1.0)),
                                diff.shape)
        d_cpu = float(diff[m].max())
        d_f64 = float(np.abs(card_db - f64)[m].max())
        print(f"  {name} ({int(m.sum())}): card-cpu {d_cpu:.4g} dB at "
              f"({r}, {c}) card {card_db[r, c]:.3f} cpu {cpu_db[r, c]:.3f} "
              f"f64 {f64[r, c]:.3f}; card-f64 {d_f64:.4g} dB, cpu-f64 "
              f"{float(np.abs(cpu_db - f64)[m].max()):.4g} dB")
        if name in DEEP_LIMITS_DB:
            lim_cpu, lim_f64 = DEEP_LIMITS_DB[name]
            check(m.any() and d_cpu <= lim_cpu and d_f64 <= lim_f64,
                  f"{name}: card-cpu {d_cpu} dB (limit {lim_cpu}), card-f64 "
                  f"{d_f64} dB (limit {lim_f64})")
    check(d_bulk < 0.05, f"card and CPU maps differ by {d_bulk} dB")
    check(abs(float(cpu.noise_power) - noise) < 1e-3,
          "card and CPU noise differ")
    # At complex128 the rounding that parts the deep cells above is gone:
    # the card's stages compute the CPU's function on every cell, the
    # clutter lags included. The unfused chain keeps the dB map in float64
    # (the fused detector's map is float32 on every device, as in JAX).
    c128 = CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                       graph=False, device=dev).call_quad(quads)
    d128 = float(np.abs(c128.db_map.cpu().numpy() - f64).max())
    print(f"default complex128 card vs cpu: map_err_db={d128:.3g} over all "
          f"{f64.size} cells")
    check(d128 <= 1e-6, f"complex128 card and CPU maps differ by {d128} dB")
    for k in ("row", "col", "valid"):
        check(torch.equal(getattr(cpu.detections, k).to(dev),
                          getattr(out12.detections, k)),
              f"card and CPU detections differ on {k}")
    check(all(ok_cpu), f"the CPU run missed a target: {dets_cpu}")
    return pipe, packed, launches, out12


def phase_timing(pipe, packed, card):
    """Median ms per CPI (packed-12 bytes on the device to detections), and
    the detect kernel on the main path's complex64 map against the old form
    (|z|^2 in torch, then the kernel on float32 power) and detect_plain,
    with CUDA events in the order A B B A, and from the profiler the device
    time and launches of a call of each form."""
    import torch

    from blah2_tpu_torch.ops.detect import detect, detect_plain

    torch.cuda.reset_peak_memory_stats()
    cpis = 20
    times = event_times(lambda: pipe.call_quad12(packed), cpis, 3)
    out = pipe.call_quad12(packed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20

    # The detect kernel at the main path's shapes, on this run's map.
    z, _ = pipe.cross_map(*pipe.decode_quad12(packed))
    z = z.contiguous()
    check(z.dtype == torch.complex64, f"main path map is {z.dtype}")
    fd = pipe.fused_detector
    args = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
            fd.win_cols)

    def new():
        detect(z, *args)

    def old():
        detect(power_map(z).contiguous(), *args)

    plain_a = cuda_ms(lambda: detect_plain(z, *args), 100)
    kern_a = cuda_ms(new, 200)
    old_a = cuda_ms(old, 200)
    old_b = cuda_ms(old, 200)
    kern_b = cuda_ms(new, 200)
    plain_b = cuda_ms(lambda: detect_plain(z, *args), 100)
    n = 20
    prof_new, prof_old = device_profile(new, n), device_profile(old, n)
    power_us = sum(t for k, (t, _) in prof_old.items() if "detect_" not in k)
    nr, nc = z.shape
    # Each input read once, each output written once: the map (8 B a cell
    # as complex64, 4 B as float32 power), cell_ok, db and keep; scale,
    # noise and rawmax.
    extra = 4 * nc + 8
    bytes_c64 = (8 + 4 + 4 + 4) * nr * nc + extra
    bytes_f32 = (4 + 4 + 4 + 4) * nr * nc + extra
    # Per cell: |z|^2 (3), log10, the x5, 2*n_train adds, the scale
    # product, two compares, the separable window max and its compare, two
    # reductions.
    ops = nr * nc * (3 + 1 + 1 + 2 * fd.n_train + 1 + 2
                     + 2 * (fd.win_rows + fd.win_cols) + 1 + 2)
    bound_b = bytes_c64 / HBM_BYTES_PER_S * 1e3
    bound_o = ops / F32_OPS_PER_S * 1e3
    timing = {
        "cpi_ms_median": times["median"],
        "cpi_ms_min": times["min"], "cpi_ms_max": times["max"],
        "cpis": cpis, "peak_mib": peak,
        "detect_ms": [kern_a, kern_b], "detect_plain_ms": [plain_a, plain_b],
        "detect_old_form_ms": [old_a, old_b],
        "detect_device_ms": sum(t for t, _ in prof_new.values()) / n / 1e3,
        "detect_launches_per_call": sum(c for _, c in prof_new.values()) / n,
        "old_form_device_ms": sum(t for t, _ in prof_old.values()) / n / 1e3,
        "old_form_launches_per_call":
            sum(c for _, c in prof_old.values()) / n,
        "power_kernels_device_ms": power_us / n / 1e3,
        "old_form_top": top(prof_old, n, 6),
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "bound_f32_input_ms": bytes_f32 / HBM_BYTES_PER_S * 1e3,
        "card": card,
        "count": int(out.detections.count),
    }
    print("timing " + json.dumps(timing))
    return timing


def phase_profile(pipe, packed, cpi_ms):
    """Device time of a few CPIs by kernel (torch.profiler): the busy time
    per CPI, the idle share against the timed median, and the detect
    kernels' own device time per call."""
    import torch

    from blah2_tpu_torch.ops.detect import detect

    n = 5
    for _ in range(3):
        pipe.call_quad12(packed)
    torch.cuda.synchronize()

    def window():
        calls = detect.launches
        by_name = device_profile(lambda: pipe.call_quad12(packed), n)
        calls = detect.launches - calls
        check(calls == n, f"{calls} detect calls in {n} CPIs")
        # Kernel launches a detect call makes: the kernels named detect_*
        # the profiler saw, one a call.
        seen = sum(c for k, (_, c) in by_name.items() if "detect_" in k)
        return (by_name, seen / calls), shortfall(
            seen, calls, "detect launches (one a call)")

    by_name, per_call = profiled_whole(window, "profile")
    busy_ms = sum(t for t, _ in by_name.values()) / n / 1e3
    detect_us = sum(t for k, (t, _) in by_name.items() if "detect_" in k) / n
    prof_out = {
        "device_busy_ms_per_cpi": busy_ms,
        "idle_share": (1.0 - busy_ms / cpi_ms) if busy_ms else None,
        "kernels_per_cpi": sum(c for _, c in by_name.values()) / n,
        "detect_device_ms": detect_us / 1e3 if detect_us else None,
        "detect_launches_per_call": per_call,
        "top": top(by_name, n, 15),
    }
    print("profile " + json.dumps(prof_out))
    return prof_out


HALO_MESHES = ((1, 2), (1, 4), (1, 8), (2, 2), (2, 4))
HALO_PAYLOADS = ((409, 2), (10, 2), (1, 2))
#: (batch, count) of the masked form's slices: the 1 x 4 step's halos, and
#: the dry run's on its 2 x 2 mesh (24 and 5 lags, complex64).
HALO_MASKED = ((1, 409), (2, 409), (2, 10), (1, 24), (1, 5))


def one_card_mesh(dev, shape):
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    return make_radar_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))


def bits(t):
    """A tensor's values as real words, for a bit-exact comparison."""
    import torch

    return torch.view_as_real(t) if t.is_complex() else t


def phase_halo_vs_plain(dev):
    """The halo kernel against halo_permute_plain on meshes of logical
    ranks on the one card, both directions, for equality: the circular
    form on the main path's payloads, and the masked form on slices as they
    lie (heads and tails of (B, n) blocks; float32, complex64, complex128;
    the ring's edge zero-filled), one launch a call; then 1,000
    back-to-back calls with a new payload each, every call checked on the
    device, and the kernel's error word."""
    import torch

    from blah2_tpu_torch.ops.halo import halo_permute, halo_permute_plain

    cases = 0
    err = torch.zeros((), device=dev)
    for shape in HALO_MESHES:
        mesh = one_card_mesh(dev, shape)
        for to_left in (True, False):
            for cid, payload in enumerate(HALO_PAYLOADS):
                bufs = [torch.randn(payload, device=dev)
                        for _ in range(mesh.size)]
                got = halo_permute(bufs, mesh, to_left=to_left,
                                   collective_id=cid)
                want = halo_permute_plain(bufs, mesh, to_left=to_left)
                torch.cuda.synchronize()
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"halo {shape} to_left={to_left} {payload} differs")
                for g, w in zip(got, want):
                    err = torch.maximum(err, (g - w).abs().max())
                cases += 1
            for dtype in (torch.float32, torch.complex64, torch.complex128):
                for batch, count in HALO_MASKED:
                    blocks = [torch.randn((batch, 1000), dtype=dtype,
                                          device=dev)
                              for _ in range(mesh.size)]
                    parts = [b[..., :count] if to_left else b[..., -count:]
                             for b in blocks]
                    launches = halo_permute.launches
                    got = halo_permute(parts, mesh, to_left=to_left,
                                       collective_id=3, mask_edge=True)
                    want = halo_permute_plain(parts, mesh, to_left=to_left,
                                              mask_edge=True)
                    torch.cuda.synchronize()
                    what = (f"masked halo {shape} to_left={to_left} {dtype} "
                            f"({batch}, {count})")
                    check(halo_permute.launches == launches + 1,
                          f"{what}: {halo_permute.launches - launches} "
                          f"launches")
                    check(all(g.dtype == dtype and torch.equal(bits(g),
                                                               bits(w))
                              for g, w in zip(got, want)), f"{what} differs")
                    edge = shape[1] - 1 if to_left else 0
                    check(all(not bool(bits(g).any())
                              for r, g in enumerate(got)
                              if mesh.axis_index(r, "pulse") == edge),
                          f"{what}: edge not zero")
                    for g, w in zip(got, want):
                        err = torch.maximum(err, (bits(g) - bits(w)).abs()
                                            .max().float())
                    cases += 1
    mesh = one_card_mesh(dev, (1, 4))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    n_calls = 1000
    for i in range(n_calls):
        to_left = i % 2 == 0
        bufs = [torch.randn(HALO_PAYLOADS[0], device=dev) for _ in range(4)]
        got = halo_permute(bufs, mesh, to_left=to_left, collective_id=i % 4)
        want = halo_permute_plain(bufs, mesh, to_left=to_left)
        for g, w in zip(got, want):
            bad += (g != w).sum()
            err = torch.maximum(err, (g - w).abs().max())
    word = halo_permute.error()
    n_bad, err = int(bad), float(err)
    print(f"halo_vs_plain: {cases} cases equal; {n_calls} back-to-back "
          f"calls, {n_bad} differing values, max_abs_err {err}; error word "
          f"{word}")
    check(n_bad == 0 and err == 0.0,
          f"{n_bad} values differ over the repeated calls")
    check(word == 0, f"halo kernel error word {word}")
    return err


#: Replays of the flagged plan's graph, each on new payloads and checked;
#: then replays profiled in one window, and timed by events.
HALO_FLAGS_REPLAYS = 100
HALO_FLAGS_PROFILED = 10
HALO_FLAGS_TIMED = 50


def phase_halo_flags(dev, card):
    """The halo kernel's flag protocol, counting semaphores that each
    launch signals and consumes, replayed from a CUDA graph on the one
    card: a 1 x 4 mesh's plan made to take the flags
    (``HaloKernel(flags_on_one_card=True)``: one launch whose four blocks
    wait on one another), the step's two masked shifts of (1, 409)
    complex64 slices of (1, 1000) blocks (to the left and to the right),
    captured by ``dsp/graph.py``'s StaticCall and replayed
    HALO_FLAGS_REPLAYS times on new payloads: each replay the bits of
    halo_permute_plain, the launches counted once a replay (the capture's
    taken back), the error word 0 and every semaphore back at 0 after.
    Then HALO_FLAGS_PROFILED replays profiled (the kernel's records
    exactly the counted launches, its device time a launch) and
    HALO_FLAGS_TIMED timed by events, eager calls beside them."""
    import collections

    import torch

    from blah2_tpu_torch.dsp import graph as graph_mod
    from blah2_tpu_torch.dsp.graph import StaticCall
    from blah2_tpu_torch.ops.halo import HaloKernel, halo_permute_plain

    t0 = time.perf_counter()
    kernel = HaloKernel(flags_on_one_card=True)
    mesh = one_card_mesh(dev, (1, 4))
    n = mesh.size
    Halos = collections.namedtuple("Halos", [f"h{i}" for i in range(2 * n)])
    gen = torch.Generator(device=dev).manual_seed(13)

    def payloads():
        return [torch.randn((1, 1000), dtype=torch.complex64, device=dev,
                            generator=gen) for _ in range(n)]

    def body(*blocks):
        left = kernel([b[..., :409] for b in blocks], mesh, to_left=True,
                      collective_id=0, mask_edge=True)
        right = kernel([b[..., -409:] for b in blocks], mesh,
                       to_left=False, collective_id=1, mask_edge=True)
        return Halos(*left, *right)

    def plain(blocks):
        return (halo_permute_plain([b[..., :409] for b in blocks], mesh,
                                   to_left=True, mask_edge=True)
                + halo_permute_plain([b[..., -409:] for b in blocks], mesh,
                                     to_left=False, mask_edge=True))

    graph_mod.COUNTERS.append(kernel)
    try:
        first = payloads()
        call = StaticCall(body, first, dev, name="halo flags")
        warm = call.capture(*first)
        check(call.counts == {"halo_flags": 2, "halo_flags_kernel": 6},
              f"halo flags: the graph holds {call.counts}")
        check(all(torch.equal(bits(g), bits(w))
                  for g, w in zip(warm, plain(first))),
              "halo flags: the warm-up differs from halo_permute_plain")
        # The main path: the count at 0 just before, read just after.
        kernel.launches = 0
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(HALO_FLAGS_REPLAYS):
            blocks = payloads()
            got = call(*blocks)
            for g, w in zip(got, plain(blocks)):
                bad += (bits(g) != bits(w)).sum()
        launches = kernel.launches
        torch.cuda.synchronize()
        kernel.check()
        word = kernel.error()
        flags = [int(w.abs().sum()) for w in kernel.flag_words(mesh)]
        check(int(bad) == 0, f"halo flags: {int(bad)} values differ over "
              f"{HALO_FLAGS_REPLAYS} replays")
        check(word == 0, f"halo flags: error word {word}")
        check(flags == [0, 0], f"halo flags: semaphores {flags} after the "
              f"replays")
        check(launches == 2 * HALO_FLAGS_REPLAYS,
              f"halo flags: {launches} launches counted in "
              f"{HALO_FLAGS_REPLAYS} replays")
        blocks = payloads()

        def window():
            before = kernel.launches
            by_name = device_profile(lambda: call(*blocks),
                                     HALO_FLAGS_PROFILED)
            seen = sum(c for k, (_, c) in by_name.items()
                       if "halo_permute" in k)
            return by_name, shortfall(seen, kernel.launches - before,
                                      "halo launches")

        by_name = profiled_whole(window, "halo flags replayed")
        us, cnt = [sum(v[i] for k, v in by_name.items()
                       if "halo_permute" in k) for i in (0, 1)]
        replay_ms = event_times(lambda: call(*blocks), HALO_FLAGS_TIMED, 3)
        eager_ms = event_times(lambda: body(*blocks), HALO_FLAGS_TIMED, 3)
        torch.cuda.synchronize()
        check(kernel.error() == 0, "halo flags: error word after timing")
    finally:
        graph_mod.COUNTERS.remove(kernel)
    line = {"mesh": "1x4 on one card", "replays": HALO_FLAGS_REPLAYS,
            "launches_in_replays": launches, "differing_values": 0,
            "error_word": word, "semaphores_after": flags,
            "profiled_launches": cnt,
            "device_us_per_launch": us / max(cnt, 1),
            "ms_per_replay": replay_ms, "ms_per_eager_pair": eager_ms,
            "graph_nodes": graph_nodes(call.graph), **call.stats,
            "wall_s": time.perf_counter() - t0, "card": card}
    print("halo_flags " + json.dumps(line))
    return line


def cpi_of(out, i):
    """CPI ``i`` of a batched output, shaped as ``found`` reads it."""
    class One:
        detections = out.detections._replace(
            **{k: getattr(out.detections, k)[i]
               for k in out.detections._fields})
    return One


def det_set(det, i):
    v = det.valid[i]
    return set(zip(det.row[i][v].tolist(), det.col[i][v].tolist()))


def gathered_form_check(sp, planes, what):
    """One eager step of the row-sharded ``sp`` (``_step``, the body its
    graph replays) against the gathered form: the
    rows of its map gathered and put through the unchanged single-device
    detectors on the card (make_cfar + CentroidFilter + PeakInterpolator,
    or FusedDetector's map mode): the dB map, the masks and the
    detections' rows, columns, valid and count bit for bit; noise,
    max_power, snr, delay and doppler within 1e-4 (dB, bins, Hz: the dB
    sum is added in another order, and interpolation runs on db − noise).
    Returns the largest of those differences and the valid detections."""
    import torch

    from blah2_tpu_torch.dsp.centroid import CentroidFilter
    from blah2_tpu_torch.dsp.cfar import CfarDetections, make_cfar
    from blah2_tpu_torch.dsp.interpolate import PeakInterpolator
    from blah2_tpu_torch.ops.detect import FusedDetector, detect
    from blah2_tpu_torch.parallel import collectives, sharded

    check(sp._row_shard, f"{what}: not row-sharded")
    seen = {}
    detect_rows = sp._detect_rows

    def rows(zs):
        seen["zs"] = zs
        return detect_rows(zs)

    def gather(fields, mesh, axis="pulse", dim=1):
        seen["gathered"] = collectives.all_gather(fields, mesh, axis, dim)
        return seen["gathered"]

    sp._detect_rows, sharded.all_gather = rows, gather
    try:
        out = sp._step(*planes)
    finally:
        del sp._detect_rows
        sharded.all_gather = collectives.all_gather
    proc, amb, home = sp.config.process, sp.ambiguity, sp.device
    nd = amb.n_doppler_bins
    groups = sp.mesh.groups("pulse")
    z = torch.cat([torch.cat([seen["zs"][r] for r in g], dim=1)[:, :nd]
                   for g in groups])
    got_mask = torch.cat([seen["gathered"][g[0]][1][:, :nd]
                          for g in groups])
    k = sp.cfar.max_detections
    interp = PeakInterpolator(True, True, amb.doppler_resolution, nd,
                              amb.n_delay_bins)
    if sp.fused_detector is not None:
        fd = FusedDetector.from_config(proc, amb, max_detections=k,
                                       device=home)
        whole = detect(fd.kernel_input(z).contiguous(), fd._scale,
                       fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
                       fd.win_cols)
        db, noise = whole.db, whole.noise
        max_power = whole.rawmax - noise
        mask = whole.keep > 0.0
        det = fd.detections(mask, db, noise)
        dets = [interp(CfarDetections(*[f[i] for f in det]),
                       db[i] - noise[i]) for i in range(z.shape[0])]
    else:
        cfar = make_cfar(proc.detection, amb.delay_axis, amb.doppler_axis,
                         max_detections=k, device=home)
        centroid = CentroidFilter(proc.detection.n_centroid,
                                  proc.detection.n_centroid,
                                  1.0 / proc.data.cpi)
        db = 10.0 * torch.log10(torch.abs(z))
        noise = torch.mean(db, dim=(-2, -1))
        max_power = torch.clamp(torch.amax(db, dim=(-2, -1)),
                                min=0.0) - noise
        mags = torch.abs(z).to(cfar.real_dtype)
        mask = torch.stack([cfar.hits(m * m) for m in mags])
        dets = [interp(centroid(cfar(z[i], noise[i])), db[i] - noise[i])
                for i in range(z.shape[0])]
    want = CfarDetections(*[torch.stack(f) for f in zip(*dets)])
    torch.cuda.synchronize()
    check(torch.equal(out.db_map, db), f"{what}: dB map differs from the "
          f"gathered form")
    check(torch.equal(got_mask, mask), f"{what}: mask differs from the "
          f"gathered form")
    for f in ("row", "col", "valid", "count"):
        check(torch.equal(getattr(out.detections, f), getattr(want, f)),
              f"{what}: detections' {f} differ from the gathered form")
    diff = max(float((a.double() - b.double()).abs().max())
               for a, b in ((out.noise_power, noise),
                            (out.max_power, max_power),
                            (out.detections.snr, want.snr),
                            (out.detections.delay, want.delay),
                            (out.detections.doppler, want.doppler)))
    check(diff <= 1e-4, f"{what}: noise, max_power, snr, delay or doppler "
          f"differ from the gathered form by {diff}")
    return diff, int(want.valid.sum())


def phase_sharded(dev, root):
    """The default config through the sharded pipeline on 1 x 4 and 2 x 2
    meshes of logical ranks on the card, row-sharded: the halo kernel
    against the ppermute backend, complex128 against the single-device
    linear pipeline, both targets at complex64, the halo and detect
    launches of one step (the detect kernel's row-block mode, once on the
    card), the fused detector against the unfused chain, and both against
    the gathered form."""
    import numpy as np
    import torch

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.collectives import count_bytes, summarize
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    cfg = load_config(os.path.join(root, "config", "config.yml"))
    scenes = [default_scene(cfg, seed) for seed in (11, 12)]
    targets = scenes[0][1]
    xb = np.stack([(q[:, 0] + 1j * q[:, 1]) for q, _ in scenes])
    yb = np.stack([(q[:, 2] + 1j * q[:, 3]) for q, _ in scenes])
    single = CpiPipeline(cfg, dtype=torch.complex128, clutter_mode="linear",
                         fused_detect=False, graph=False, device=dev)
    refs = [single(xb[i], yb[i]) for i in range(2)]
    launches = {}
    for shape in ((1, 4), (2, 2)):
        mesh = one_card_mesh(dev, shape)
        b = max(1, shape[0])
        outs = {}
        for backend in ("ppermute", "pallas"):
            sp = ShardedCpiPipeline(cfg, mesh, halo_backend=backend,
                                    use_fused_detect=True)
            planes = sp.shard_inputs(xb[:b], yb[:b])
            torch.cuda.synchronize()
            # The sharded main path: counts at 0 just before, read after.
            halo_permute.launches = detect.launches = 0
            detect.row_launches = 0
            with count_bytes(mesh) as ops:
                outs[backend] = sp(*planes)
            torch.cuda.synchronize()
            launches[shape, backend] = (halo_permute.launches,
                                        detect.launches, detect.row_launches)
        comm = summarize(ops)
        n_dev = len(mesh.distinct_devices())
        check(sp._row_shard, f"{shape}: not row-sharded")
        # The 4 clutter shifts and the 2 row halos; one row-block launch.
        check(launches[shape, "pallas"] == (6 * n_dev, n_dev, n_dev),
              f"{shape}: halo/detect/row-block launches of one step "
              f"{launches[shape, 'pallas']}, want ({6 * n_dev}, {n_dev}, "
              f"{n_dev})")
        check(launches[shape, "ppermute"] == (0, n_dev, n_dev),
              f"{shape}: the ppermute backend's launches "
              f"{launches[shape, 'ppermute']}")
        a, p = outs["ppermute"], outs["pallas"]
        check(torch.equal(a.db_map, p.db_map), f"{shape}: backends' maps")
        for k in a.detections._fields:
            check(torch.equal(getattr(a.detections, k),
                              getattr(p.detections, k)),
                  f"{shape}: backends' detections differ on {k}")
        res = sp.ambiguity.doppler_resolution
        for i in range(b):
            ok, dets = found(cpi_of(p, i), targets, res)
            check(all(ok), f"{shape}: complex64 sharded missed a target in "
                  f"CPI {i}: {dets}")
        check(bool(p.clutter_ok.all()), f"{shape}: clutter solve failed")

        # The unfused chain on the same batch; both against the gathered
        # form.
        sp_u = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                                  graph=False)
        u = sp_u(*sp_u.shard_inputs(xb[:b], yb[:b]))
        gathered = {}
        for name, pipe in (("fused", sp), ("unfused", sp_u)):
            gathered[name] = gathered_form_check(
                pipe, pipe.shard_inputs(xb[:b], yb[:b]),
                f"{shape} {name}")[0]
        d_map = float((u.db_map - p.db_map).abs().max())
        d_noise = float((u.noise_power - p.noise_power).abs().max())
        check(d_map <= 1e-4 and d_noise <= 1e-4,
              f"{shape}: fused and unfused differ by {d_map}/{d_noise} dB")
        for i in range(b):
            check(det_set(u.detections, i) == det_set(p.detections, i),
                  f"{shape}: fused and unfused detections differ, CPI {i}")

        # complex128 against the single-device linear pipeline.
        sp128 = ShardedCpiPipeline(cfg, mesh, dtype=torch.complex128,
                                   halo_backend="pallas", graph=False)
        o128 = sp128(*sp128.shard_inputs(xb[:b], yb[:b]))
        d128 = max(float((o128.db_map[i] - refs[i].db_map).abs().max())
                   for i in range(b))
        dn128 = max(abs(float(o128.noise_power[i] - refs[i].noise_power))
                    for i in range(b))
        for i in range(b):
            check(det_set(o128.detections, i) == {
                (r, c) for r, c in zip(
                    refs[i].detections.row[refs[i].detections.valid].tolist(),
                    refs[i].detections.col[refs[i].detections.valid].tolist())},
                f"{shape}: complex128 detections differ from single, CPI {i}")
        check(d128 <= 1e-6 and dn128 <= 1e-6,
              f"{shape}: complex128 sharded vs single {d128}/{dn128} dB")
        print(f"sharded {shape[0]}x{shape[1]}: nfft_seg={sp.nfft_seg} "
              f"segments={sp.n_seg_local}x{sp.seg_len} "
              f"halo/detect launches={launches[shape, 'pallas']} "
              f"collective bytes a rank a step={json.dumps(comm)} "
              f"detections={dets} fused-unfused map {d_map:.3g} dB; "
              f"complex128 vs single map {d128:.3g} dB noise {dn128:.3g} dB;"
              f" against the gathered form (largest of noise, max_power, "
              f"snr, delay, doppler) {json.dumps(gathered)}")
    word = halo_permute.error()
    check(word == 0, f"halo kernel error word {word}")
    return launches[(1, 4), "pallas"]


def phase_sharded_timing(dev, root, card):
    """The sharded CPI on a 1 x 4 mesh on the card (complex64, halo kernel,
    fused detector, row-sharded), its step replayed as a CUDA graph: ms
    per step by CUDA events from planes on the device to detections, peak
    memory, and from the profiler the device busy time, the kernels per
    CPI, the halo kernel's device time and launches per shift (counted on
    the replays, against the shifts they log) and the detect kernel's
    (row-block mode) per step;
    then the main path's largest shift (409 complex64 samples from the
    head of each rank's block, the edge zero-filled) through the halo
    kernel, its plain twin and tensor copies of the same payload (events in
    the order A B B A, and the profiler's device time of each); the
    row-block mode alone at the step's shapes (four 76-row blocks of the
    301 x 411 complex64 map with 5 halo rows) against its plain twin; and
    calibrate_row_shard's decision on this mesh."""
    import numpy as np
    import torch

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.ops.detect import detect, detect_rows_plain
    from blah2_tpu_torch.ops.halo import (_edge, _source, halo_permute,
                                          halo_permute_plain)
    from blah2_tpu_torch.parallel.collectives import count_bytes
    from blah2_tpu_torch.parallel.halo import shift_from_next
    from blah2_tpu_torch.parallel.sharded import (ShardedCpiPipeline,
                                                  calibrate_row_shard)

    cfg = load_config(os.path.join(root, "config", "config.yml"))
    quads, _ = default_scene(cfg)
    mesh = one_card_mesh(dev, (1, 4))
    sp = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                            use_fused_detect=True)
    check(sp.graph, f"the 1 x 4 step is not captured: {sp.graph_reason}")
    planes = sp.shard_inputs(quads[:, 0] + 1j * quads[:, 1],
                             quads[:, 2] + 1j * quads[:, 3])
    torch.cuda.reset_peak_memory_stats()
    cpis = 20
    times = event_times(lambda: sp(*planes), cpis, 3)
    out = sp(*planes)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20

    # The main path: counts at 0 just before, read just after; its shifts
    # from the mesh's collective log.
    n = 5

    def window():
        halo_permute.launches = 0
        with count_bytes(mesh) as ops:
            by_name = device_profile(lambda: sp(*planes), n)
        launches = halo_permute.launches
        shifts = sum(op.kind == "permute" for op in ops)
        # Six shifts a step (four of the clutter filter, the two row
        # halos), one launch each on the one card.
        check(launches == shifts == 6 * n,
              f"{launches} halo launches and {shifts} shifts in {n} CPIs")
        halo_n = sum(c for k, (_, c) in by_name.items()
                     if "halo_permute" in k)
        return (by_name, shifts, halo_n), shortfall(halo_n, launches,
                                                    "halo launches")

    by_name, shifts, halo_n = profiled_whole(window, "sharded timing")
    busy_ms = sum(t for t, _ in by_name.values()) / n / 1e3
    halo_us = sum(t for k, (t, _) in by_name.items() if "halo_permute" in k)
    median = times["median"]

    # The main path's largest shift: 409 complex64 samples from the head
    # of each rank's (1, block_len) block, the last rank zero-filled.
    count = 409
    xs = [torch.complex(p[..., 0], p[..., 1]) for p in planes[0]]
    src = _source(mesh, "pulse", True)
    edge = [_edge(mesh, "pulse", r, True) for r in range(mesh.size)]
    dst = [torch.empty((1, count), dtype=xs[0].dtype, device=dev)
           for _ in xs]

    def kernel():
        shift_from_next(xs, count, mesh, backend="pallas")

    def plain():
        halo_permute_plain([x[..., :count] for x in xs], mesh, to_left=True,
                           mask_edge=True)

    def library():
        for r, s in enumerate(src):
            if edge[r]:
                dst[r].zero_()
            else:
                dst[r].copy_(xs[s][..., :count])

    got = shift_from_next(xs, count, mesh, backend="pallas")
    library()
    check(all(torch.equal(g, d) for g, d in zip(got, dst)),
          "the copies and the masked shift differ")
    plain_a = cuda_ms(plain, 200)
    kern_a = cuda_ms(kernel, 500)
    lib_a = cuda_ms(library, 500)
    lib_b = cuda_ms(library, 500)
    kern_b = cuda_ms(kernel, 500)
    plain_b = cuda_ms(plain, 200)
    m = 50
    prof_lib = device_profile(library, m)

    def shift_window():
        prof = device_profile(kernel, m)
        return prof, shortfall(sum(c for _, c in prof.values()), m,
                               "kernels of the masked shift (one a call)")

    prof_kern = profiled_whole(shift_window, "masked shift")

    # The row-block mode alone at the step's shapes.
    fd = sp.fused_detector
    nr, nc = sp.ambiguity.n_doppler_bins, sp.ambiguity.n_delay_bins
    rng = np.random.default_rng(2)
    zmap = torch.from_numpy((rng.standard_normal((nr, nc))
                             + 1j * rng.standard_normal((nr, nc)))
                            .astype(np.complex64)).to(dev)
    blocks, first = row_blocks(zmap, 4, fd.win_rows, fill=0.0)
    # Halo rows in buffers of their own, as the row halos bring them.
    blocks = [(a.clone(), k, b.clone()) for a, k, b in blocks]
    joined = torch.stack([torch.cat(b) for b in blocks])
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
          fd.win_cols)

    def rows_kernel():
        detect.rows(blocks, first, nr, *kw)

    def rows_plain():
        detect_rows_plain(joined, first, nr, *kw)

    rows_plain_a = cuda_ms(rows_plain, 50)
    rows_kern_a = cuda_ms(rows_kernel, 500)
    rows_kern_b = cuda_ms(rows_kernel, 500)
    rows_plain_b = cuda_ms(rows_plain, 50)

    def rows_window():
        prof = device_profile(rows_kernel, m)
        return prof, shortfall(sum(c for _, c in prof.values()), m,
                               "row-block launches (one a call)")

    prof_rows = profiled_whole(rows_window, "row-block mode")
    r_len = blocks[0][1].shape[0]
    # Each input read once: the rows the kernel reads, those inside the
    # map (the kept rows, and the halo rows that lie in it: none above the
    # first block, none below the last), complex64; cell_ok and scale.
    # Each output written once: db and keep of every kept row (the phantom
    # rows' too), the blocks' sums and maxima.
    wr = fd.win_rows
    n_rows_in = nr + sum(
        len([g for g in (*range(f - wr, f), *range(f + r_len, f + r_len + wr))
             if 0 <= g < nr]) for f in first)
    rows_bytes = (n_rows_in * nc * 8 + nr * nc * 4 + nc * 4
                  + len(blocks) * r_len * nc * 8 + len(blocks) * 8)
    cal = calibrate_row_shard(cfg, mesh, halo_backend="pallas",
                              use_fused_detect=True)
    word = halo_permute.error()
    check(word == 0, f"halo kernel error word {word}")
    # Each input read once and each output written once: the three ranks
    # that send, the four that receive (the edge's zeros).
    payload = count * xs[0].element_size()
    halo_bytes = (sum(not e for e in edge) + mesh.size) * payload
    timing = {
        "mesh": "1x4", "cpi_ms_median": median, "cpi_ms_min": times["min"],
        "cpi_ms_max": times["max"], "cpis": cpis, "peak_mib": peak,
        "device_busy_ms_per_cpi": busy_ms,
        "idle_share": 1.0 - busy_ms / median,
        "kernels_per_cpi": sum(c for _, c in by_name.values()) / n,
        "halo_device_ms": halo_us / max(halo_n, 1) / 1e3,
        "halo_launches_per_call": halo_n / shifts,
        "shift": f"(1, {count}) {xs[0].dtype} from next, edge zeroed",
        "shift_ms": [kern_a, kern_b], "shift_plain_ms": [plain_a, plain_b],
        "shift_library_ms": [lib_a, lib_b],
        "shift_library_device_ms":
            sum(t for t, _ in prof_lib.values()) / m / 1e3,
        "shift_library_launches_per_call":
            sum(c for _, c in prof_lib.values()) / m,
        "shift_device_ms": sum(t for t, _ in prof_kern.values()) / m / 1e3,
        "shift_bound_ms": halo_bytes / HBM_BYTES_PER_S * 1e3,
        "detect_rows_device_ms_in_step": sum(
            t for k, (t, _) in by_name.items() if "detect_blocks" in k)
        / n / 1e3,
        "detect_rows_launches_per_step": sum(
            c for k, (_, c) in by_name.items() if "detect_blocks" in k) / n,
        "rows": f"{len(blocks)} blocks of {r_len} + 2 x {fd.win_rows} rows "
                f"x {nc} complex64, {n_rows_in} rows read",
        "rows_ms": [rows_kern_a, rows_kern_b],
        "rows_plain_ms": [rows_plain_a, rows_plain_b],
        "rows_device_ms": sum(t for t, _ in prof_rows.values()) / m / 1e3,
        "rows_bytes": rows_bytes,
        "rows_bound_ms": rows_bytes / HBM_BYTES_PER_S * 1e3,
        "calibrate_row_shard": {k: cal[k] for k in ("row_shard", "ms_on",
                                                    "ms_off")},
        "card": card, "count": out.detections.count.tolist(),
        "top": top(by_name, n, 12),
    }
    print("sharded_timing " + json.dumps(timing))
    return timing


# The JAX runtime's timing keys (tests/test_timing_keys.py:17 REF_KEYS, plus
# wire_transfer and latency).
REF_KEYS = ("extract_buffer", "spectrum", "clutter_filter",
            "ambiguity_processing", "detector", "tracker",
            "output_radar_data", "cpi")
TIMING_KEYS = set(REF_KEYS) | {"wire_transfer", "latency"}
RUNTIME_CPIS = 20
RUNTIME_PROFILED_CPIS = 8
SAMPLE_EVERY = 4


class StubApi:
    """Takes the place of the API server: keeps what the runtime publishes,
    with the CPI count at the time."""

    def __init__(self):
        self.rt = None
        self.log = []

    def publish(self, product, payload, parsed=None):
        self.log.append((product, payload, self.rt.n_cpis_done))


def run_bounded(rt, n, seconds):
    """``rt.run(n)`` here, stopped by a timer after ``seconds`` (which
    closes the rings, so the loop ends); the runtime is stopped either way.
    Returns the run's wall time in seconds."""
    import threading

    timer = threading.Timer(seconds, rt.stop)
    t0 = time.perf_counter()
    timer.start()
    try:
        rt.run(n_cpis=n, quiet=True)
    finally:
        timer.cancel()
        wall = time.perf_counter() - t0
        rt.stop()
    check(rt.n_cpis_done == n, f"the runtime did {rt.n_cpis_done} of {n} "
          f"CPIs in {seconds} s")
    return wall


def runtime_for(cfg, dev, stub=None, graph="auto"):
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    rt = RadarRuntime(cfg, api_server=stub, staged_sample_every=SAMPLE_EVERY,
                      staged_warmup="sync", graph=graph, device=dev)
    if stub is not None:
        stub.rt = rt
    return rt


def product_leaves(out):
    """The tensors or arrays of a CpiOutputs, in field order (None
    kept)."""
    leaves = []
    for v in out:
        if isinstance(v, tuple):
            leaves.extend(v)
        else:
            leaves.append(v)
    return leaves


def trace_events(prof):
    """The profiler's device events and CUDA runtime and driver calls, from
    its chrome trace, by category, each a list of dicts with ts/dur in us
    and the trace's args."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    pick = {"kernel": [], "gpu_memcpy": [], "gpu_memset": [],
            "cuda_runtime": [], "cuda_driver": []}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in pick:
            pick[ev["cat"]].append(ev)
    return pick


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def overlap_us(a, b, intervals):
    """Length of [a, b] covered by the union of ``intervals``."""
    return union_us([(max(a, u), min(b, v)) for u, v in intervals
                     if u < b and v > a])


def trace_facts(trace):
    """What phase_runtime reads from a profiled run's trace: the kernels,
    the detect kernels among them and their (compute) streams, the HtoD
    copies and those off the compute stream (the chunk copies), the DtoH
    copies, how many chunk copies ran on after their runtime call
    returned, and the intervals of every copy and memset."""
    kern = trace["kernel"]
    compute = {k["args"].get("stream") for k in kern if "detect_" in k["name"]}
    h2d = [m for m in trace["gpu_memcpy"] if "HtoD" in m["name"]]
    copies = [m for m in h2d if m["args"].get("stream") not in compute]
    calls = {c["args"].get("correlation"): c for c in trace["cuda_runtime"]}
    ahead = sum(
        1 for m in copies
        if (c := calls.get(m["args"].get("correlation"))) is not None
        and m["ts"] + m["dur"] > c["ts"] + c["dur"])
    return {
        "kern": kern, "compute": compute, "h2d": h2d, "copies": copies,
        "d2h": [m for m in trace["gpu_memcpy"] if "DtoH" in m["name"]],
        "ahead": ahead,
        "prof_detect": sum("detect_" in k["name"] for k in kern),
        "transfers": [(m["ts"], m["ts"] + m["dur"]) for m in
                      trace["gpu_memcpy"] + trace["gpu_memset"]]}


def phase_runtime(dev, root, card):
    """The port's RadarRuntime on the card at the default config: an
    unpaced replay of int16 quads (three seeded CPIs of default_scene in the
    12-bit range, so the packed-12 wire engages), chunked ingest (8 chunks),
    deferred fetch, a staged sample every 4 CPIs with a sync warm-up, a stub
    publisher. Checks the product sets, their order and lag, both targets,
    the timing keys, a fused and a staged map of the same window, the
    detect kernel's launches; then a second, profiled run for the launches
    by the profiler, the copies on the copy stream and the idle share."""
    import tempfile

    import numpy as np
    import torch

    from blah2_tpu_torch.capture.source import Source
    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.ops import detect as detect_mod

    def config(fname):
        cfg = load_config(os.path.join(root, "config", "config.yml"))
        cfg.capture.replay.state = True
        cfg.capture.replay.loop = True
        cfg.capture.replay.file = fname
        return cfg

    with tempfile.TemporaryDirectory() as tmp:
        cfg = config("")
        scenes = [default_scene(cfg, seed) for seed in (11, 12, 13)]
        targets = scenes[0][1]
        src = Source("RspDuo", cfg.capture.fs, cfg.capture.fc, path=tmp)
        fname = src.open_record_file()
        for q, _ in scenes:
            src.record(q[:, 0] + 1j * q[:, 1], q[:, 2] + 1j * q[:, 3])
        src.close_record_file()
        cfg = config(fname)

        def kept_products(rt):
            outs = []
            emit_products = rt._emit_products

            def keep(out, t0, **kw):
                outs.append(out)
                return emit_products(out, t0, **kw)

            rt._emit_products = keep
            return outs

        # The main path (the CPIs' CUDA graphs): counts at 0 just before,
        # read just after.
        stub = StubApi()
        rt = runtime_for(cfg, dev, stub)
        check(rt.ingest_chunks == 8 and rt.defer_fetch
              and rt._wire_dtype == np.int16 and rt.pipeline.graph,
              "runtime geometry")
        outs = kept_products(rt)
        rt.start_capture()
        detect_mod.detect.launches = 0
        wall = run_bounded(rt, RUNTIME_CPIS, 300.0)
        torch.cuda.synchronize()
        launches = detect_mod.detect.launches
        check(len(rt.pipeline.graphs) == 1, f"{len(rt.pipeline.graphs)} "
              f"graphs captured in one layout")

        # The eager loop on the same replay: the same windows in the same
        # order, so each CPI's products must be the graph run's bits.
        stub_e = StubApi()
        rt_e = runtime_for(cfg, dev, stub_e, graph=False)
        outs_e = kept_products(rt_e)
        rt_e.start_capture()
        wall_e = run_bounded(rt_e, RUNTIME_CPIS, 300.0)
        check(len(outs_e) == len(outs) == RUNTIME_CPIS,
              f"{len(outs_e)} eager and {len(outs)} graph product sets")
        for j, (a, b) in enumerate(zip(outs, outs_e)):
            same = [(x is None and y is None) or (
                x is not None and y is not None
                and np.array_equal(x, y, equal_nan=True))
                for x, y in zip(product_leaves(a), product_leaves(b))]
            check(all(same), f"runtime CPI {j}: the graph loop's products "
                  f"differ from the eager loop's")
        docs_e = [json.loads(v) for p, v, _ in stub_e.log if p == "timing"]
        h2d_bytes = rt._stager.bytes / RUNTIME_CPIS
        check(rt._pack12_ok, "the packed-12 wire did not hold")
        check((rt.buffer1.dropped, rt.buffer2.dropped) == (0, 0),
              "the rings dropped samples")

        # The profiled run, again where its trace falls short.
        def window():
            rt2 = runtime_for(cfg, dev)
            rt2.start_capture()

            def run():
                t_p = time.perf_counter()
                calls = detect_mod.detect.launches
                run_bounded(rt2, RUNTIME_PROFILED_CPIS, 300.0)
                torch.cuda.synchronize()
                return ((time.perf_counter() - t_p) * 1e3,
                        detect_mod.detect.launches - calls)

            # Device activity and the CUDA runtime calls only: the host's
            # operators are not read, and leaving them out keeps the window
            # near the unprofiled run.
            (wall2_ms, calls2), trace = profile_window(run, cpu=False)
            # The detect kernel: once per fused CPI and staged sample, and
            # once in the staged warm-up.
            want2 = RUNTIME_PROFILED_CPIS + 1
            check(calls2 == want2, f"profiled run: {calls2} detect launches, "
                  f"want {want2}")
            facts = trace_facts(trace)
            copies = facts["copies"]
            # The chunk copies: 16 a CPI (8 chunks x 2 channels), from
            # pinned memory, on a stream of their own, under way while the
            # host goes on. A copy that waited for itself ends before its
            # call returns; in sound runs 127 or 128 of 128 ran on after
            # theirs, and 11 of 128 in one whose host was slow (PERF.md,
            # Findings), so a window under half is profiled again.
            short = shortfall(facts["prof_detect"], calls2,
                              "detect launches") + shortfall(
                len(copies), 16 * RUNTIME_PROFILED_CPIS,
                f"chunk copies off the compute stream {facts['compute']}")
            if facts["ahead"] < len(copies) // 2:
                short.append(f"only {facts['ahead']} of {len(copies)} chunk "
                             f"copies ran on after their call returned")
            return (facts, wall2_ms), short

        facts, wall2_ms = profiled_whole(window, "runtime")

    n = RUNTIME_CPIS
    staged = [j for j in range(n) if j % SAMPLE_EVERY == 0]
    # Product sets: N, in order; a fused CPI's one CPI behind its own, a
    # staged sample's in its own (it flushes the pending CPI first).
    maps = [(json.loads(v), done) for p, v, done in stub.log if p == "map"]
    check(len(maps) == n and len(outs) == n,
          f"{len(maps)} map products for {n} CPIs")
    stamps = [m["timestamp"] for m, _ in maps]
    check(stamps == sorted(stamps), "map products out of order")
    lags = [done - j for j, (_, done) in enumerate(maps)]
    check(lags == [0 if j in staged else 1 for j in range(n)],
          f"product lags {lags}")
    for product in ("iqdata", "detection", "timing", "timestamp"):
        got = sum(p == product for p, _, _ in stub.log)
        check(got == n, f"{got} {product} products for {n} CPIs")
    res = rt.pipeline.ambiguity.doppler_resolution
    for j, out in enumerate(outs):
        v = out.detections.valid
        dets = list(zip(out.detections.delay[v], out.detections.doppler[v]))
        for t in targets:
            check(any(abs(d - t.delay_bins) <= 1.0
                      and abs(f - t.doppler_hz) <= 2 * res
                      for d, f in dets), f"CPI {j} missed {t}: {dets}")
    docs = [json.loads(v) for p, v, _ in stub.log if p == "timing"]
    for doc in docs:
        missing = TIMING_KEYS - set(doc)
        check(not missing, f"timing doc without {sorted(missing)}")

    # A fused CPI and a staged sample of the same window: the replay loops
    # over three CPIs, so CPI j holds window j mod 3.
    pairs = [(s, f) for s in staged for f in range(n)
             if f not in staged and f % 3 == s % 3][:2]
    amb, worst = rt.pipeline.ambiguity, {}
    for s, f in pairs:
        a, b = outs[s].db_map, outs[f].db_map
        bulk, null = cell_masks(amb, cfg, b, float(outs[f].noise_power))
        diff = np.abs(a - b)
        for name, m in (("bulk", bulk), ("deeper cells", ~bulk & ~null),
                        ("zero-Doppler clutter lags", null)):
            worst[name] = max(worst.get(name, 0.0), float(diff[m].max()))
    check(worst["bulk"] < 0.05, f"staged and fused maps differ {worst}")
    for name, (lim, _) in DEEP_LIMITS_DB.items():
        check(worst[name] <= lim, f"staged and fused maps differ {worst}")

    kern, copies, h2d, d2h, ahead, prof_detect = (
        facts[k] for k in ("kern", "copies", "h2d", "d2h", "ahead",
                           "prof_detect"))
    check(all("Pinned" in m["name"] for m in copies),
          f"pageable chunk copies: {sorted({m['name'] for m in copies})}")
    kintervals = [(k["ts"], k["ts"] + k["dur"]) for k in kern]
    copy_us = sum(m["dur"] for m in copies) or float("nan")
    over_us = sum(overlap_us(m["ts"], m["ts"] + m["dur"], kintervals)
                  for m in copies)
    busy_us = union_us(kintervals + facts["transfers"])

    def stats(key):
        vals = [d[key] for d in docs]
        return {"median": statistics.median(vals), "min": min(vals),
                "max": max(vals)}

    def stats_e(key):
        vals = [d[key] for d in docs_e]
        return {"median": statistics.median(vals), "min": min(vals),
                "max": max(vals)}

    line = {
        "cpis": n, "staged_samples": len(staged), "wall_s": wall,
        "cpi_ms": stats("cpi"), "latency_ms": stats("latency"),
        "eager": {"wall_s": wall_e, "cpi_ms": stats_e("cpi"),
                  "latency_ms": stats_e("latency"),
                  "bits": f"equal to the graph loop's in {n} CPIs"},
        "stage_mean_ms": {k: statistics.mean(d[k] for d in docs)
                          for k in sorted(TIMING_KEYS - {"cpi", "latency"})},
        "h2d_bytes_per_cpi": h2d_bytes,
        "h2d_copy_ms_per_cpi": copy_us / RUNTIME_PROFILED_CPIS / 1e3,
        "h2d_copies_per_cpi": len(copies) / RUNTIME_PROFILED_CPIS,
        "h2d_ran_on_after_call": ahead / max(len(copies), 1),
        "h2d_overlap_with_kernels_share": over_us / copy_us,
        "profiled_cpis": RUNTIME_PROFILED_CPIS,
        "profiled_ms_per_cpi": wall2_ms / RUNTIME_PROFILED_CPIS,
        "device_busy_ms_per_cpi": busy_us / RUNTIME_PROFILED_CPIS / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / wall2_ms,
        "kernels_per_cpi": len(kern) / RUNTIME_PROFILED_CPIS,
        "detect_launches": launches, "profiled_detect_kernels": prof_detect,
        # Copies other than the chunks' over the profiled run (the staged
        # warm-up's zero planes among them), and the product fetches.
        "h2d_other": {"copies": len(h2d) - len(copies),
                      "bytes": sum(m["args"].get("bytes", 0) for m in h2d
                                   if m not in copies),
                      "kinds": sorted({m["name"] for m in h2d
                                       if m not in copies})},
        "d2h_copies_per_cpi": len(d2h) / RUNTIME_PROFILED_CPIS,
        "d2h_bytes_per_cpi": sum(m["args"].get("bytes", 0) for m in d2h)
        / RUNTIME_PROFILED_CPIS,
        "staged_vs_fused_map_db": worst, "card": card,
    }
    print("runtime " + json.dumps(line))

    # The detect kernel: once per fused CPI and staged sample, and once in
    # the staged warm-up.
    want = n + 1
    check(launches == want, f"{launches} detect launches in {n} CPIs, "
          f"want {want}")
    return launches, line


def phase_nsub(dev, root):
    """One CPI of the default config with process.spectrum.nSub 4, through
    the fused call and call_staged, at complex128 on the card and on the
    CPU: the sub spectra and the map agree within 1e-6 dB; the complex64
    card CPI's sub spectra are finite, of the full analyser's bins."""
    import numpy as np
    import torch

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    cfg = load_config(os.path.join(root, "config", "config.yml"))
    cfg.process.spectrum.n_sub = 4
    quads, _ = default_scene(cfg)
    xp, yp = quads[:, :2], quads[:, 2:]
    ref = CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                      device="cpu").call_quad(quads)
    want_sub, want_map = ref.sub_spectra_db.numpy(), ref.db_map.numpy()
    check(want_sub.shape == (4, 2000), f"sub spectra {want_sub.shape}")
    card = CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                       graph=False, device=dev)
    fused = card.call_quad(quads)
    staged = card.call_staged(xp, yp)
    staged_sub = card.sub_spectra_fn(xp)
    err = {
        "fused_sub": float(np.abs(fused.sub_spectra_db.cpu().numpy()
                                  - want_sub).max()),
        "staged_sub": float(np.abs(staged_sub.cpu().numpy()
                                   - want_sub).max()),
        "fused_map": float(np.abs(fused.db_map.cpu().numpy()
                                  - want_map).max()),
        "staged_map": float(np.abs(staged.db_map.cpu().numpy()
                                   - want_map).max()),
    }
    c64 = CpiPipeline(cfg, graph=False,
                      device=dev).call_quad(quads).sub_spectra_db
    c64 = c64.cpu().numpy()
    print(f"nSub 4 complex128 card vs cpu (dB): {json.dumps(err)}; "
          f"complex64 card sub spectra vs complex128: "
          f"{float(np.abs(c64 - want_sub).max()):.3g} dB")
    check(max(err.values()) <= 1e-6, f"nSub 4 card vs cpu {err}")
    check(c64.shape == (4, 2000) and np.isfinite(c64).all(),
          "complex64 sub spectra")
    return err


# The alternative algorithms at the default config: (stage, settings).
ALTERNATIVES = {
    "eca-b": ("clutter", {"filter": "eca-b", "n_batches": 8}),
    "nlms": ("clutter", {"filter": "nlms", "mu": 0.1}),
    "os": ("detection", {"cfar": "os", "os_rank": 0.75}),
}
# The sharded path's: the two clutter filters, and sub-CPI spectra.
SHARDED_ALTERNATIVES = {
    **{k: ALTERNATIVES[k] for k in ("eca-b", "nlms")},
    "nsub4": ("spectrum", {"n_sub": 4}),
}
# Limits in dB of each alternative's complex64 map on the card against its
# complex128 map on the card, per class of cells (see class_errors): about
# twice the readings of the first chip run (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md, Findings).
ALT_LIMITS_DB = {
    "eca-b": {"clutter lags": 0.33, "deeper cells": 0.07, "rest": 0.04},
    "nlms": {"clutter lags": 0.43, "deeper cells": 0.73, "rest": 0.04},
    "os": {"clutter lags": 0.5, "deeper cells": 0.08, "rest": 0.016},
}
# ECA-B's segment FFT size at the default config (192,000 = 2^9·3·5^3) and
# a neighbour rich in twos, whose complex64 rounding phase_alternatives
# compares.
ECAB_NEIGHBOUR_NFFT = 196_608


def alternative_config(root, alternative):
    """The default config with one (stage, settings) of ALTERNATIVES or
    SHARDED_ALTERNATIVES."""
    from blah2_tpu_torch.config import load_config

    cfg = load_config(os.path.join(root, "config", "config.yml"))
    stage, settings = alternative
    for k, v in settings.items():
        setattr(getattr(cfg.process, stage), k, v)
    return cfg


def class_errors(amb, cfg, db, ref_db, ref_noise):
    """Largest |db − ref_db| over the zero-Doppler clutter-lag cells, the
    cells more than 10 dB under the reference map's mean, and the rest."""
    import numpy as np

    bulk, null = cell_masks(amb, cfg, ref_db, ref_noise)
    diff = np.abs(db - ref_db)
    return {"clutter lags": float(diff[null].max()),
            "deeper cells": float(diff[~bulk & ~null].max()),
            "rest": float(diff[bulk].max())}


def det_cells(det):
    v = det.valid.cpu()
    return set(zip(det.row.cpu()[v].tolist(), det.col.cpu()[v].tolist()))


# The configs of phase_graph: the default and each single-device
# alternative the CPI runs.
GRAPH_CASES = {"default": None, **ALTERNATIVES,
               "nsub4": SHARDED_ALTERNATIVES["nsub4"]}
#: Seeds of the three different CPIs each graph is held to eager on.
GRAPH_SEEDS = (11, 12, 13)
#: (CPIs, warm-ups) timed by events on each path in the smoke: 20 after 3;
#: NLMS (0.4-0.8 s a CPI eager, about 0.09 s replayed) 2 after 0 eager and
#: 5 after 1 replayed. tools/torch_graph_timing.py times 20 after 3 on both.
GRAPH_TIMED = {"graph": (20, 3), "eager": (20, 3), "graph_nlms": (5, 1),
               "eager_nlms": (2, 0)}


def graph_nodes(graph):
    """Nodes of a captured ``torch.cuda.CUDAGraph`` kept with
    ``keep_graph=True``, from cudaGraphGetNodes of the CUDA runtime that
    PyTorch loaded; None where that runtime is not found."""
    import ctypes

    with open("/proc/self/maps") as f:
        paths = sorted({ln.split()[-1] for ln in f if "libcudart.so" in ln})
    if not paths:
        return None
    lib = ctypes.CDLL(paths[0])
    n = ctypes.c_size_t(0)
    err = lib.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def same_bits(a, b):
    """Whether two CpiOutputs hold the same bits, field by field."""
    import torch

    fa, fb = product_leaves(a), product_leaves(b)
    return len(fa) == len(fb) and all(
        (x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and x.shape == y.shape and torch.equal(bits(x).cpu(),
                                                   bits(y).cpu()))
        for x, y in zip(fa, fb))


def graph_scratch(call, rows=False):
    """The detect kernel's scratch (its row-block mode's, with ``rows``) on
    a graph's capture stream, which the graph's launches use; None where
    the kernel never ran there."""
    from blah2_tpu_torch.ops.detect import detect

    return detect.scratch(call.device.index, call.stream.cuda_stream,
                          rows=rows)


def graph_case(dev, cfg, name, timed=GRAPH_TIMED, n_prof=None):
    """One config's CPI through ``call_quad12`` eagerly and as a CUDA graph
    on the card: the capture's times and nodes; on three different CPIs the
    graph's products bit for bit the eager call's, an earlier product
    unchanged by later replays, the detect kernel's ticket counters zero
    after each replay and its launches counted once per replay; the
    profiler's kernel records of ``n_prof`` replays (the detect kernel's
    exact, through profiled_whole), busy ms and the idle share; ms per CPI
    by events on each path, and each path's peak memory."""
    import numpy as np
    import torch

    from blah2_tpu_torch.device import tree_map
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.pack12 import pack12_quads

    # An NLMS replay is about 29,500 kernel records: one a window.
    n_prof = n_prof or (1 if name == "nlms" else 3)
    packed = [torch.from_numpy(pack12_quads(default_scene(cfg, seed)[0]))
              .to(dev) for seed in GRAPH_SEEDS]
    eager = CpiPipeline(cfg, graph=False, device=dev)
    graph = CpiPipeline(cfg, device=dev)
    check(graph.graph and not eager.graph, f"{name}: graph switches")
    mib = 2 ** 20

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = [eager.call_quad12(p) for p in packed]
    torch.cuda.synchronize()
    peak_eager = (torch.cuda.max_memory_allocated() - base) / mib
    check(not same_bits(want[0], want[1]), f"{name}: two CPIs, same bits")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    first = graph.call_quad12(packed[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    held_mib = (torch.cuda.memory_allocated() - base) / mib
    (call,) = graph.graphs.values()
    check(same_bits(first, want[0]), f"{name}: the warm-up's products "
          f"differ from the eager call's")
    per_replay = 0 if name == "os" else 1
    check(call.counts == ({"detect": 1} if per_replay else {}),
          f"{name}: the graph holds {call.counts}")

    outs, launches = [], detect.launches
    for p in packed:
        outs.append(graph.call_quad12(p))
        scratch = graph_scratch(call)
        if scratch is not None:
            zero = int(scratch[:1].abs().sum())
            check(zero == 0, f"{name}: ticket counter {zero} after a replay")
        if len(outs) == 1:
            kept = tree_map(lambda t: t.cpu(), outs[0])
    launches = detect.launches - launches
    check(launches == per_replay * len(packed),
          f"{name}: {launches} detect launches in {len(packed)} replays")
    for j, (got, ref) in enumerate(zip(outs, want)):
        check(same_bits(got, ref), f"{name}: CPI {j} (seed "
              f"{GRAPH_SEEDS[j]}): the graph's products differ from eager")
    check(same_bits(outs[0], kept), f"{name}: a later replay changed an "
          f"earlier call's products")
    peak_graph = (torch.cuda.max_memory_allocated() - base) / mib

    def window():
        before = detect.launches
        by_name = device_profile(lambda: graph.call_quad12(packed[1]), n_prof)
        calls = detect.launches - before
        seen = sum(c for k, (_, c) in by_name.items() if "detect_" in k)
        return by_name, shortfall(seen, calls, "detect launches (one a "
                                  "replay)") + shortfall(
            calls, per_replay * n_prof, "detect calls counted")

    by_name = profiled_whole(window, f"graph {name}")
    busy_ms = sum(t for t, _ in by_name.values()) / n_prof / 1e3
    n_g, w_g = timed["graph_nlms" if name == "nlms" else "graph"]
    n_e, w_e = timed["eager_nlms" if name == "nlms" else "eager"]
    t_graph = event_times(lambda: graph.call_quad12(packed[2]), n_g, w_g)
    t_eager = event_times(lambda: eager.call_quad12(packed[2]), n_e, w_e)
    line = {
        "config": name, "ms_per_cpi_graph": t_graph,
        "ms_per_cpi_eager": t_eager, "cpis_graph": n_g, "cpis_eager": n_e,
        "device_busy_ms_per_cpi": busy_ms,
        "idle_share_graph": 1.0 - busy_ms / t_graph["median"],
        "idle_share_eager": 1.0 - busy_ms / t_eager["median"],
        "kernels_per_cpi": sum(c for _, c in by_name.values()) / n_prof,
        "graph_nodes": graph_nodes(call.graph), **call.stats,
        "first_call_s": first_s, "detect_launches_per_replay": per_replay,
        "peak_mib_eager": peak_eager, "peak_mib_graph": peak_graph,
        "held_mib_graph": held_mib,
        "cufft_plan_cache": [torch.backends.cuda.cufft_plan_cache.size,
                             torch.backends.cuda.cufft_plan_cache.max_size],
        "detections": [int(o.detections.count) for o in outs],
        "bits": "equal on CPIs of seeds " + ", ".join(map(str, GRAPH_SEEDS)),
    }
    check(all(np.isfinite(v) for v in (busy_ms, t_graph["median"])),
          f"{name}: timing")
    return line


def phase_graph(dev, root, card):
    """The single-device CPI as a CUDA graph at the default config and for
    ECA-B, NLMS, OS-CFAR and nSub 4 (graph_case each). Prints one ``graph
    {...}`` line a config."""
    lines = {}
    for name, alternative in GRAPH_CASES.items():
        t0 = time.perf_counter()
        cfg = alternative_config(root, alternative) if alternative else \
            alternative_config(root, ("data", {}))
        line = graph_case(dev, cfg, name)
        line.update(wall_s=time.perf_counter() - t0, card=card)
        print("graph " + json.dumps(line))
        lines[name] = line
    return lines


def phase_alternatives(dev, root, card):
    """ECA-B (nBatches 8) and NLMS (mu 0.1) with CA-CFAR, and Wiener with
    OS-CFAR (rank 0.75), at the default config through the single-device
    pipeline: complex128 on the card against complex128 on the CPU, the
    fused detect kernel against the unfused chain on the same input,
    complex64 on the card against complex128 on the card by class of
    cells, the seeded targets, ms per CPI, kernels and detect launches per
    CPI, and one call_staged CPI's stage times."""
    import numpy as np
    import torch

    from blah2_tpu_torch.data.timing import StageTimer
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops import detect as detect_mod
    from blah2_tpu_torch.ops.pack12 import pack12_quads

    results = {}
    for name, alternative in ALTERNATIVES.items():
        cfg = alternative_config(root, alternative)
        quads, targets = default_scene(cfg)
        packed = torch.from_numpy(pack12_quads(quads)).to(dev)
        t0 = time.perf_counter()
        cpu128 = CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                             device="cpu").call_quad(quads)
        cpu_s = time.perf_counter() - t0
        card128 = CpiPipeline(cfg, dtype=torch.complex128,
                              fused_detect=False, graph=False,
                              device=dev).call_quad(quads)
        f64 = cpu128.db_map.numpy()
        d128 = float(np.abs(card128.db_map.cpu().numpy() - f64).max())
        v = cpu128.detections.valid
        dsnr = float((card128.detections.snr.cpu()[v]
                      - cpu128.detections.snr[v]).abs().max()) \
            if bool(v.any()) else 0.0
        check(d128 <= 1e-6 and dsnr <= 1e-6,
              f"{name}: complex128 card vs cpu map {d128} dB, snr {dsnr} dB")
        check(det_cells(card128.detections) == det_cells(cpu128.detections),
              f"{name}: complex128 card and cpu detections differ")
        check(bool(card128.clutter_ok), f"{name}: clutter solve failed")

        # The main path: counts at 0 just before, read just after.
        pipe = CpiPipeline(cfg, device=dev)
        check((pipe.fused_detector is None) == (name == "os"),
              f"{name}: fused detector {pipe.fused_detector}")
        torch.cuda.synchronize()
        detect_mod.detect.launches = 0
        out = pipe.call_quad12(packed)
        torch.cuda.synchronize()
        launches = detect_mod.detect.launches
        check(launches == (0 if name == "os" else 1),
              f"{name}: {launches} detect launches in one CPI")
        fused_vs_unfused = None
        if launches:
            # The kernel against the unfused chain on the same packed input.
            u = CpiPipeline(cfg, fused_detect=False, graph=False,
                            device=dev).call_quad12(packed)
            fused_vs_unfused = max(
                float((u.db_map - out.db_map).abs().max()),
                abs(float(u.noise_power) - float(out.noise_power)))
            check(fused_vs_unfused <= 1e-4, f"{name}: fused and unfused "
                  f"map or noise differ by {fused_vs_unfused} dB")
            check(det_cells(u.detections) == det_cells(out.detections),
                  f"{name}: fused and unfused detections differ")
        amb = pipe.ambiguity
        c64 = out.db_map.cpu().numpy()
        errs = class_errors(amb, cfg, c64,
                            card128.db_map.cpu().numpy(),
                            float(card128.noise_power))
        lim = ALT_LIMITS_DB[name]
        for k, e in errs.items():
            check(e <= lim[k], f"{name}: complex64 vs complex128 on the card "
                  f"{k} {e} dB, limit {lim[k]}")
        res = amb.doppler_resolution
        ok64, dets64 = found(out, targets, res)
        ok128, _ = found(cpu128, targets, res)
        if name == "nlms":
            check(all(a or not b for a, b in zip(ok64, ok128)),
                  f"nlms: complex64 card lost a target its complex128 cpu "
                  f"run found: card {ok64} cpu {ok128}")
        else:
            check(all(ok64), f"{name}: complex64 card missed a target: "
                  f"{dets64}")

        extra = {}
        if name == "eca-b":
            # The same CPI at a neighbouring segment FFT size: the value
            # does not depend on it, the complex64 rounding does.
            chosen = pipe.clutter.nfft
            pipe.clutter.nfft = ECAB_NEIGHBOUR_NFFT
            alt = pipe.call_quad12(packed).db_map.cpu().numpy()
            pipe.clutter.nfft = chosen
            extra = {"nfft": chosen, f"errors_at_{ECAB_NEIGHBOUR_NFFT}":
                     class_errors(amb, cfg, alt,
                                  card128.db_map.cpu().numpy(),
                                  float(card128.noise_power))}

        ms = event_times(lambda: pipe.call_quad12(packed), 10, 2)
        n_prof = 1 if name == "nlms" else 3

        def window():
            by_name = device_profile(lambda: pipe.call_quad12(packed),
                                     n_prof)
            seen = sum(c for k, (_, c) in by_name.items() if "detect_" in k)
            return by_name, shortfall(seen, launches * n_prof,
                                      "detect launches")

        by_name = profiled_whole(window, name)
        kernels = sum(c for _, c in by_name.values()) / n_prof
        busy = sum(t for t, _ in by_name.values()) / n_prof / 1e3
        xp = torch.from_numpy(quads[:, :2]).to(dev)
        yp = torch.from_numpy(quads[:, 2:]).to(dev)
        pipe.call_staged(xp, yp)
        st = StageTimer()
        st.start()
        staged = pipe.call_staged(xp, yp, timer=st)
        check(det_cells(staged.detections) == det_cells(out.detections),
              f"{name}: staged and fused detections differ")
        results[name] = {
            "complex128_card_vs_cpu_db": d128, "snr_db": dsnr,
            "fused_vs_unfused_db": fused_vs_unfused,
            "complex64_vs_complex128_db": errs,
            "targets_c64_card": ok64, "targets_c128_cpu": ok128,
            "ms_per_cpi": ms, "kernels_per_cpi": kernels,
            "device_busy_ms_per_cpi": busy,
            "idle_share": 1.0 - busy / ms["median"],
            "detect_launches_per_cpi": launches,
            "staged_ms": dict(zip(st.names, st.times_ms)),
            "cpu_complex128_s": cpu_s, "card": card, **extra}
        print(f"alternative {name} " + json.dumps(results[name]))
    return results


def phase_sharded_alternatives(dev, root, card):
    """ECA-B, NLMS and nSub 4 through the sharded pipeline on a 1 × 4 mesh
    of logical ranks on the card, row-sharded: the halo kernel against
    ppermute, the fused detect kernel against the unfused chain and both
    against the gathered form, the halo launches of one step (one a shift
    on one card, the row halos' two included) and the detect kernel's
    (one, its row-block mode), complex128 on the card against the sharded
    complex128 on the CPU, ms per step."""
    import torch

    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.collectives import count_bytes
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    results = {}
    for name, alternative in SHARDED_ALTERNATIVES.items():
        cfg = alternative_config(root, alternative)
        quads, targets = default_scene(cfg)
        x = quads[:, 0] + 1j * quads[:, 1]
        y = quads[:, 2] + 1j * quads[:, 3]
        mesh = one_card_mesh(dev, (1, 4))
        outs, launches = {}, {}
        for backend in ("ppermute", "pallas"):
            sp = ShardedCpiPipeline(cfg, mesh, halo_backend=backend,
                                    use_fused_detect=True)
            planes = sp.shard_inputs(x, y)
            torch.cuda.synchronize()
            # The sharded main path: counts at 0 just before, read after.
            halo_permute.launches = detect.launches = 0
            detect.row_launches = 0
            with count_bytes(mesh) as ops:
                outs[backend] = sp(*planes)
            torch.cuda.synchronize()
            launches[backend] = (halo_permute.launches, detect.launches,
                                 detect.row_launches)
        shifts = sum(op.kind == "permute" for op in ops)
        # The clutter filter's shifts and the fused detector's 2 row halos.
        want = {"eca-b": 5, "nlms": 5, "nsub4": 6}[name]
        check(shifts == want and launches["pallas"] == (want, 1, 1),
              f"sharded {name}: {shifts} shifts, halo/detect/row-block "
              f"launches {launches['pallas']}, want ({want}, 1, 1)")
        check(launches["ppermute"][0] == 0,
              f"sharded {name}: ppermute launched the halo kernel")
        a, p = outs["ppermute"], outs["pallas"]
        check(torch.equal(a.db_map, p.db_map),
              f"sharded {name}: backends' maps differ")
        for k in a.detections._fields:
            check(torch.equal(getattr(a.detections, k),
                              getattr(p.detections, k)),
                  f"sharded {name}: backends' detections differ on {k}")
        ok, _ = found(cpi_of(p, 0), targets, sp.ambiguity.doppler_resolution)
        # The kernel against the unfused chain on the same planes.
        sp_u = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                                  graph=False)
        u = sp_u(*sp_u.shard_inputs(x, y))
        d_fused = max(float((u.db_map - p.db_map).abs().max()),
                      float((u.noise_power - p.noise_power).abs().max()))
        check(d_fused <= 1e-4, f"sharded {name}: fused and unfused map or "
              f"noise differ by {d_fused} dB")
        check(det_set(u.detections, 0) == det_set(p.detections, 0),
              f"sharded {name}: fused and unfused detections differ")
        d_gathered = max(gathered_form_check(
            pipe, pipe.shard_inputs(x, y), f"sharded {name} {kind}")[0]
            for kind, pipe in (("fused", sp), ("unfused", sp_u)))

        # complex128 on the card against the same on the CPU.
        s128 = {}
        for where, m in (("card", mesh), ("cpu", make_radar_mesh(
                1, 4, devices=["cpu"] * 4))):
            sp128 = ShardedCpiPipeline(cfg, m, dtype=torch.complex128,
                                       halo_backend="pallas", graph=False)
            s128[where] = sp128(*sp128.shard_inputs(x, y))
        d128 = float((s128["card"].db_map.cpu()
                      - s128["cpu"].db_map).abs().max())
        check(d128 <= 1e-6, f"sharded {name}: complex128 card vs cpu "
              f"{d128} dB")
        check(det_set(s128["card"].detections, 0)
              == det_set(s128["cpu"].detections, 0),
              f"sharded {name}: complex128 card and cpu detections differ")
        if name == "nsub4":
            dsub = float((s128["card"].sub_spectra_db.cpu()
                          - s128["cpu"].sub_spectra_db).abs().max())
            check(p.sub_spectra_db.shape == (1, 4, 2000) and dsub <= 1e-6,
                  f"sharded nsub4: sub spectra {tuple(p.sub_spectra_db.shape)}"
                  f", complex128 card vs cpu {dsub} dB")
        ms = event_times(lambda: sp(*planes), 10, 2)
        results[name] = {"shifts_per_step": shifts,
                         "halo_launches_per_step": launches["pallas"][0],
                         "detect_launches_per_step": launches["pallas"][1],
                         "complex128_card_vs_cpu_db": d128,
                         "fused_vs_unfused_db": d_fused,
                         "vs_gathered_form": d_gathered,
                         "targets_c64": ok, "ms_per_step": ms, "card": card}
        print(f"sharded_alternative {name} " + json.dumps(results[name]))
    word = halo_permute.error()
    check(word == 0, f"halo kernel error word {word}")
    return results


# The sharded step's algorithms as CUDA graphs (phase_sharded_graph): the
# alternative of the default config (None: the default), the mesh of
# logical ranks on the card, the pipeline's settings (halo kernel always).
SHARDED_GRAPH_CASES = {
    "wiener": (None, (1, 4), {"use_fused_detect": True}),
    "wiener-replicated": (None, (2, 2), {"row_shard": False}),
    "eca-b": (SHARDED_ALTERNATIVES["eca-b"], (1, 4),
              {"use_fused_detect": True}),
    "nlms": (SHARDED_ALTERNATIVES["nlms"], (1, 4),
             {"use_fused_detect": True}),
    "nlms-ranks-in-turn": (SHARDED_ALTERNATIVES["nlms"], (1, 4),
                           {"use_fused_detect": True,
                            "nlms_batch_ranks": False}),
    "nsub4": (SHARDED_ALTERNATIVES["nsub4"], (1, 4),
              {"use_fused_detect": True}),
    "os": (ALTERNATIVES["os"], (1, 4), {}),
}


def scene_batches(cfg, b):
    """Three different batches of ``b`` CPIs: (x, y) complex (b, n) arrays
    of default_scene's CPIs of GRAPH_SEEDS, turned by one a batch."""
    import numpy as np

    quads = [default_scene(cfg, seed)[0] for seed in GRAPH_SEEDS]
    out = []
    for k in range(len(quads)):
        qs = [quads[(k + j) % len(quads)] for j in range(b)]
        out.append((np.stack([q[:, 0] + 1j * q[:, 1] for q in qs]),
                    np.stack([q[:, 2] + 1j * q[:, 3] for q in qs])))
    return out


def storage_span(t):
    """The bytes of ``t``'s storage: (first address, one past the last)."""
    lo = t.untyped_storage().data_ptr()
    return lo, lo + t.untyped_storage().nbytes()


class KernelProbe:
    """While open, keeps each call of the halo kernel and of the detect
    kernel's row-block mode made under a graph's capture: its inputs and
    outputs, tensors of the graph's pool. Held, the capture gives their
    memory to nothing else, so after each replay they hold that replay's
    values: :meth:`errors` holds the kernels' outputs against their plain
    versions on those inputs."""

    def __enter__(self):
        import torch

        from blah2_tpu_torch.ops.detect import DetectKernel
        from blah2_tpu_torch.ops.halo import HaloKernel

        self.halo, self.rows = [], []
        self._saved = (HaloKernel.__call__, DetectKernel.rows)
        halo_call, rows_call = self._saved
        probe = self

        def halo(kernel, bufs, mesh, axis="pulse", to_left=True,
                 collective_id=0, mask_edge=False):
            out = halo_call(kernel, bufs, mesh, axis, to_left,
                            collective_id, mask_edge)
            if torch.cuda.is_current_stream_capturing():
                probe.halo.append((list(bufs), mesh, axis, to_left,
                                   mask_edge, out))
            return out

        def rows(kernel, blocks, first_rows, *args):
            out = rows_call(kernel, blocks, first_rows, *args)
            if torch.cuda.is_current_stream_capturing():
                probe.rows.append((list(blocks), list(first_rows), args,
                                   out))
            return out

        HaloKernel.__call__, DetectKernel.rows = halo, rows
        return self

    def __exit__(self, *exc):
        from blah2_tpu_torch.ops.detect import DetectKernel
        from blah2_tpu_torch.ops.halo import HaloKernel

        HaloKernel.__call__, DetectKernel.rows = self._saved

    def errors(self, what):
        """After a replay: each halo call's outputs the bits of
        halo_permute_plain's on its inputs; each row-block call's keep and
        block maxima equal to detect_rows_plain's, its dB within 1e-4 (the
        phantom rows -inf in both), its block sums within 1e-6 relative.
        Returns the largest halo and row-block differences."""
        import torch

        from blah2_tpu_torch.ops.detect import detect_rows_plain
        from blah2_tpu_torch.ops.halo import halo_permute_plain

        halo_err = 0.0
        for bufs, mesh, axis, to_left, mask_edge, out in self.halo:
            want = halo_permute_plain(bufs, mesh, axis, to_left, mask_edge)
            for r in mesh.local_ranks:
                check(torch.equal(bits(out[r]), bits(want[r])),
                      f"{what}: the halo kernel in the replay differs from "
                      f"its plain version at rank {r}")
                halo_err = max(halo_err, float(
                    (out[r] - want[r]).abs().max()))
        rows_err = 0.0
        for blocks, first, args, got in self.rows:
            want = detect_rows_plain(
                torch.stack([torch.cat(b, dim=-2) for b in blocks]), first,
                *args)
            inside = torch.isfinite(want.db)
            check(torch.equal(got.keep, want.keep)
                  and torch.equal(got.maxes, want.maxes)
                  and torch.equal(torch.isneginf(got.db),
                                  torch.isneginf(want.db)),
                  f"{what}: the row-block mode in the replay differs from "
                  f"detect_rows_plain (keep, maxima or phantom rows)")
            d_db = float((got.db - want.db)[inside].abs().max())
            rel = float(((got.sums.double() - want.sums.double()).abs()
                         / want.sums.double().abs().clamp(min=1.0)).max())
            check(d_db <= 1e-4 and rel <= 1e-6, f"{what}: the row-block "
                  f"mode in the replay: dB {d_db}, block sums {rel}")
            rows_err = max(rows_err, d_db)
        return halo_err, rows_err


def sharded_graph_case(dev, root, name, timed=GRAPH_TIMED, n_prof=None,
                       probe=False):
    """One algorithm of the sharded step (SHARDED_GRAPH_CASES) eagerly and
    as a CUDA graph on logical ranks of the card: the capture's times and
    nodes; on three different batches the replays' products bit for bit
    the eager step's, an earlier product unchanged by later replays, the
    halo and detect kernels' launches and pairs counted once a replay (the
    capture holding an eager step's counts), the row-block mode's ticket
    counters zero after each replay, no output of the graph in its input
    buffers; with ``probe``, both kernels inside each replay against their
    plain versions on the replay's own inputs (KernelProbe); the
    profiler's records of ``n_prof`` replays (each kernel's launches
    exact, through profiled_whole; with ``probe`` the eager step's too),
    busy ms and idle share; ms per step by events on each path, and each
    path's peak memory."""
    import contextlib

    import torch

    from blah2_tpu_torch.device import tree_map
    from blah2_tpu_torch.dsp import graph as graph_mod
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.collectives import count_bytes
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    alternative, shape, settings = SHARDED_GRAPH_CASES[name]
    cfg = alternative_config(root, alternative or ("data", {}))
    mesh = one_card_mesh(dev, shape)
    kw = dict(settings)
    batch_ranks = kw.pop("nlms_batch_ranks", True)
    nlms = name.startswith("nlms")
    # A sharded NLMS replay is several thousand kernel records: one a
    # window.
    n_prof = n_prof or (1 if nlms else 3)
    pipes = {}
    for graph in (False, True):
        sp = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                                graph=graph, **kw)
        sp.nlms_batch_ranks = batch_ranks
        pipes[graph] = sp
    eager, pipe = pipes[False], pipes[True]
    planes = [eager.shard_inputs(x, y)
              for x, y in scene_batches(cfg, shape[0])]
    mib = 2 ** 20

    def moved(before):
        return {k: v - before[k] for k, v in graph_mod.counts().items()
                if v != before[k]}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = []
    for p in planes:
        before = graph_mod.counts()
        want.append(eager(*p))
        step = moved(before)
    torch.cuda.synchronize()
    peak_eager = (torch.cuda.max_memory_allocated() - base) / mib
    check(not same_bits(want[0], want[1]), f"sharded {name}: two batches, "
          f"same bits")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with KernelProbe() if probe else contextlib.nullcontext() as seen:
        first = pipe(*planes[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    held_mib = (torch.cuda.memory_allocated() - base) / mib
    (call,) = pipe.graphs.values()
    check(same_bits(first, want[0]), f"sharded {name}: the warm-up's "
          f"products differ from the eager step's")
    check(call.counts == step, f"sharded {name}: the graph holds "
          f"{call.counts}, an eager step counts {step}")
    # No output of the graph, nor of a halo inside it, in its inputs.
    inputs = [storage_span(b) for b in call.inputs if b is not None]
    outputs = [t for t in product_leaves(call.outputs) if t is not None]
    if probe:
        outputs += [o for *_, out in seen.halo for o in out
                    if o is not None]
    for t in outputs:
        lo, hi = storage_span(t)
        check(all(hi <= a or lo >= b for a, b in inputs),
              f"sharded {name}: a graph output lies in its input buffers")

    n_blocks = len(mesh.local_ranks) * (shape[0] // mesh.shape["cpi"])
    outs, errs = [], (0.0, 0.0)
    before = graph_mod.counts()
    for j, p in enumerate(planes):
        outs.append(pipe(*p))
        torch.cuda.synchronize()
        if probe:
            errs = tuple(map(max, errs, seen.errors(
                f"sharded {name}, batch {j}")))
        scratch = graph_scratch(call, rows=True)
        if scratch is not None:
            zero = int(scratch[:n_blocks].abs().sum())
            check(zero == 0, f"sharded {name}: row-block ticket counters "
                  f"{zero} after a replay")
        if j == 0:
            kept = tree_map(lambda t: t.cpu(), outs[0])
    replayed = moved(before)
    halo_permute.check()
    check(replayed == {k: 3 * v for k, v in step.items()},
          f"sharded {name}: {replayed} counted in 3 replays, an eager step "
          f"{step}")
    for j, (got, ref) in enumerate(zip(outs, want)):
        check(same_bits(got, ref), f"sharded {name}: batch {j}: the "
              f"replay's products differ from the eager step's")
    check(same_bits(outs[0], kept), f"sharded {name}: a later replay "
          f"changed an earlier step's products")
    peak_graph = (torch.cuda.max_memory_allocated() - base) / mib

    def window(sp):
        # The halo and detect launches the profiler saw, exactly those the
        # wrappers counted; the halo's those of n_prof eager steps, one a
        # shift the collectives logged.
        before = graph_mod.counts()
        with count_bytes(mesh) as ops:
            by_name = device_profile(lambda: sp(*planes[1]), n_prof)
        got = moved(before)
        shifts = sum(op.kind == "permute" for op in ops)
        short = []
        for what, key in (("halo launches", "halo_permute"),
                          ("detect launches", "detect_")):
            seen_n = sum(c for k, (_, c) in by_name.items() if key in k)
            short += shortfall(seen_n, got.get(what.split()[0], 0), what)
        return by_name, short + shortfall(
            got.get("halo", 0), n_prof * step.get("halo", 0),
            "halo launches counted") + shortfall(
            got.get("halo", 0), shifts, "halo launches for the shifts")

    by_name = profiled_whole(lambda: window(pipe), f"sharded graph {name}")
    if probe:
        # The eager step, the path over several cards or processes and
        # under --eager, held to the same exact counts.
        eager_prof = profiled_whole(lambda: window(eager),
                                    f"sharded eager {name}")
    busy_ms = sum(t for t, _ in by_name.values()) / n_prof / 1e3
    n_g, w_g = timed["graph_nlms" if nlms else "graph"]
    n_e, w_e = timed["eager_nlms" if nlms else "eager"]
    t_graph = event_times(lambda: pipe(*planes[2]), n_g, w_g)
    t_eager = event_times(lambda: eager(*planes[2]), n_e, w_e)
    line = {
        "case": name, "mesh": f"{shape[0]}x{shape[1]}",
        "row_shard": pipe._row_shard,
        "fused": pipe.fused_detector is not None,
        "nlms_batch_ranks": batch_ranks if nlms else None,
        "graph_reason": pipe.graph_reason,
        "ms_per_step_graph": t_graph, "ms_per_step_eager": t_eager,
        "steps_graph": n_g, "steps_eager": n_e,
        "device_busy_ms_per_step": busy_ms,
        "idle_share_graph": 1.0 - busy_ms / t_graph["median"],
        "idle_share_eager": 1.0 - busy_ms / t_eager["median"],
        "kernels_per_step": sum(c for _, c in by_name.values()) / n_prof,
        "graph_nodes": graph_nodes(call.graph), **call.stats,
        "first_call_s": first_s, "per_replay": call.counts,
        "peak_mib_eager": peak_eager, "peak_mib_graph": peak_graph,
        "held_mib_graph": held_mib,
        "detections": outs[0].detections.count.tolist(),
        "bits": "equal on 3 batches of seeds " + ", ".join(
            map(str, GRAPH_SEEDS)),
    }
    if probe:
        line.update(eager_profiled={
            "steps": n_prof, "kernels_per_step": sum(
                c for _, c in eager_prof.values()) / n_prof,
            "device_busy_ms_per_step": sum(
                t for t, _ in eager_prof.values()) / n_prof / 1e3})
        line.update(kernels_in_replay={
            "halo_calls": len(seen.halo), "row_block_calls": len(seen.rows),
            "halo_max_abs_err": errs[0], "rows_max_abs_err": errs[1]})
    check(all(math.isfinite(v) for v in (busy_ms, t_graph["median"])),
          f"sharded {name}: timing")
    return line


def phase_sharded_graph(dev, root, card):
    """The sharded step as a CUDA graph for every algorithm of the sharded
    path (sharded_graph_case each; the default's both kernels held
    against their plain versions inside its replays). Prints one
    ``sharded_graph {...}`` line a case."""
    lines = {}
    for name in SHARDED_GRAPH_CASES:
        t0 = time.perf_counter()
        line = sharded_graph_case(dev, root, name, probe=name == "wiener")
        line.update(wall_s=time.perf_counter() - t0, card=card)
        print("sharded_graph " + json.dumps(line))
        lines[name] = line
    return lines


RUNTIME_MESH_CPIS = 10
# Limits in dB of the mesh runtime's complex64 maps against the
# single-device pipeline's complex64 maps of the same windows in linear
# clutter mode (the function the sharded path computes), per class of
# cells. Each lies between the largest sound reading (0.575, 0.319 and
# 0.0092 dB, the same in every chip run) and the control reading of a
# different function, the single-device runtime's circular correlations
# (11.2, 1.08 and 0.059 dB), both on an NVIDIA H100 80GB HBM3, 700 W
# (PERF.md, Findings); phase_runtime_mesh prints both.
RUNTIME_MESH_LIMITS_DB = {"clutter lags": 1.15, "deeper cells": 0.64,
                          "rest": 0.02}


def phase_runtime_mesh(dev, root, card, tmp):
    """The runtime in mesh mode, 1 × 4 logical ranks on the card with the
    halo kernel, on the looped replay of phase_runtime's three windows
    (recorded into ``tmp``): 10 product sets in order, the halo launches,
    each map against the single-device pipeline's map of the same window in
    linear clutter mode (the sharded path's function; the single-device
    runtime's circular correlations differ from it by O(n_bins/n), which is
    printed), and the cpi and latency medians; the loop replays the
    step's CUDA graph from its second batch on, and the eager loop on the
    same windows gives the same bits CPI by CPI. Returns the halo launches, the printed line, the
    replay's file and the map products."""
    import numpy as np
    import torch

    from blah2_tpu_torch.capture.source import Source
    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    def config(fname):
        cfg = load_config(os.path.join(root, "config", "config.yml"))
        cfg.capture.replay.state = True
        cfg.capture.replay.loop = True
        cfg.capture.replay.file = fname
        return cfg

    def keep_outputs(rt):
        outs = []
        emit_products = rt._emit_products

        def keep(out, t0, **kw):
            outs.append(out)
            return emit_products(out, t0, **kw)

        rt._emit_products = keep
        return outs

    cfg = config("")
    src = Source("RspDuo", cfg.capture.fs, cfg.capture.fc, path=tmp)
    fname = src.open_record_file()
    linear = CpiPipeline(cfg, clutter_mode="linear", graph=False,
                         device=dev)
    refs = []
    for seed in (11, 12, 13):
        q, _ = default_scene(cfg, seed)
        src.record(q[:, 0] + 1j * q[:, 1], q[:, 2] + 1j * q[:, 3])
        out = linear.call_quad(q)
        refs.append((out.db_map.cpu().numpy(), float(out.noise_power)))
    src.close_record_file()
    cfg = config(fname)

    single = RadarRuntime(cfg, staged_sample_every=0, device=dev)
    single_outs = keep_outputs(single)
    single.start_capture()
    run_bounded(single, 3, 300.0)

    stub = StubApi()
    rt = RadarRuntime(cfg, api_server=stub, mesh=one_card_mesh(
        dev, (1, 4)), halo_backend="pallas")
    stub.rt = rt
    check(rt.cpi_batch == 1 and rt.sharded is not None, "mesh runtime")
    check(rt.sharded.graph, f"the mesh runtime's step is not captured: "
          f"{rt.sharded.graph_reason}")
    outs = keep_outputs(rt)
    rt.start_capture()
    # The mesh runtime's main path: counts at 0 just before, read after.
    halo_permute.launches = 0
    wall = run_bounded(rt, RUNTIME_MESH_CPIS, 300.0)
    torch.cuda.synchronize()
    launches = halo_permute.launches

    n = RUNTIME_MESH_CPIS
    # The eager loop on the same windows: the same bits, CPI by CPI.
    eager_stub = StubApi()
    eager = RadarRuntime(cfg, api_server=eager_stub, mesh=one_card_mesh(
        dev, (1, 4)), halo_backend="pallas", graph=False)
    eager_stub.rt = eager
    eager_outs = keep_outputs(eager)
    eager.start_capture()
    eager_wall = run_bounded(eager, n, 300.0)
    check(len(eager_outs) == n, f"{len(eager_outs)} eager mesh CPIs")
    for j, (a, b) in enumerate(zip(outs, eager_outs)):
        check(all((x is None and y is None) or np.array_equal(x, y)
                  for x, y in zip(product_leaves(a), product_leaves(b),
                                  strict=True)),
              f"mesh runtime CPI {j}: the graph loop's products differ "
              f"from the eager loop's")
    (call,) = rt.sharded.graphs.values()
    replays = call.graph is not None and call.replays == n - 1
    maps = [json.loads(v) for p, v, _ in stub.log if p == "map"]
    check(len(maps) == n == len(outs), f"{len(maps)} map products for {n} "
          f"CPIs")
    stamps = [m["timestamp"] for m in maps]
    check(stamps == sorted(stamps), "mesh runtime products out of order")
    for product in ("iqdata", "detection", "timing", "timestamp"):
        got = sum(p == product for p, _, _ in stub.log)
        check(got == n, f"{got} {product} products for {n} CPIs")
    check(launches == 4 * n, f"{launches} halo launches in {n} steps")
    word = halo_permute.error()
    check(word == 0, f"halo kernel error word {word}")
    worst: dict = {}
    circular: dict = {}
    amb = rt.pipeline.ambiguity
    for j, out in enumerate(outs):
        for acc, (ref_db, ref_noise) in (
                (worst, refs[j % 3]),
                (circular, (single_outs[j % 3].db_map,
                            float(single_outs[j % 3].noise_power)))):
            for k, e in class_errors(amb, cfg, out.db_map, ref_db,
                                     ref_noise).items():
                acc[k] = max(acc.get(k, 0.0), e)
    for k, lim in RUNTIME_MESH_LIMITS_DB.items():
        check(worst[k] <= lim, f"mesh runtime vs linear single {k} "
              f"{worst[k]} dB, limit {lim}")
    docs = [json.loads(v) for p, v, _ in stub.log if p == "timing"]
    for doc in docs:
        missing = TIMING_KEYS - set(doc)
        check(not missing, f"mesh timing doc without {sorted(missing)}")
    check(replays, f"mesh runtime: {call.replays} replays of the step's "
          f"graph in {n} CPIs")
    eager_docs = [json.loads(v) for p, v, _ in eager_stub.log
                  if p == "timing"]
    line = {"cpis": n, "wall_s": wall, "eager_wall_s": eager_wall,
            "cpi_ms_median": statistics.median(d["cpi"] for d in docs),
            "latency_ms_median": statistics.median(d["latency"]
                                                   for d in docs),
            "eager_cpi_ms_median": statistics.median(d["cpi"]
                                                     for d in eager_docs),
            "halo_launches": launches, "vs_linear_single_db": worst,
            "vs_single_runtime_db": circular,
            "graph": {"capture_ms": call.stats["capture_ms"],
                      "instantiate_ms": call.stats["instantiate_ms"],
                      "replays": call.replays,
                      "bits": "equal to the eager loop's, every CPI"},
            "card": card}
    print("runtime_mesh " + json.dumps(line))
    return launches, line, fname, maps


# Two processes of two ranks each on the one card (a 1 x 4 mesh split
# 2 + 2): their group is gloo, the halo kernel serves the pairs inside each
# process and the process group the pair that crosses.
MP_PROCESSES = 2
MP_STEPS = 3
MP_RUNTIME_CPIS = 8
# Per masked shift of the 1 x 4 mesh split 2 + 2: pairs by route, summed
# over the processes (the masked edge moves no payload).
MP_PAIRS_PER_SHIFT = {"kernel": 2, "ipc": 0, "group": 1}
MP_SECONDS = 300


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_workers(mode, extra, seconds):
    """MP_PROCESSES processes of ``chip_smoke.py --worker mode`` on one
    coordinator, each told its index; every one is killed if any runs past
    ``seconds``, and then this fails. Returns their outputs."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", mode,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(MP_PROCESSES), "--process-id", str(k), *extra], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(MP_PROCESSES)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=seconds)[0])
            except subprocess.TimeoutExpired:
                check(False, f"{mode} workers ran past {seconds} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for k, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{mode} worker {k} exited {p.returncode}:"
              f"\n{out[-6000:]}")
    return outs


def worker_step(args) -> int:
    """One process of phase_multiprocess: the default config on this
    process's two ranks of a 1 x 4 mesh over the processes, the halo kernel
    and the fused detector, MP_STEPS steps after a first one; process 0
    writes its products and every process's launches and pairs by route."""
    import numpy as np
    import torch

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel import distributed
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh, rank_devices
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    check(distributed.maybe_initialize(args.coordinator, args.num_processes,
                                       args.process_id), "initialised")
    cfg = load_config(os.path.join(ROOT, "config", "config.yml"))
    quads, _ = default_scene(cfg)
    mesh = make_radar_mesh(1, 4, devices=rank_devices(
        4 // distributed.process_count()))
    sp = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                            use_fused_detect=True)
    # A mesh over processes stays eager, says why, and refuses a graph.
    try:
        ShardedCpiPipeline(cfg, mesh, graph=True)
        refused = ""
    except ValueError as e:
        refused = str(e)
    planes = sp.shard_inputs(quads[:, 0] + 1j * quads[:, 1],
                             quads[:, 2] + 1j * quads[:, 3])
    sp(*planes)  # the plans and the kernels' first use
    torch.cuda.synchronize()
    # The main path: counts at 0 just before, read just after.
    halo_permute.launches = detect.launches = detect.row_launches = 0
    halo_permute.pairs = dict.fromkeys(halo_permute.pairs, 0)
    ms = []
    for _ in range(MP_STEPS):
        t0 = time.perf_counter()
        out = sp(*planes)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = {"halo": halo_permute.launches, "detect": detect.launches,
              "rows": detect.row_launches,
              "pairs": dict(halo_permute.pairs), "ms": ms,
              "backend": distributed.job().backend, "graph": sp.graph,
              "graph_reason": sp.graph_reason, "graph_true": refused}
    halo_permute.check()
    every = distributed.all_gather_object(counts)
    if distributed.process_index() == 0:
        det = out.detections
        np.savez(os.path.join(args.out, "products.npz"),
                 db=out.db_map.cpu().numpy(),
                 noise=out.noise_power.cpu().numpy(),
                 **{f"det_{k}": getattr(det, k).cpu().numpy()
                    for k in det._fields})
        with open(os.path.join(args.out, "counts.json"), "w") as f:
            json.dump(every, f)
    distributed.shutdown()
    return 0


def worker_cli(args) -> int:
    """One process of phase_runtime_multiprocess: the CLI's entry point,
    with its launches and pairs by route written beside its products."""
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.runtime import cli

    cfg = os.path.join(args.out, f"config_{args.process_id}.yml")
    # The main path: counts at 0 just before, read just after.
    halo_permute.launches = 0
    halo_permute.pairs = dict.fromkeys(halo_permute.pairs, 0)
    rc = cli.main(["--config", cfg, "--coordinator", args.coordinator,
                   "--num-processes", str(args.num_processes),
                   "--process-id", str(args.process_id), "--mesh", "1x4",
                   "--halo-backend", "pallas", "--cpis",
                   str(MP_RUNTIME_CPIS), "--no-api", "--quiet"])
    with open(os.path.join(args.out, f"counts_{args.process_id}.json"),
              "w") as f:
        json.dump({"halo": halo_permute.launches,
                   "pairs": dict(halo_permute.pairs)}, f)
    return rc


def phase_multiprocess(dev, root, card):
    """The sharded step over two processes that share the card (gloo),
    two ranks each of a 1 x 4 mesh, at the default config with the halo
    kernel and the fused detector: both kernels launch in the workers, the
    halo pairs by route are as MP_PAIRS_PER_SHIFT says, and process 0's
    products are the bits of this process's own 1 x 4 step on the same
    scene (the same device type and the same sums in the same order),
    both targets found. Each process detects its own ranks' Doppler rows:
    both launch the detect kernel (its row-block mode) once a step, and
    the halo kernel six times (the 4 clutter shifts, the 2 row halos)."""
    import numpy as np

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_workers("step", ["--out", tmp], MP_SECONDS)
        got = dict(np.load(os.path.join(tmp, "products.npz")))
        with open(os.path.join(tmp, "counts.json")) as f:
            every = json.load(f)
    wall = time.perf_counter() - t0
    cfg = load_config(os.path.join(root, "config", "config.yml"))
    quads, targets = default_scene(cfg)
    sp = ShardedCpiPipeline(cfg, one_card_mesh(dev, (1, 4)),
                            halo_backend="pallas", use_fused_detect=True,
                            graph=False)
    ref = sp(*sp.shard_inputs(quads[:, 0] + 1j * quads[:, 1],
                              quads[:, 2] + 1j * quads[:, 3]))
    want_db = ref.db_map.cpu().numpy()
    check(got["db"].shape == want_db.shape, f"map {got['db'].shape}")
    d_map = float(np.abs(got["db"] - want_db).max())
    check(np.array_equal(got["db"], want_db)
          and np.array_equal(got["noise"], ref.noise_power.cpu().numpy()),
          f"two processes' map differs from one process's by {d_map} dB")
    det = ref.detections
    for k in det._fields:
        check(np.array_equal(got[f"det_{k}"], getattr(det, k).cpu().numpy()),
              f"two processes' detections differ on {k}")
    ok, dets = found(cpi_of(ref, 0), targets,
                     sp.ambiguity.doppler_resolution)
    check(all(ok), f"a target missed: {dets}")
    shifts = 6 * MP_STEPS
    check([c["backend"] for c in every] == ["gloo"] * MP_PROCESSES,
          f"backends {[c['backend'] for c in every]}")
    check(not any(c["graph"] for c in every)
          and all(c["graph_true"] for c in every),
          f"a mesh over processes: graph {[c['graph'] for c in every]}, "
          f"graph=True refused with {[c['graph_true'] for c in every]}")
    check([c["halo"] for c in every] == [shifts] * MP_PROCESSES,
          f"halo launches {[c['halo'] for c in every]}, want {shifts} "
          f"in each process")
    check([c["detect"] for c in every] == [MP_STEPS] * MP_PROCESSES
          and [c["rows"] for c in every] == [MP_STEPS] * MP_PROCESSES,
          f"detect launches {[c['detect'] for c in every]}, row-block "
          f"{[c['rows'] for c in every]}, want {MP_STEPS} in each process")
    pairs = {r: sum(c["pairs"][r] for c in every) for r in
             MP_PAIRS_PER_SHIFT}
    check(pairs == {r: n * shifts for r, n in MP_PAIRS_PER_SHIFT.items()},
          f"pairs by route {pairs} in {shifts} shifts")
    line = {"processes": MP_PROCESSES, "mesh": "1x4", "steps": MP_STEPS,
            "halo_launches": [c["halo"] for c in every],
            "detect_launches": [c["detect"] for c in every],
            "pairs": pairs, "map_max_abs_diff_db": d_map,
            "step_ms": [c["ms"] for c in every], "wall_s": wall,
            "step": "eager: " + every[0]["graph_reason"],
            "graph_true": every[0]["graph_true"], "card": card}
    print("multiprocess " + json.dumps(line))
    return line


def phase_runtime_multiprocess(root, card, replay, mesh_maps):
    """The CLI as two processes on the card (``--coordinator ...
    --num-processes 2 --process-id k --mesh 1x4 --halo-backend pallas``) on
    phase_runtime_mesh's replay, each saving its products: MP_RUNTIME_CPIS
    product sets from process 0 in order, its maps against the one-process
    mesh runtime's of the same windows (the same bits, so the same JSON),
    the halo launches and pairs by route, and the cpi = latency medians."""
    import yaml

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(root, "config", "config.yml")) as f:
            doc = yaml.safe_load(f)
        doc["capture"]["replay"] = {"state": True, "loop": True,
                                    "file": replay}
        for k in range(MP_PROCESSES):
            doc["save"] = {"iq": False, "map": True, "detection": False,
                           "timing": True,
                           "path": os.path.join(tmp, f"save_{k}")}
            with open(os.path.join(tmp, f"config_{k}.yml"), "w") as f:
                yaml.safe_dump(doc, f)
        outs = run_workers("cli", ["--out", tmp], MP_SECONDS)
        every = []
        for k in range(MP_PROCESSES):
            with open(os.path.join(tmp, f"counts_{k}.json")) as f:
                every.append(json.load(f))
        saved = {}
        for name in os.listdir(os.path.join(tmp, "save_0")):
            with open(os.path.join(tmp, "save_0", name)) as f:
                saved[os.path.splitext(name)[1]] = json.load(f)
    wall = time.perf_counter() - t0
    n = MP_RUNTIME_CPIS
    check(all("distributed: process" in o for o in outs),
          "a worker printed no distributed line")
    maps, docs = saved.get(".map", []), saved.get(".timing", [])
    check(len(maps) == n == len(docs), f"{len(maps)} maps and {len(docs)} "
          f"timing docs for {n} CPIs")
    stamps = [m["timestamp"] for m in maps]
    check(stamps == sorted(stamps), "products out of order")
    worst = 0.0
    for j, m in enumerate(maps):
        want = mesh_maps[j]
        check(m["noisePower"] == want["noisePower"],
              f"CPI {j}: noise {m['noisePower']} against "
              f"{want['noisePower']}")
        for a, b in zip(m["data"], want["data"]):
            worst = max(worst, max(abs(u - v) for u, v in zip(a, b)))
    check(worst == 0.0, f"process 0's maps differ from the one-process mesh "
          f"runtime's by {worst} dB")
    shifts = 4 * n
    check([c["halo"] for c in every] == [shifts] * MP_PROCESSES,
          f"halo launches {[c['halo'] for c in every]}, want {shifts} "
          f"in each process")
    pairs = {r: sum(c["pairs"][r] for c in every) for r in
             MP_PAIRS_PER_SHIFT}
    check(pairs == {r: k * shifts for r, k in MP_PAIRS_PER_SHIFT.items()},
          f"pairs by route {pairs} in {shifts} shifts")
    line = {"cpis": n, "wall_s": wall,
            "cpi_ms_median": statistics.median(d["cpi"] for d in docs),
            "latency_ms_median": statistics.median(d["latency"]
                                                   for d in docs),
            "halo_launches": [c["halo"] for c in every], "pairs": pairs,
            "card": card}
    print("runtime_multiprocess " + json.dumps(line))
    return line


#: The measuring entry points (blah2_tpu_torch/bench) at cut counts.
BENCH_ARGS = {
    "pipeline": ["--groups", "2"],
    "runtime": ["--measured-cpis", "6"],
    "soak": ["--cpis", "10"],
    "scaling": ["--virtual", "4", "--sizes", "1", "4"],
    "compare": ["--reps", "1"],
}


def finite(value, where):
    """Fail where a number in a bench's result is not finite."""
    if isinstance(value, dict):
        for k, v in value.items():
            finite(v, f"{where}.{k}")
    elif isinstance(value, list):
        for i, v in enumerate(value):
            finite(v, f"{where}[{i}]")
    elif isinstance(value, float):
        check(math.isfinite(value), f"{where} is {value}")


def phase_bench():
    """Each measuring entry point of the port on the card, through its
    ``main(argv)`` as ``python -m blah2_tpu_torch.bench.<name>`` runs it, at
    the default config and cut counts (BENCH_ARGS): each prints its JSON
    line(s). Fails where a number is not finite, where the soak lists a
    failure, or where the detect kernel did not launch in the pipeline and
    runtime benches; returns each bench's detect and halo launches, the
    counts set to 0 just before it."""
    import importlib

    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.halo import halo_permute

    detect_launches, halo_launches, results = {}, {}, {}
    t0 = time.perf_counter()
    for name, argv in BENCH_ARGS.items():
        main_of = importlib.import_module(
            f"blah2_tpu_torch.bench.{name}").main
        detect.launches = halo_permute.launches = 0
        out = main_of(argv)
        detect_launches[name] = detect.launches
        halo_launches[name] = halo_permute.launches
        finite(out, name)
        results[name] = out
    for name in ("pipeline", "runtime"):
        check(detect_launches[name] > 0,
              f"the {name} bench never launched the detect kernel")
    d = results["pipeline"]["detail"]
    check(d["kernels_per_cpi"] and d["card"],
          f"the pipeline bench read no card: {d['kernels_per_cpi']}, "
          f"{d['card']}")
    check(not results["soak"]["detail"]["failures"],
          f"soak failures {results['soak']['detail']['failures']}")
    print(f"bench: {time.perf_counter() - t0:.1f} s; detect launches "
          f"{detect_launches}, halo launches {halo_launches}")
    return detect_launches, halo_launches


#: The deployed system at cut counts: the 3-process topology (CPIs after
#: its warm-up ones), the supervised restart soak (two cycles: one restart
#: gap), the projection.
TOPOLOGY_WARM_CPIS = 3
TOPOLOGY_CPIS = 5
SOAK_CYCLES = 2
SOAK_CPIS_PER_CYCLE = 2
PROJECTION_ARGS = ["--measure", "--n-rep", "2"]


def phase_topology(dev, card):
    """The 3-process topology on the card: this process's radar runtime
    (the supervised soak's config document: the default config, the
    tracker on, a looped replay of bench.runtime's recording; no staged
    samples) sends the six products over TCP into a standalone ``python -m
    blah2_tpu_torch.net.api`` process on free ports. Every product the
    radar sent last (its last CPI's, flushed by the deferred fetch before
    ``run`` returns) is what the API serves, the REST surface answers
    (``net/topology.py``'s checks, as deploy/smoke_3proc_torch.sh runs
    them), and the detect kernel launched
    once a CPI. Returns the launches and the ``cpi`` and ``latency``
    statistics of the CPIs after the warm-up."""
    import yaml

    from blah2_tpu_torch.bench.common import (at, default_config, free_ports,
                                              record_scene)
    from blah2_tpu_torch.bench.runtime import STAGE_KEYS
    from blah2_tpu_torch.bench.soak_supervised import config_doc, last_stamp
    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.net import topology
    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    t0 = time.perf_counter()
    n = TOPOLOGY_WARM_CPIS + TOPOLOGY_CPIS
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = default_config()
        ports = free_ports(8)
        path = os.path.join(tmp, "topology.yml")
        with open(path, "w") as f:
            yaml.safe_dump(config_doc(cfg, record_scene(cfg, tmp), ports), f)
        api = subprocess.Popen(
            [sys.executable, "-m", "blah2_tpu_torch.net.api", "-c", path],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)

        def get(p):
            return topology.get(ports[0], p)

        try:
            topology.wait_for_ports(ports[:7], lambda: api.poll() is None,
                                    120)
            rt = RadarRuntime(load_config(path), api_server=None,
                              use_tcp_egress=True, staged_sample_every=0,
                              device=dev)
            sent, timings = {}, []
            orig = rt._emit

            def emit(product, payload, parsed=None):
                sent[product] = payload
                if product == "timing":
                    timings.append(json.loads(payload))
                return orig(product, payload, parsed=parsed)

            rt._emit = emit
            rt.start_capture()
            # The main path: counts at 0 just before, read just after.
            detect.launches = 0
            wall = run_bounded(rt, n, 300)
            launches = detect.launches
            deadline = time.monotonic() + 10
            while get("/api/timing").decode() != sent["timing"]:
                check(time.monotonic() < deadline,
                      "the last CPI's timing product never reached the API")
                time.sleep(0.05)
            served = {p: get(f"/api/{'tracker' if p == 'track' else p}")
                      .decode() for p in sent}
            rest = topology.rest_checks(ports[0], n)
            fs = json.loads(get("/api/config"))["capture"]["fs"]
        finally:
            api.terminate()
            try:
                api.wait(timeout=15)
            except subprocess.TimeoutExpired:
                api.kill()
                api.wait()
    check(set(sent) == {"map", "detection", "track", "timestamp", "timing",
                        "iqdata"}, f"products sent {sorted(sent)}")
    for p, payload in sent.items():
        if p == "timestamp":  # its listener joins stamps sent close together
            check(last_stamp(served[p]) == int(payload),
                  f"the API serves timestamp {served[p]!r}, sent {payload}")
        else:
            check(served[p] == payload, f"the API's {p} is not the last sent")
    check(json.loads(sent["timing"])["nCpi"] == n,
          f"the last timing product is CPI {json.loads(sent['timing'])}")
    check(all(rest.values()), f"REST checks {rest}")
    check(fs == cfg.capture.fs, f"/api/config fs {fs}")
    check(launches == n, f"detect launches {launches} in {n} CPIs")
    steady = timings[TOPOLOGY_WARM_CPIS:]
    cpi = sorted(d["cpi"] for d in steady)
    line = {"cpis": len(steady), "cpi_ms_p25": at(cpi, 0.25),
            "cpi_ms_median": at(cpi, 0.5), "cpi_ms_max": cpi[-1],
            "latency_ms_median": at(sorted(d["latency"] for d in steady),
                                    0.5),
            "stage_means_ms": {k: statistics.mean(d.get(k, 0.0)
                                                  for d in steady)
                               for k in STAGE_KEYS},
            "detect_launches": launches, "rest": rest, "run_wall_s": wall,
            "wall_s": time.perf_counter() - t0, "card": card}
    print("topology " + json.dumps(line))
    return line


def worker_soak(argv) -> int:
    """One radar worker of phase_supervised_soak: the CLI's entry point on
    its arguments, its detect launches written to ``--out``."""
    import argparse

    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.runtime import cli

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args, rest = ap.parse_known_args(argv)
    # The main path: counts at 0 just before, read just after.
    detect.launches = 0
    rc = cli.main(rest[1:] if rest[:1] == ["--"] else rest)
    with open(os.path.join(args.out, f"soak_{os.getpid()}.json"), "w") as f:
        json.dump({"detect": detect.launches}, f)
    return rc


def phase_supervised_soak(card):
    """The supervised restart soak on the card at the default config
    (``python -m blah2_tpu_torch.bench.soak_supervised``, SOAK_CYCLES
    cycles of SOAK_CPIS_PER_CYCLE CPIs): one API process, radar workers
    relaunched in turn, each worker this script's ``--worker soak`` around
    the CLI's entry point so that its detect launches are counted. No
    failure, every restart gap under the watchdog's 60 s, the kernel build
    and the first product timed apart, each worker's detect kernel
    launched once a CPI."""
    from blah2_tpu_torch.bench import soak_supervised

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = soak_supervised.main(
            ["--cycles", str(SOAK_CYCLES), "--cpis-per-cycle",
             str(SOAK_CPIS_PER_CYCLE)],
            launcher=[sys.executable, os.path.abspath(__file__), "--worker",
                      "soak", "--out", tmp, "--"])
        workers = []
        for name in sorted(os.listdir(tmp)):
            if name.startswith("soak_"):
                with open(os.path.join(tmp, name)) as f:
                    workers.append(json.load(f)["detect"])
    d = out["detail"]
    finite(out, "supervised_soak")
    check(not d["failures"], f"supervised soak failures {d['failures']}")
    check(len(d["inter_restart_gaps_s"]) == SOAK_CYCLES - 1 and
          all(g < 60.0 for g in d["inter_restart_gaps_s"]),
          f"restart gaps {d['inter_restart_gaps_s']}")
    check(d["kernel_build_s"] is not None and d["first_product_s"]
          is not None and d["card"], "build, first product or card missing")
    check(workers == [SOAK_CPIS_PER_CYCLE] * SOAK_CYCLES,
          f"detect launches by worker {workers}")
    print(f"supervised_soak: {time.perf_counter() - t0:.1f} s; detect "
          f"launches by worker {workers}")
    return {"detect_launches": workers, "result": out}


def phase_dryrun(card, visible):
    """``blah2_tpu_torch.entry.dryrun_multichip(4)``: one step of each cell
    of ``__graft_entry__.py``'s matrix on four logical ranks of the card,
    the halo kernel launched in the ``pallas`` cell and in no other, and
    that cell's map the bits of its twin's (the same config, batch and
    2 x 2 mesh with the halos made by torch ops: the kernel against its
    plain twin at the shapes this path gives it); then,
    where the machine has two or more cards (``visible``: the
    CUDA_VISIBLE_DEVICES this script was started with), the same over
    every card in a process that sees them."""
    import torch

    from blah2_tpu_torch import entry
    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.halo import halo_permute

    t0 = time.perf_counter()
    # The main path: counts at 0 just before, read just after.
    halo_permute.launches = detect.launches = 0
    cells = entry.dryrun_multichip(4)
    halo, det = halo_permute.launches, detect.launches
    by_cell = [c["launches"]["halo"] for c in cells]
    check(len(cells) == 11, f"{len(cells)} cells")
    check(all((n > 0) == (c["halo"] == "pallas")
              for n, c in zip(by_cell, cells)),
          f"halo launches by cell {by_cell}")
    check(halo == sum(by_cell), f"halo launches {halo} against {by_cell}")
    pallas = next(c for c in cells if c["halo"] == "pallas")
    twin = next(c for c in cells if c["halo"] == "ppermute" and all(
        c[k] == pallas[k] for k in ("mesh", "filter", "row_shard", "fused",
                                    "extra")))
    check(torch.equal(pallas["db_map"], twin["db_map"]),
          "the halo kernel's map differs from the torch-ops halo's")
    cards = visible_cards(visible)
    over_cards = None
    if cards >= 2:
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        proc = subprocess.run(
            [sys.executable, "-m", "blah2_tpu_torch.entry", "dryrun", "4"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0 and "11 cells" in proc.stdout,
              f"dryrun over {cards} cards exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        over_cards = cards
    else:
        print("note: one card: the dry run over several cards is not run")
    line = {"cells": len(cells), "halo_launches": halo,
            "halo_launches_by_cell": by_cell, "detect_launches": det,
            "halo_cell_map_equals_twin": True,
            "bytes_per_rank_by_cell": [
                sum(v["bytes_per_rank"] for v in c["comm"].values())
                for c in cells],
            "over_cards": over_cards, "wall_s": time.perf_counter() - t0,
            "card": card}
    print("dryrun " + json.dumps(line))
    return line


#: The multi-card graph phase: steps timed after warm-ups on each path (host
#: clock to every card synchronised), and replays in all before the error
#: word is read (at least 50).
CARDS_TIMED = (20, 3)
CARDS_REPLAYS = 60


def visible_cards(visible):
    """The cards of the machine this script may use (``visible``: the
    CUDA_VISIBLE_DEVICES it was started with)."""
    cards = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60).stdout.count("GPU ")
    if visible is not None:
        cards = min(cards, len([v for v in visible.split(",") if v]))
    return cards


def worker_cards(argv) -> int:
    """The multi-card graph on every card this process sees (up to four):
    the default config's 1 x 4 step (Wiener, the halo kernel, the fused
    detector), one rank a card on four cards (two a card on two), eager
    and as one CUDA graph over the cards. On three batches the replays'
    products the eager step's bits, an earlier product unchanged by later
    replays, both kernels' launches counted once a replay (6 halo and 1
    row-block launches a card); the profiler's records of one replay per
    card; ms a step on each path; CARDS_REPLAYS replays in all, then the
    halo kernel's error word 0 and every semaphore consumed. Writes one
    JSON object to ``--out``."""
    import argparse

    import torch

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.device import tree_map
    from blah2_tpu_torch.dsp import graph as graph_mod
    from blah2_tpu_torch.ops.detect import detect
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    n = min(torch.cuda.device_count(), 4)
    cards = [torch.device("cuda", i) for i in range(n)]
    devices = [cards[r * n // 4] for r in range(4)]
    mesh = make_radar_mesh(1, 4, devices=devices)
    cfg = load_config(os.path.join(ROOT, "config", "config.yml"))
    pipes = {graph: ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                                       use_fused_detect=True, graph=graph)
             for graph in (False, "auto")}
    eager, pipe = pipes[False], pipes["auto"]
    check(pipe.graph and not eager.graph, pipe.graph_reason)
    planes = [eager.shard_inputs(x, y) for x, y in scene_batches(cfg, 1)]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def moved(before):
        return {k: v - before[k] for k, v in graph_mod.counts().items()
                if v != before[k]}

    def peaks(base):
        return [(torch.cuda.max_memory_allocated(d) - base[i]) / 2 ** 20
                for i, d in enumerate(cards)]

    def reset():
        sync()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        return [torch.cuda.memory_allocated(d) for d in cards]

    base = reset()
    want = []
    for p in planes:
        before = graph_mod.counts()
        want.append(eager(*p))
        step = moved(before)
    sync()
    peak_eager = peaks(base)
    check(step.get("halo") == 6 * n and step.get("detect_rows") == n,
          f"an eager step over {n} cards counts {step}")
    base = reset()
    first = pipe(*planes[0])
    (call,) = pipe.graphs.values()
    check(same_bits(first, want[0]), "cards: the warm-up differs from the "
          "eager step")
    check(call.counts == step, f"cards: the graph holds {call.counts}, an "
          f"eager step {step}")
    # The main path: counts at 0 just before, read just after.
    halo_permute.launches = detect.launches = detect.row_launches = 0
    outs = []
    for j, p in enumerate(planes):
        outs.append(pipe(*p))
        if j == 0:
            sync()
            kept = tree_map(lambda t: t.cpu(), outs[0])
    sync()
    halo, rows = halo_permute.launches, detect.row_launches
    peak_graph = peaks(base)
    check(halo == 3 * 6 * n and rows == 3 * n,
          f"cards: {halo} halo and {rows} row-block launches in 3 replays")
    for j, (got, ref) in enumerate(zip(outs, want)):
        check(same_bits(got, ref), f"cards: batch {j}: the replay's "
              f"products differ from the eager step's")
    check(same_bits(outs[0], kept), "cards: a later replay changed an "
          "earlier step's products")

    # One replay profiled: each card's device records and busy time.
    def window():
        before = halo_permute.launches
        _, trace = profile_window(lambda: pipe(*planes[1]))
        per = {}
        for ev in trace["kernel"] + trace["gpu_memcpy"] + trace["gpu_memset"]:
            d = str(ev.get("args", {}).get("device", 0))
            c, us = per.get(d, (0, 0.0))
            per[d] = (c + 1, us + ev["dur"])
        seen = sum(1 for ev in trace["kernel"]
                   if "halo_permute" in ev["name"])
        return per, shortfall(seen, halo_permute.launches - before,
                              "halo launches")

    per_card = profiled_whole(window, f"graph over {n} cards")

    def host_ms(fn, n_steps, warm):
        for _ in range(warm):
            fn()
        sync()
        times = []
        for _ in range(n_steps):
            t = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t))
        return {"median": statistics.median(times), "min": min(times),
                "max": max(times)}

    steps, warm = CARDS_TIMED
    t_graph = host_ms(lambda: pipe(*planes[2]), steps, warm)
    t_eager = host_ms(lambda: eager(*planes[2]), steps, warm)
    more = CARDS_REPLAYS - call.replays
    for k in range(max(0, more)):
        got = pipe(*planes[k % 3])
        if k % 10 == 0:
            check(same_bits(got, want[k % 3]), "cards: a later replay "
                  "differs from the eager step")
    sync()
    halo_permute.check()
    word = halo_permute.error()
    flags = [int(w.abs().sum()) for w in halo_permute.flag_words(mesh)]
    check(word == 0, f"cards: halo error word {word}")
    check(not any(flags), f"cards: semaphores {flags} after the replays")
    busy = max(us for _, us in per_card.values()) / 1e3
    line = {"cards": n, "mesh": "1x4", "graph_reason": pipe.graph_reason,
            "halo_launches": halo, "row_block_launches": rows,
            "per_replay": call.counts, "replays": call.replays,
            "error_word": word, "semaphores_after": flags,
            "graph_nodes": graph_nodes(call.graph),
            "records_per_card": {d: c for d, (c, _) in per_card.items()},
            "busy_ms_per_card": {d: us / 1e3
                                 for d, (_, us) in per_card.items()},
            "ms_per_step_graph": t_graph, "ms_per_step_eager": t_eager,
            "idle_share_graph": 1.0 - busy / t_graph["median"],
            "idle_share_eager": 1.0 - busy / t_eager["median"],
            **call.stats,
            "peak_mib_eager": peak_eager, "peak_mib_graph": peak_graph,
            "bits": "equal on 3 batches of seeds " + ", ".join(
                map(str, GRAPH_SEEDS)),
            "wall_s": time.perf_counter() - t0}
    with open(args.out, "w") as f:
        json.dump(line, f)
    return 0


def phase_graph_cards(card, visible):
    """The sharded step as one CUDA graph over several cards, in a process
    that sees every card of the machine (worker_cards), where it has two or
    more; with one card a note and nothing run. Prints one ``graph_cards
    {...}`` line."""
    n = visible_cards(visible)
    if n < 2:
        print("note: one card: the graph over several cards is not run")
        return None
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cards.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "cards",
             "--out", out], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        check(proc.returncode == 0, f"the graph over {n} cards exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}"
              f"{proc.stderr[-3000:]}")
        with open(out) as f:
            line = json.load(f)
    line["card"] = card
    print("graph_cards " + json.dumps(line))
    return line


def phase_projection(dev, card):
    """``python -m blah2_tpu_torch.bench.projection --measure`` at the
    default config, a low repetition count: t_rank and t_fix measured on
    the card, every cell's step finite and positive, the 1 x 4 projection
    set beside the measured four-card layout (c); the detect kernel
    launched by the per-rank pipelines. Then the kernel against
    detect_plain on each per-rank pipeline's map (tCpi/P: 301 down to 19
    Doppler rows by 411 delays), as made from the projection's inputs and
    with targets planted in it."""
    import torch

    from blah2_tpu_torch.bench import projection
    from blah2_tpu_torch.bench.common import DEFAULT_CPI, DEFAULT_FS
    from blah2_tpu_torch.ops.detect import detect

    t0 = time.perf_counter()
    # The main path: counts at 0 just before, read just after.
    detect.launches = 0
    out = projection.main(PROJECTION_ARGS)
    launches = detect.launches
    finite(out, "projection")
    check(out["calibration"]["mode"] == "measured", "t_rank not measured")
    check(all(r["t_step_ms"] > 0 for r in out["cells"]), "a step <= 0")
    check(launches > 0, "the projection never launched the detect kernel")
    err, shapes = 0.0, []
    runs = projection.rank_runs(DEFAULT_FS, DEFAULT_CPI, projection.P_VALUES,
                                dev)
    for p, (pipe, x, y) in runs.items():
        fd = pipe.fused_detector
        check(fd is not None, f"P={p}: no fused detector")
        z, _ = pipe.cross_map(pipe._complex(x), pipe._complex(y))
        nr, nc = z.shape
        planted = z.clone()
        level = 30.0 * float(z.abs().pow(2).mean().sqrt())
        for r, c in ((nr // 2, nc // 2), (nr // 4, 30), (nr - 2, nc - 3),
                     (nr // 2 + 1, nc // 2 + 1)):
            planted[r, c] += level
        kept = []
        for name, m in (("as made", z), ("targets", planted)):
            e, got = detect_against_plain(m, fd, f"projection P={p} {name}")
            err = max(err, e)
            kept.append(int(got.keep.sum()))
        check(kept[1] > 0, f"projection P={p}: no planted target kept")
        shapes.append((p, nr, nc, *kept))
    del runs
    torch.cuda.empty_cache()
    cross = out["cross_check"]
    print(f"projection: {time.perf_counter() - t0:.1f} s; 1 x 4 step "
          f"{cross['projected_1x4_step_ms']:.3f} ms projected against "
          f"{min(cross['measured_4card_layout_c_ms'])}-"
          f"{max(cross['measured_4card_layout_c_ms'])} ms measured "
          f"(layout c); detect launches {launches}; kernel against plain on "
          f"the per-rank maps (P, rows, cols, kept as made, kept with targets) "
          f"{shapes}: max_abs_err_db "
          f"{err:.3g}")
    return {"detect_launches": launches, "max_abs_err": err, "result": out}


def worker_main(argv) -> int:
    import argparse

    if argv[:2] == ["--worker", "soak"]:
        return worker_soak(argv[2:])
    if argv[:2] == ["--worker", "cards"]:
        return worker_cards(argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", choices=("step", "cli"), required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    return {"step": worker_step, "cli": worker_cli}[args.worker](args)


#: Wall seconds of each phase of main, in order.
PHASE_S: dict = {}


def timed(name, phase, *args):
    """``phase(*args)``, its wall seconds kept in PHASE_S under ``name``."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 2)


def main() -> int:
    # The smoke drives one card, the first this process may see; it hides
    # the others (before CUDA starts, and from its workers too), so the
    # device count it reports is the card it ran on.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from blah2_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # One nvcc per source, all started together.
    t0 = time.perf_counter()
    names = ("detect", "halo")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    print(f"build {', '.join(n + '.cu' for n in names)}: "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"-> {os.path.relpath(lib, ROOT)}")
        log = lib[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                print(f.read().strip())

    err, rows_err = timed("kernel_vs_plain", phase_kernel_vs_plain, dev)
    halo_err = timed("halo_vs_plain", phase_halo_vs_plain, dev)
    flags = timed("halo_flags", phase_halo_flags, dev, card)
    timed("golden", phase_golden, dev, ROOT)
    pipe, packed, launches, _ = timed("default", phase_default, dev, ROOT)
    # The runtime's profile first: in whole runs of this script a profiler
    # window that followed several others has lost a record.
    runtime_launches, runtime = timed("runtime", phase_runtime, dev, ROOT,
                                      card)
    timing = timed("timing", phase_timing, pipe, packed, card)
    prof = timed("profile", phase_profile, pipe, packed,
                 timing["cpi_ms_median"])
    graphs = timed("graph", phase_graph, dev, ROOT, card)
    timed("nsub", phase_nsub, dev, ROOT)
    halo_launches, sharded_detect, _ = timed("sharded", phase_sharded, dev,
                                             ROOT)
    sh = timed("sharded_timing", phase_sharded_timing, dev, ROOT, card)
    sh_graph = timed("sharded_graph", phase_sharded_graph, dev, ROOT, card)
    alt = timed("alternatives", phase_alternatives, dev, ROOT, card)
    sh_alt = timed("sharded_alternatives", phase_sharded_alternatives, dev,
                   ROOT, card)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_launches, mesh_rt, replay, mesh_maps = timed(
            "runtime_mesh", phase_runtime_mesh, dev, ROOT, card, tmp)
        mp = timed("multiprocess", phase_multiprocess, dev, ROOT, card)
        mp_rt = timed("runtime_multiprocess", phase_runtime_multiprocess,
                      ROOT, card, replay, mesh_maps)
    bench_detect, bench_halo = timed("bench", phase_bench)
    topo = timed("topology", phase_topology, dev, card)
    sup = timed("supervised_soak", phase_supervised_soak, card)
    dry = timed("dryrun", phase_dryrun, card, visible)
    over_cards = timed("graph_cards", phase_graph_cards, card, visible)
    proj = timed("projection", phase_projection, dev, card)

    graph_kernels = sh_graph["wiener"]["kernels_in_replay"]
    kern_ms = min(timing["detect_ms"])
    plain_ms = min(timing["detect_plain_ms"])
    print(f"default config on {card}: {timing['cpi_ms_median']:.3f} ms/CPI "
          f"median over {timing['cpis']} CPIs (packed-12 on device to "
          f"detections); detect kernel {kern_ms * 1e3:.2f} us, detect_plain "
          f"{plain_ms * 1e3:.2f} us, bound {timing['bound_ms'] * 1e3:.3f} us")
    for k, v in graphs.items():
        print(f"graph {k}, default config on {card}: "
              f"{v['ms_per_cpi_graph']['median']:.3f} ms/CPI replayed, "
              f"{v['ms_per_cpi_eager']['median']:.3f} eager (medians of "
              f"{v['cpis_graph']} and {v['cpis_eager']}); device busy "
              f"{v['device_busy_ms_per_cpi']:.3f} ms, idle "
              f"{v['idle_share_graph']:.3f} / {v['idle_share_eager']:.3f}; "
              f"capture {v['capture_ms']:.1f} ms, instantiate "
              f"{v['instantiate_ms']:.1f} ms, {v['graph_nodes']} nodes")
    print(f"runtime, default config on {card}: "
          f"{runtime['cpi_ms']['median']:.3f} ms/CPI (cpi key) and "
          f"{runtime['latency_ms']['median']:.3f} ms latency, median over "
          f"{runtime['cpis']} CPIs of an unpaced replay (graph); eager "
          f"{runtime['eager']['cpi_ms']['median']:.3f} and "
          f"{runtime['eager']['latency_ms']['median']:.3f} ms; card idle "
          f"{runtime['idle_share']:.3f} of a profiled CPI")
    print("profiler " + json.dumps({
        "windows": len(PROFILE_LOG),
        "opening_markers_lost": {
            i: e["opening_markers"] for i, e in enumerate(PROFILE_LOG)
            if e["opening_markers"][0] < e["opening_markers"][1]},
        "closing_markers_lost": {
            i: e["closing_markers"] for i, e in enumerate(PROFILE_LOG)
            if e["closing_markers"][0] < e["closing_markers"][1]},
        "calls_without_records": {i: e["lost"][:4] for i, e in
                                  enumerate(PROFILE_LOG) if e["lost"]},
        "captured_calls": [e["captured_calls"] for e in PROFILE_LOG]}))
    print(f"sharded default config, 1 x 4 ranks on {card}: "
          f"{sh['cpi_ms_median']:.3f} ms/CPI median over {sh['cpis']} CPIs "
          f"(planes on device to detections); halo kernel "
          f"{min(sh['shift_ms']) * 1e3:.2f} us a shift, "
          f"{sh['halo_device_ms'] * 1e3:.2f} us device; detect row-block "
          f"mode {min(sh['rows_ms']) * 1e3:.2f} us, "
          f"{sh['rows_device_ms'] * 1e3:.2f} us device, bound "
          f"{sh['rows_bound_ms'] * 1e3:.3f} us; calibrate_row_shard picks "
          f"row_shard={sh['calibrate_row_shard']['row_shard']}")
    for k, v in sh_graph.items():
        print(f"sharded graph {k}, {v['mesh']} ranks on {card}: "
              f"{v['ms_per_step_graph']['median']:.3f} ms/step replayed, "
              f"{v['ms_per_step_eager']['median']:.3f} eager (medians of "
              f"{v['steps_graph']} and {v['steps_eager']}); device busy "
              f"{v['device_busy_ms_per_step']:.3f} ms, idle "
              f"{v['idle_share_graph']:.3f} / {v['idle_share_eager']:.3f}; "
              f"capture {v['capture_ms']:.1f} ms, instantiate "
              f"{v['instantiate_ms']:.1f} ms, {v['graph_nodes']} nodes; "
              f"{v['graph_reason']}")
    print(f"halo flags, 1 x 4 on one card on {card}: {flags['replays']} "
          f"replays the bits of halo_permute_plain, error word "
          f"{flags['error_word']}; {flags['device_us_per_launch']:.2f} us "
          f"device a launch, {flags['ms_per_replay']['median'] * 1e3:.2f} "
          f"us a replay of two launches by events, "
          f"{flags['ms_per_eager_pair']['median'] * 1e3:.2f} eager")
    if over_cards:
        print(f"sharded graph over {over_cards['cards']} cards, 1 x 4 on "
              f"{card}: {over_cards['ms_per_step_graph']['median']:.3f} ms "
              f"a step replayed, "
              f"{over_cards['ms_per_step_eager']['median']:.3f} eager (host "
              f"clock to every card synchronised); "
              f"{over_cards['graph_nodes']} nodes, records a card "
              f"{over_cards['records_per_card']}; error word "
              f"{over_cards['error_word']} after {over_cards['replays']} "
              f"replays")
    for k, v in alt.items():
        print(f"{k}, default config on {card}: "
              f"{v['ms_per_cpi']['median']:.3f} ms/CPI median of 10 "
              f"(packed-12 on device to detections), "
              f"{v['kernels_per_cpi']:.0f} kernels a CPI, "
              f"{v['detect_launches_per_cpi']} detect launches a CPI")
    for k, v in sh_alt.items():
        print(f"sharded {k}, 1 x 4 ranks on {card}: "
              f"{v['ms_per_step']['median']:.3f} ms/step median of 10, "
              f"{v['halo_launches_per_step']} halo launches a step")
    print(f"runtime mesh 1 x 4 on {card}: {mesh_rt['cpi_ms_median']} ms "
          f"cpi, {mesh_rt['latency_ms_median']} ms latency (medians of "
          f"{mesh_rt['cpis']})")
    print(f"runtime mesh 1 x 4 over {MP_PROCESSES} processes on {card}: "
          f"{mp_rt['cpi_ms_median']} ms cpi, {mp_rt['latency_ms_median']} "
          f"ms latency (medians of {mp_rt['cpis']})")
    print(f"3-process topology on {card}: {topo['cpi_ms_median']:.3f} ms "
          f"cpi median, p25 {topo['cpi_ms_p25']:.3f} ms, latency "
          f"{topo['latency_ms_median']:.3f} ms over {topo['cpis']} CPIs")
    sd = sup["result"]["detail"]
    print(f"supervised soak on {card}: restart gaps "
          f"{sd['inter_restart_gaps_s']} s, first product "
          f"{sd['first_product_s_per_cycle']} s, kernel build "
          f"{sd['kernel_build_s']:.3f} s, RSS max "
          f"{sd['rss_mb_max_observed']:.1f} MB")
    print("phase_s " + json.dumps(PHASE_S))
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "detect",
        "route": "cuda",
        "source": "blah2_tpu_torch/csrc/detect.cu",
        "replaces": "blah2_tpu/ops/pallas_detect.py:78",
        "launches": runtime_launches,
        "launches_by_path": {
            "runtime": runtime_launches, "call_quad12": launches,
            **{f"graph_{k}_per_replay": v["detect_launches_per_replay"]
               for k, v in graphs.items()},
            **{f"{k}_call_quad12": v["detect_launches_per_cpi"]
               for k, v in alt.items()},
            "sharded_step": sharded_detect,
            **{f"sharded_{k}_step": v["detect_launches_per_step"]
               for k, v in sh_alt.items()},
            "multiprocess_step": mp["detect_launches"],
            **{f"bench_{k}": v for k, v in bench_detect.items()},
            "topology": topo["detect_launches"],
            "supervised_soak": sup["detect_launches"],
            "dryrun": dry["detect_launches"],
            "projection": proj["detect_launches"]},
        "max_abs_err": max(err, proj["max_abs_err"]),
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "library_device_ms": None,
        "device_ms": prof["detect_device_ms"],
        "launches_per_call": prof["detect_launches_per_call"],
    }, {
        # The same source's row-block mode: the row-sharded path's call.
        "name": "detect_rows",
        "route": "cuda",
        "source": "blah2_tpu_torch/csrc/detect.cu",
        "replaces": "blah2_tpu/ops/pallas_detect.py:78",
        "launches": sharded_detect,
        "launches_by_path": {
            "sharded_step": sharded_detect,
            **{f"sharded_{k}_step": v["detect_launches_per_step"]
               for k, v in sh_alt.items()},
            **{f"sharded_graph_{k}_per_replay":
               v["per_replay"].get("detect_rows", 0)
               for k, v in sh_graph.items()},
            "multiprocess_step": mp["detect_launches"],
            **({"graph_cards_replays": over_cards["row_block_launches"]}
               if over_cards else {})},
        "max_abs_err": max(rows_err, graph_kernels["rows_max_abs_err"]),
        "ms": min(sh["rows_ms"]),
        "plain_ms": min(sh["rows_plain_ms"]),
        "bound_ms": sh["rows_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "device_ms": sh["rows_device_ms"],
        "device_ms_in_step": sh["detect_rows_device_ms_in_step"],
        "launches_per_step": sh["detect_rows_launches_per_step"],
    }, {
        "name": "halo",
        "route": "cuda",
        "source": "blah2_tpu_torch/csrc/halo.cu",
        "replaces": "blah2_tpu/parallel/halo.py:49",
        "launches": halo_launches,
        "launches_by_path": {
            "sharded_step": halo_launches,
            **{f"sharded_{k}_step": v["halo_launches_per_step"]
               for k, v in sh_alt.items()},
            **{f"sharded_graph_{k}_per_replay": v["per_replay"].get("halo", 0)
               for k, v in sh_graph.items()},
            "runtime_mesh": mesh_launches,
            "multiprocess_step": mp["halo_launches"],
            "runtime_multiprocess": mp_rt["halo_launches"],
            **{f"bench_{k}": v for k, v in bench_halo.items()},
            "dryrun": dry["halo_launches"],
            "dryrun_by_cell": dry["halo_launches_by_cell"],
            "halo_flags_replays": flags["launches_in_replays"],
            **({"graph_cards_replays": over_cards["halo_launches"]}
               if over_cards else {})},
        "pairs_by_route": {"multiprocess_step": mp["pairs"],
                           "runtime_multiprocess": mp_rt["pairs"]},
        "max_abs_err": max(halo_err, graph_kernels["halo_max_abs_err"]),
        "ms": min(sh["shift_ms"]),
        "plain_ms": min(sh["shift_plain_ms"]),
        "bound_ms": sh["shift_bound_ms"],
        "bound_by": "bytes",
        "library_ms": min(sh["shift_library_ms"]),
        "library_device_ms": sh["shift_library_device_ms"],
        "device_ms": sh["halo_device_ms"],
        "launches_per_call": sh["halo_launches_per_call"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
