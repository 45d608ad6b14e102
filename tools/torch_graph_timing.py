#!/usr/bin/env python3
"""The single-device CPI, or the sharded step, eager against its CUDA graph
on one card.

    python3 tools/torch_graph_timing.py [--cpis 20] [--warmup 3]
                                        [--configs default,eca-b,nlms,os,nsub4]
                                        [--out FILE]
    python3 tools/torch_graph_timing.py --sharded [--cpis 20] [--warmup 3]
        [--configs wiener,wiener-replicated,eca-b,nlms,nlms-ranks-in-turn,
                   nsub4,os] [--out FILE]
    python3 tools/torch_graph_timing.py --ingest [--cpis 20] [--out FILE]

For each config (``chip_smoke.py`` ``GRAPH_CASES``: the default config,
ECA-B, NLMS, OS-CFAR, nSub 4) it runs ``chip_smoke.graph_case``: the
graph's capture (warm-up, capture and instantiate ms, nodes), its products
bit for bit against the eager call's on three CPIs, the detect kernel's
launches and ticket counters per replay, ms per CPI by CUDA events on each
path (``--cpis`` after ``--warmup``, eager NLMS too), the device's busy ms
and idle share from the profiler, and each path's peak memory. The smoke
runs the same at cut counts. With ``--sharded`` it runs
``chip_smoke.sharded_graph_case`` instead for each algorithm of the sharded
path (``chip_smoke.py`` ``SHARDED_GRAPH_CASES``: logical ranks on the one
card, the halo kernel; the default case also holds both kernels inside its
replays against their plain versions), each step eager and replayed
(``--cpis`` steps after ``--warmup`` on each path, NLMS too), as the
smoke's ``phase_sharded_graph`` does at cut counts. With ``--ingest`` it
runs the mesh runtime (1 x 4 logical ranks on the card, the halo kernel,
the step replayed) on the looped replay of the smoke's three recorded
windows, ``--cpis`` CPIs a run, six runs in the order padded, one-pass,
pinned, pinned, one-pass, padded: "one-pass" is the runtime as it is
(``shard_inputs`` fills each rank's planes in one pass from the batch,
copied from pageable memory to the card, then into the graph's input
buffers), "padded" the ``shard_inputs`` before it (the batch padded to
n_pad and stacked into real and imaginary planes, then each rank's block
copied out: :func:`padded_ingest`), "pinned" writes each rank's planes
through pinned buffers straight into the graph's input buffers
(:func:`pinned_ingest`); the two alternatives are kept here, not in the
runtime. Each run's medians of ``cpi`` and of the step's
dispatch ms (the timing doc's ``ambiguity_processing``: host ms from the
windows to the step enqueued), and its products bit for bit the first
run's. Prints one JSON line a config (or run) and the card's name and
power limit, and writes the lines to ``--out`` where given. Needs a card
and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpis", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--configs", default=None,
                    help="comma-separated cases (default: every case of "
                         "the mode)")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded step's cases instead of the "
                         "single-device CPI's")
    ap.add_argument("--ingest", action="store_true",
                    help="the mesh runtime's plane ingest, pinned against "
                         "pageable, instead of the cases")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_graph_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from blah2_tpu_torch.ops import _build

    for name in ("detect", "halo"):
        _build.build(name)
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    timed = {k: (args.cpis, args.warmup)
             for k in ("graph", "eager", "graph_nlms", "eager_nlms")}
    cases = chip_smoke.SHARDED_GRAPH_CASES if args.sharded else \
        chip_smoke.GRAPH_CASES
    lines = []
    if args.ingest:
        lines = ingest_runs(dev, card, args.cpis)
    for name in () if args.ingest else \
            args.configs.split(",") if args.configs else cases:
        if args.sharded:
            line = chip_smoke.sharded_graph_case(
                dev, ROOT, name, timed=timed, probe=name == "wiener")
        else:
            alternative = cases[name]
            cfg = chip_smoke.alternative_config(
                ROOT, alternative or ("data", {}))
            line = chip_smoke.graph_case(dev, cfg, name, timed=timed)
        line.update(card=card, torch=torch.__version__)
        print(json.dumps(line), flush=True)
        lines.append(line)
    print(json.dumps({"profiler_windows": chip_smoke.PROFILE_LOG}))
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


def ingest_runs(dev, card, cpis):
    """The mesh runtime's runs of ``--ingest``: one line each."""
    import tempfile

    from blah2_tpu_torch.config import load_config

    def config(fname):
        cfg = load_config(os.path.join(ROOT, "config", "config.yml"))
        cfg.capture.replay.state = True
        cfg.capture.replay.loop = True
        cfg.capture.replay.file = fname
        return cfg

    with tempfile.TemporaryDirectory(prefix="ingest_") as tmp:
        return _ingest_runs(dev, card, cpis, tmp, config)


def _ingest_runs(dev, card, cpis, tmp, config):
    import statistics

    import numpy as np
    import torch

    import chip_smoke
    from blah2_tpu_torch.capture.source import Source
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = config("")
    src = Source("RspDuo", cfg.capture.fs, cfg.capture.fc, path=tmp)
    fname = src.open_record_file()
    for seed in chip_smoke.GRAPH_SEEDS:
        q, _ = chip_smoke.default_scene(cfg, seed)
        src.record(q[:, 0] + 1j * q[:, 1], q[:, 2] + 1j * q[:, 3])
    src.close_record_file()
    cfg = config(fname)
    lines, first = [], None
    variants = {"padded": padded_ingest, "one-pass": None,
                "pinned": pinned_ingest}
    for ingest in ("padded", "one-pass", "pinned", "pinned", "one-pass",
                   "padded"):
        stub = chip_smoke.StubApi()
        rt = RadarRuntime(cfg, api_server=stub, mesh=chip_smoke.one_card_mesh(
            dev, (1, 4)), halo_backend="pallas")
        stub.rt = rt
        chip_smoke.check(rt.sharded.graph, rt.sharded.graph_reason)
        if variants[ingest] is not None:
            rt.sharded.shard_inputs = variants[ingest](rt.sharded)
        outs = []
        emit = rt._emit_products

        def keep(out, t0, _outs=outs, _emit=emit, **kw):
            _outs.append(out)
            return _emit(out, t0, **kw)

        rt._emit_products = keep
        rt.start_capture()
        wall = chip_smoke.run_bounded(rt, cpis, 300.0)
        torch.cuda.synchronize()
        chip_smoke.check(halo_permute.error() == 0, "halo error word")
        (call,) = rt.sharded.graphs.values()
        docs = [json.loads(v) for p, v, _ in stub.log if p == "timing"]
        first = first or outs
        chip_smoke.check(all(
            all((x is None and y is None) or np.array_equal(x, y)
                for x, y in zip(chip_smoke.product_leaves(a),
                                chip_smoke.product_leaves(b), strict=True))
            for a, b in zip(outs, first, strict=True)),
            f"{ingest}: the products differ from the first run's")
        # The first CPI captures; the medians are of the replays'.
        docs = docs[1:]
        line = {"ingest": ingest, "cpis": cpis, "wall_s": wall,
                "cpi_ms_median": statistics.median(d["cpi"] for d in docs),
                "dispatch_ms_median": statistics.median(
                    d["ambiguity_processing"] for d in docs),
                "dispatch_ms_min": min(d["ambiguity_processing"]
                                       for d in docs),
                "replays": call.replays, "card": card,
                "torch": torch.__version__}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del rt, stub, call
    return lines


def padded_ingest(sp):
    """``sp.shard_inputs`` for the "padded" runs: the batch padded to n_pad
    and stacked into real and imaginary planes, each rank's block then
    copied out and to the card (the same planes)."""
    import numpy as np
    import torch

    plane = np.float64 if sp.dtype == torch.complex128 else np.float32

    def shard_inputs(xb, yb):
        xb, yb = np.asarray(xb), np.asarray(yb)
        pad = ((0, 0), (0, max(0, sp.n_pad - xb.shape[1])))
        b_loc = xb.shape[0] // sp.n_cpi_axis

        def place(a):
            a = np.pad(a, pad)[:, :sp.n_pad]
            planes = np.stack([a.real, a.imag], axis=-1).astype(plane)
            out = [None] * sp.mesh.size
            for r in sp.mesh.local_ranks:
                c, p = sp.mesh.coords(r)
                blk = planes[c * b_loc:(c + 1) * b_loc,
                             p * sp.block_len:(p + 1) * sp.block_len]
                out[r] = torch.from_numpy(np.ascontiguousarray(blk)).to(
                    sp.mesh.devices[r])
            return out

        return place(xb), place(yb)

    return shard_inputs


def pinned_ingest(sp):
    """``sp.shard_inputs`` for the "pinned" runs: once the step's graph is
    captured, each rank's planes written through pinned buffers (two
    batches of them, each reused after its last copy) straight into the
    graph's static input buffers, which it returns as the planes (the
    step's copy of a buffer onto itself is skipped); before, plain
    ``shard_inputs``."""
    import numpy as np
    import torch

    plain, ring, turn = sp.shard_inputs, [], [0]

    def shard_inputs(xb, yb):
        if not sp.graphs:
            return plain(xb, yb)
        (call,) = sp.graphs.values()
        n, m = sp.mesh.size, sum(b is not None for b in call.inputs)
        b_loc = xb.shape[0] // sp.n_cpi_axis
        for i, buf in enumerate(call.inputs):
            if buf is None:
                continue
            j = turn[0] % (2 * m)
            turn[0] += 1
            if j == len(ring):
                ring.append([torch.empty(buf.shape, dtype=buf.dtype,
                                         pin_memory=True), None])
            slot = ring[j]
            if slot[1] is not None:
                slot[1].synchronize()
            a, r = (xb, i) if i < n else (yb, i - n)
            c, p = sp.mesh.coords(r)
            blk = np.asarray(a)[c * b_loc:(c + 1) * b_loc,
                                p * sp.block_len:(p + 1) * sp.block_len]
            host, k = slot[0].numpy(), blk.shape[1]
            host[:, :k, 0] = blk.real
            host[:, :k, 1] = blk.imag
            host[:, k:] = 0
            buf.copy_(slot[0], non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record()
        return call.inputs[:n], call.inputs[n:]

    return shard_inputs


if __name__ == "__main__":
    sys.exit(main())
