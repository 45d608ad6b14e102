"""The entry points of ``__graft_entry__.py`` on the card (its counterpart).

- :func:`entry` is ``dsp/pipeline.py``'s ``entry``: one CPI of the default
  config (fs 2 MHz, tCpi 0.75 s, a 301 × 411 map) and its example inputs.
- :func:`dryrun_multichip` runs one sharded step of each cell of
  ``__graft_entry__.py:97-115``'s matrix at its tiny geometry (fs 40 kHz,
  tCpi 0.1 s, 4,000-sample CPIs): the meshes {1×N, N×1, 2×N/2} ×
  {wiener, eca-b}, then on the last mesh NLMS, row-shard off, the halo
  kernel (``halo="pallas"``), nSub 2 and OS-CFAR. It asserts what JAX
  asserts (the map's shape, ``clutter_ok`` everywhere, the sub-spectra's
  shape), and that the halo kernel's map is the bits of its twin cell's
  (the same cell with the torch-ops halo), and prints one line a cell
  with its collective traffic from ``parallel/collectives.py``
  ``count_bytes``.
- :func:`dryrun_multihost` starts ``n_processes`` processes of this module
  (``worker``) on one coordinator (``parallel/distributed.py``): each runs
  the sharded pipeline on the 2 × N/2 and 1 × N meshes over every process's
  ranks and the row-layout calibration; process 0's maps are held against
  one process running the same meshes.

The ranks take the cards as ``parallel/mesh.py`` ``rank_devices`` places
them (several to a card when there are fewer cards than ranks) unless
``devices`` names them; ``device="cpu"`` runs on the host. Without a card
and without the CPU asked for, each raises (the command line exits 2 with
"no CUDA device"). On a card the halo cell launches the halo kernel and
nothing falls back to its plain version.

    python -m blah2_tpu_torch.entry                      # one CPI, the card
    python -m blah2_tpu_torch.entry dryrun [N]           # N ranks (default 8)
    python -m blah2_tpu_torch.entry dryrun2proc [R]      # 2 processes, R ranks
    python -m blah2_tpu_torch.entry dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from blah2_tpu_torch.bench.common import (default_config, device_or_exit,
                                          free_ports)
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import Config
from blah2_tpu_torch.device import resolve_device
from blah2_tpu_torch.dsp.pipeline import entry as pipeline_entry
from blah2_tpu_torch.ops.detect import detect
from blah2_tpu_torch.ops.halo import halo_permute
from blah2_tpu_torch.parallel import collectives, distributed
from blah2_tpu_torch.parallel.mesh import make_radar_mesh, rank_devices
from blah2_tpu_torch.parallel.sharded import (ShardedCpiPipeline,
                                              calibrate_row_shard)

#: Longest a worker of :func:`dryrun_multihost` may run before every worker
#: is killed and the run fails (``__graft_entry__.py:189``'s wait).
WORKER_SECONDS = 420


def entry(device=None):
    """``(pipeline, example_args)`` for one CPI at the default config, on
    ``device`` (default: the card): ``dsp/pipeline.py``'s ``entry``."""
    return pipeline_entry(device)


def dryrun_config() -> Config:
    """``__graft_entry__.py:91-96``'s tiny geometry: fs 40 kHz, tCpi 0.1 s
    (4,000-sample CPIs), delays −5..40, clutter lags −5..20."""
    cfg = default_config(fs=40_000, cpi=0.1)
    cfg.process.ambiguity.delay_min = -5
    cfg.process.ambiguity.delay_max = 40
    cfg.process.clutter.delay_min = -5
    cfg.process.clutter.delay_max = 20
    return cfg


def dryrun_cells(n_devices: int) -> list:
    """The cell matrix of ``__graft_entry__.py:97-115`` as (mesh shape,
    filter, row_shard, halo backend, fused detector, extra) tuples; the
    fused detector is JAX's default (off) in every cell."""
    shapes = [(1, n_devices)]
    if n_devices > 1:
        shapes.append((n_devices, 1))
    if n_devices % 2 == 0 and n_devices > 2:
        shapes.append((2, n_devices // 2))
    cells = [(s, filt, "auto", "ppermute", False, {})
             for s in shapes for filt in ("wiener", "eca-b")]
    main = shapes[-1]
    cells.append((main, "nlms", "auto", "ppermute", False, {}))
    cells.append((main, "wiener", False, "ppermute", False, {}))
    cells.append((main, "wiener", "auto", "pallas", False, {}))
    # A narrower analyser band, so the 4,000-sample CPI still holds two
    # spectra a segment (``__graft_entry__.py:104-107``).
    cells.append((main, "wiener", "auto", "ppermute", False,
                  {"n_sub": 2, "bandwidth": 500.0}))
    cells.append((main, "wiener", "auto", "ppermute", False, {"cfar": "os"}))
    return cells


def cell_config(filt: str, extra: dict) -> Config:
    """The tiny geometry with a cell's clutter filter and extras."""
    cfg = dryrun_config()
    cfg.process.clutter.filter = filt
    cfg.process.spectrum.n_sub = extra.get("n_sub", 1)
    cfg.process.spectrum.bandwidth = extra.get("bandwidth", 2000.0)
    cfg.process.detection.cfar = extra.get("cfar", "ca")
    return cfg


def cell_batch(cfg: Config, b: int, first_seed: int = 0):
    """``b`` seeded CPIs (seeds ``first_seed`` on) of clutter and one
    target at delay 10, −33 Hz: ``__graft_entry__.py:120-128``'s batch, and
    with ``first_seed`` 100 ``tests/multihost_worker.py:65-74``'s."""
    xs, ys = [], []
    for k in range(b):
        x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                             [TargetSpec(10, -33.0, 0.1)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=first_seed + k)
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"blah2_tpu_torch.entry: {msg}")


def _synchronize(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> List[dict]:
    """One sharded step of every cell of :func:`dryrun_cells` on
    ``n_devices`` logical ranks: ``devices`` (one a rank), else the cards
    in rank order (``rank_devices``). Prints a line a cell and returns the
    cells as dicts (mesh, filter, row_shard, halo, fused, extra,
    detections, ``comm`` by kind, ``ops`` each collective's kind, dtype
    and bytes, the halo and detect kernels' launches in the cell, ms, and
    ``db_map`` on the host). A ``pallas`` cell's map must equal, bit for
    bit, that of the cell that differs from it only in its halo backend:
    the halo kernel against the halos made by torch ops, at the mesh and
    payloads the step gives it."""
    devs = list(devices) if devices is not None else \
        rank_devices(n_devices)
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices for {n_devices} ranks")
    cells = dryrun_cells(n_devices)
    shapes = list(dict.fromkeys(c[0] for c in cells))
    results = []
    for (n_cpi, n_pulse), filt, row_shard, halo, fused, extra in cells:
        cfg = cell_config(filt, extra)
        mesh = make_radar_mesh(n_cpi, n_pulse, devices=devs)
        pipe = ShardedCpiPipeline(cfg, mesh, row_shard=row_shard,
                                  halo_backend=halo, use_fused_detect=fused)
        b = n_cpi
        xp, yp = pipe.shard_inputs(*cell_batch(cfg, b))
        halo0, detect0 = halo_permute.launches, detect.launches
        t0 = time.perf_counter()
        with collectives.count_bytes(mesh) as ops:
            out = pipe(xp, yp)
        _synchronize(devs)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {"halo": halo_permute.launches - halo0,
                    "detect": detect.launches - detect0}
        halo_permute.check()
        nd, n_delay = pipe.ambiguity.n_doppler_bins, \
            pipe.ambiguity.n_delay_bins
        _check(tuple(out.db_map.shape) == (b, nd, n_delay),
               f"map {tuple(out.db_map.shape)}, want {(b, nd, n_delay)}")
        _check(bool(out.clutter_ok.all()), "clutter filter not ok")
        if extra.get("n_sub", 1) > 1:
            _check(out.sub_spectra_db is not None and
                   tuple(out.sub_spectra_db.shape[:2]) == (b, extra["n_sub"]),
                   "sub-spectra shape")
        if halo == "pallas" and mesh.device.type == "cuda" and n_pulse > 1:
            _check(launches["halo"] > 0, "the halo cell launched no kernel")
        comm = collectives.summarize(ops)
        cell = {"mesh": f"{n_cpi}x{n_pulse}", "filter": filt,
                "row_shard": pipe._row_shard, "halo": halo, "fused": fused,
                "extra": dict(extra),
                "detections": int(out.detections.count.sum()),
                "comm": comm,
                "ops": [(op.kind, str(op.dtype), op.bytes_per_rank)
                        for op in ops],
                "launches": launches, "ms": ms,
                "db_map": out.db_map.cpu()}
        results.append(cell)
        comm_str = " ".join(f"{k}:{v['count']}x/{v['bytes_per_rank']}B"
                            for k, v in sorted(comm.items()))
        extra_str = "".join(f" {k}={v}" for k, v in extra.items())
        print(f"  cell mesh={n_cpi}x{n_pulse} filter={filt} "
              f"row_shard={pipe._row_shard} halo={halo} fused={fused}"
              f"{extra_str} detections={cell['detections']} "
              f"comm[{comm_str}] halo_launches={launches['halo']} "
              f"ms={ms:.1f} OK", flush=True)
    for cell, (shape, filt, row_shard, halo, fused, extra) in zip(results,
                                                                  cells):
        if halo != "pallas":
            continue
        twin = cells.index((shape, filt, row_shard, "ppermute", fused,
                            extra))
        want = results[twin]["db_map"]
        _check(torch.equal(cell["db_map"], want),
               f"the halo kernel's map differs from the torch-ops halo's by "
               f"{float((cell['db_map'] - want).abs().max())} dB")
    print(f"dryrun_multichip({n_devices}): {len(cells)} cells "
          f"(meshes {shapes} x {{wiener,eca-b}} + nlms + row_shard-off + "
          f"pallas-halo + nSub=2 + os-cfar) on "
          f"{sorted({str(d) for d in devs})} OK", flush=True)
    return results


# -- several processes --------------------------------------------------------

def multihost_meshes(n_ranks: int) -> list:
    """``tests/multihost_worker.py:79``: each CPI inside one process
    (2 × N/2), then one CPI's time axis across the processes (1 × N)."""
    return [(2, n_ranks // 2), (1, n_ranks)]


def run_meshes(devices: Sequence, n_ranks: int) -> dict:
    """The multi-host worker's steps on meshes of ``n_ranks`` ranks over
    every process (``devices``: this process's ranks), each run twice on
    one batch, the second a replay where the step is captured
    (``graph_mode``): {``db_CxP``: the second's maps, ``ok_CxP``: its
    clutter flags, ``replays_CxP``: the graph's replays}."""
    cfg = dryrun_config()
    xb, yb = cell_batch(cfg, 2, first_seed=100)
    got = {}
    for n_cpi, n_pulse in multihost_meshes(n_ranks):
        mesh = make_radar_mesh(n_cpi, n_pulse, devices=devices)
        pipe = ShardedCpiPipeline(cfg, mesh)
        planes = pipe.shard_inputs(xb[:n_cpi], yb[:n_cpi])
        pipe(*planes)
        out = pipe(*planes)
        got[f"db_{n_cpi}x{n_pulse}"] = out.db_map.cpu().numpy()
        got[f"ok_{n_cpi}x{n_pulse}"] = out.clutter_ok.cpu().numpy()
        got[f"replays_{n_cpi}x{n_pulse}"] = np.array(sum(
            call.replays for call in pipe.graphs.values()))
    halo_permute.check()
    return got


def worker(args) -> int:
    """One process of :func:`dryrun_multihost`."""
    _check(distributed.maybe_initialize(args.coordinator,
                                        args.num_processes, args.process_id,
                                        device=args.device),
           "worker: no coordinator")
    n = args.ranks * distributed.process_count()
    devices = rank_devices(args.ranks, args.device)
    got = run_meshes(devices, n)
    for k in sorted(got):
        if k.startswith("db_"):
            print(f"[process {args.process_id}] mesh {k[3:]}: map "
                  f"{got[k].shape} ok={got['ok_' + k[3:]].tolist()}",
                  flush=True)
    # Every process takes process 0's layout decision.
    cal = calibrate_row_shard(dryrun_config(),
                              make_radar_mesh(2, n // 2, devices=devices),
                              n_trials=1)
    agreed = distributed.all_gather_object(cal["row_shard"])
    _check(len(set(agreed)) == 1, f"row-layout decisions {agreed}")
    _check(cal["pipeline"]._row_shard == cal["row_shard"],
           "calibrated pipeline's layout")
    print(f"[process {args.process_id}] calibrate: row_shard="
          f"{cal['row_shard']}", flush=True)
    if distributed.process_index() == 0:
        np.savez(os.path.join(args.out, "process0.npz"), **got)
    distributed.shutdown()
    return 0


def dryrun_multihost(n_processes: int = 2, ranks_per_process: int = 4,
                     device=None, seconds: float = WORKER_SECONDS) -> dict:
    """``n_processes`` processes of ``ranks_per_process`` ranks each on one
    coordinator (gloo where they share a card or run on the CPU, NCCL
    where each has cards of its own); every process is killed when any
    runs past ``seconds``, and then this raises. Process 0's maps must be
    the bits of this process's run of the same meshes on the same device
    type, each from a replay where the step is captured (NCCL processes
    and one process on cards) and as many replays in both. Returns {mesh:
    max |difference| dB}."""
    dev = resolve_device(device)
    n = n_processes * ranks_per_process
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_ports(1)[0]
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    with tempfile.TemporaryDirectory(prefix="dryrun2proc_") as tmp:
        cmd = [sys.executable, "-m", "blah2_tpu_torch.entry", "worker",
               "--coordinator", f"127.0.0.1:{port}", "--num-processes",
               str(n_processes), "--ranks", str(ranks_per_process),
               "--out", tmp]
        if device is not None:
            cmd += ["--device", str(device)]
        procs = [subprocess.Popen(cmd + ["--process-id", str(k)], cwd=repo,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for k in range(n_processes)]
        outs = []
        deadline = time.monotonic() + seconds
        try:
            for p in procs:
                left = max(1.0, deadline - time.monotonic())
                try:
                    outs.append(p.communicate(timeout=left)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    done = outs + [q.communicate()[0]
                                   for q in procs[len(outs):]]
                    tails = "".join(f"\n-- process {k}:\n{o[-3000:]}"
                                    for k, o in enumerate(done))
                    raise RuntimeError(f"dryrun_multihost: a worker ran past "
                                       f"{seconds} s{tails}") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for k, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multihost: process {k} exited "
                                   f"{p.returncode}:\n{out[-6000:]}")
        got = dict(np.load(os.path.join(tmp, "process0.npz")))
    want = run_meshes(rank_devices(n, dev), n)
    diffs = {}
    for key in want:
        _check(got[key].shape == want[key].shape,
               f"{key}: {got[key].shape} against {want[key].shape}")
        if key.startswith("ok_"):
            _check(bool(got[key].all()), f"{key}: clutter filter not ok")
            continue
        if key.startswith("replays_"):
            _check(int(got[key]) == int(want[key]),
                   f"{key}: process 0 replayed {int(got[key])} times, one "
                   f"process {int(want[key])}")
            continue
        diffs[key[3:]] = float(np.abs(got[key] - want[key]).max())
        _check(np.array_equal(got[key], want[key]),
               f"{key}: process 0's map differs from one process's by "
               f"{diffs[key[3:]]} dB")
    print(f"dryrun_multihost({n_processes}x{ranks_per_process}): maps "
          f"{ {k: got['db_' + k].shape for k in diffs} } equal one "
          f"process's OK", flush=True)
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m blah2_tpu_torch.entry",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="entry",
                    choices=("entry", "dryrun", "dryrun2proc", "worker"))
    ap.add_argument("count", nargs="?", type=int, default=None,
                    help="dryrun: ranks (default 8); dryrun2proc: ranks a "
                         "process (default 4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda; cpu runs "
                         "on the host)")
    ap.add_argument("--coordinator", help="worker: host:port")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--ranks", type=int, help="worker: ranks a process")
    ap.add_argument("--out", help="worker: directory of process 0's maps")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    if args.mode == "worker":
        return worker(args)
    if args.mode == "dryrun":
        n = args.count or 8
        dryrun_multichip(n, rank_devices(n, args.device))
    elif args.mode == "dryrun2proc":
        dryrun_multihost(2, args.count or 4, device=args.device)
    else:
        pipe, (x, y) = entry(dev)
        out = pipe(x, y)
        print("entry OK", tuple(out.db_map.shape), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
