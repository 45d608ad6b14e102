#!/usr/bin/env python3
"""The sharded step across cards and processes, on NVIDIA cards.

    python3 tools/torch_multiprocess_timing.py [--steps 20] [--warmup 3]

Times the default config's 1 x 4 sharded step (complex64, the halo kernel,
the fused detector; planes on the cards to detections), eager and replayed
from its CUDA graph (one graph over the cards of a process; in (c) each
process's own, its NCCL payloads inside it), in three layouts:

  (a) one process, the four ranks on one card;
  (b) one process, one rank on each of four cards (peer access, the
      kernel's flag protocol across cards);
  (c) four processes, one card each (``torch.distributed`` with NCCL; the
      halo kernel between processes through CUDA IPC).

Per layout and path (``eager``, ``graph``): ms per step by the host clock
from the call until every card of the process is synchronised, median, min
and max over ``--steps`` steps after ``--warmup`` (in (c), every
process's); by CUDA events on every card (an event on each card's current
stream before and after the step: a replay runs after every card's
stream and each card's stream waits for it); from ``torch.profiler`` over
five steps the device busy ms per step of each card, the idle share
against the median step, the kernels per step, the halo kernel's device
time per launch and the detect kernel's per card (row-sharded, every card
detects its rows); the peak MiB allocated on each card over the timed
steps; for the graph its capture and instantiate ms and its nodes. Then
the halo kernel alone by CUDA events on every card (``halo_events``):
eager calls, and replays of a graph holding one call.
In (c) each process is profiled in a window of its own while the others
run the same steps unprofiled: a profiled process's host falls behind, and
a peer's flagged halo launch or NCCL kernel would count its wait for the
late process as device time. (b) and (c) need four cards and are left
out, with a note, where there are fewer. Prints one JSON line with the
card's name and power limit. Needs a card and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CARDS = 4
PROFILED_STEPS = 5
# Seconds a process of layout (c) may take: past them it prints every
# thread's stack and exits, and the layout fails with its log.
WORKER_SECONDS = 240
# The halo kernel alone: calls timed by events, and the clock cycles each
# card sleeps before them, so that every process has enqueued its calls
# before any card starts them (host skew after a barrier is well below it).
HALO_CALLS = 50
HALO_SLEEP_CYCLES = 4_000_000


def spread(times):
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def pipelines(mesh):
    """The eager and the graph pipeline on ``mesh``, and one batch's
    planes."""
    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    import chip_smoke

    cfg = load_config(os.path.join(ROOT, "config", "config.yml"))
    quads, _ = chip_smoke.default_scene(cfg)
    sps = {path: ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                                    use_fused_detect=True,
                                    graph=path == "graph")
           for path in ("eager", "graph")}
    planes = sps["eager"].shard_inputs(quads[:, 0] + 1j * quads[:, 1],
                                       quads[:, 2] + 1j * quads[:, 3])
    return sps, planes


def host_times(step, cards, n, warmup):
    """ms of ``step()`` until every card of ``cards`` is synchronised."""
    import torch

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    for _ in range(warmup):
        step()
    sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def event_times(step, cards, n, warmup):
    """ms of ``step()`` by CUDA events on each card of ``cards``: {card:
    spread}."""
    import torch

    for _ in range(warmup):
        step()
    times = {c: [] for c in cards}
    for _ in range(n):
        marks = {}
        for c in cards:
            with torch.cuda.device(c):
                marks[c] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                marks[c][0].record()
        step()
        for c in cards:
            with torch.cuda.device(c):
                marks[c][1].record()
        for c in cards:
            marks[c][1].synchronize()
            times[c].append(marks[c][0].elapsed_time(marks[c][1]))
    return {str(c): spread(t) for c, t in times.items()}


def profile(step, cards, ready=None):
    """Per card: device busy ms per step, kernels per step; the halo
    kernel's device us per launch, from the profiler's trace of device
    activity. ``ready()``, where given, runs once the profiler is up and
    before the steps (a barrier: the profiler takes long to start, and
    peers must not wait on the card that long)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import chip_smoke

    for c in cards:
        torch.cuda.synchronize(c)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        if ready is not None:
            ready()
        for _ in range(PROFILED_STEPS):
            step()
        for c in cards:
            torch.cuda.synchronize(c)
    trace = chip_smoke.trace_events(prof)
    busy: dict = {}
    kernels: dict = {}
    halo, detect = [], {}
    for ev in trace["kernel"] + trace["gpu_memcpy"] + trace["gpu_memset"]:
        dev = ev.get("args", {}).get("device", 0)
        busy[dev] = busy.get(dev, 0.0) + ev["dur"]
        kernels[dev] = kernels.get(dev, 0) + 1
        if "halo_permute" in ev["name"]:
            halo.append(ev["dur"])
        if "detect_" in ev["name"]:
            detect.setdefault(dev, []).append(ev["dur"])
    return {"busy_ms_per_step": {str(d): t / PROFILED_STEPS / 1e3
                                 for d, t in sorted(busy.items())},
            "kernels_per_step": {str(d): k / PROFILED_STEPS
                                 for d, k in sorted(kernels.items())},
            "halo_device_us": spread(halo) if halo else None,
            "halo_launches_per_step": len(halo) / PROFILED_STEPS,
            # The detect kernel (map or row-block mode), per card.
            "detect_device_us": {str(d): spread(t)
                                 for d, t in sorted(detect.items())},
            "detect_launches_per_step": {
                str(d): len(t) / PROFILED_STEPS
                for d, t in sorted(detect.items())}}


def halo_events(mesh, cards, replayed=False):
    """Device us of the halo kernel's masked shift of a (1, 409) complex64
    payload (the step's shift) per card, by CUDA events around one call
    (``replayed``: one replay of a CUDA graph holding one call, its inputs
    already in place): each card sleeps, then makes one call that lines
    the cards up (its flags wait for every peer) and the timed call right
    behind it. In a job every process enters each round after a
    barrier."""
    import collections

    import torch

    from blah2_tpu_torch.dsp.graph import StaticCall
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel import distributed

    gen = torch.Generator().manual_seed(7)
    bufs = [None] * mesh.size
    for r in mesh.local_ranks:
        bufs[r] = torch.randn(1, 409, dtype=torch.complex64,
                              generator=gen).to(mesh.devices[r])

    def shift(*b):
        return halo_permute(list(b), mesh, collective_id=7, mask_edge=True)

    run = lambda: shift(*bufs)
    if replayed:
        Out = collections.namedtuple(
            "Out", [f"r{r}" for r in mesh.local_ranks])
        def body(*b):
            got = shift(*b)
            return Out(*[got[r] for r in mesh.local_ranks])

        call = StaticCall(body, bufs, mesh.device, name="halo shift",
                          capture_error_mode="thread_local")
        call.capture(*bufs)
        run = call._replay
    times = {c: [] for c in cards}
    for _ in range(HALO_CALLS):
        if distributed.is_multiprocess():
            torch.distributed.barrier()
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda._sleep(HALO_SLEEP_CYCLES)
        run()
        marks = {}
        for c in cards:
            with torch.cuda.device(c):
                marks[c] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                marks[c][0].record()
        run()
        for c in cards:
            with torch.cuda.device(c):
                marks[c][1].record()
        for c in cards:
            torch.cuda.synchronize(c)
            times[c].append(1e3 * marks[c][0].elapsed_time(marks[c][1]))
    return {str(c): spread(t) for c, t in times.items()}


def measure(sp, planes, cards, args, ready=None):
    """One path of a layout: the first call (a graph's capture), then the
    timed steps, by the host clock and by events, the peak memory a card
    over them, the profile, the idle share; a graph's capture stats and
    nodes."""
    import torch

    import chip_smoke

    t0 = time.perf_counter()
    sp(*planes)
    for c in cards:
        torch.cuda.synchronize(c)
    out = {"first_call_s": time.perf_counter() - t0}
    base = {}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
        base[c] = torch.cuda.memory_allocated(c)
    out["ms"] = spread(host_times(lambda: sp(*planes), cards, args.steps,
                                  args.warmup))
    out["events_ms"] = event_times(lambda: sp(*planes), cards, args.steps,
                                   args.warmup)
    out["peak_mib"] = {str(c): (torch.cuda.max_memory_allocated(c)
                                - base[c]) / 2 ** 20 for c in cards}
    out["profile"] = profile(lambda: sp(*planes), cards, ready)
    busiest = max(out["profile"]["busy_ms_per_step"].values(),
                  default=float("nan"))
    out["idle_share"] = 1.0 - busiest / out["ms"]["median"]
    if sp.graph:
        (call,) = sp.graphs.values()
        out.update(call.stats, graph_nodes=chip_smoke.graph_nodes(call.graph),
                   replays=call.replays, graph_reason=sp.graph_reason)
    return out


def layout_one_process(devices, args):
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    sps, planes = pipelines(make_radar_mesh(1, 4, devices=devices))
    cards = sorted({d.index for d in devices})
    out = {path: measure(sp, planes, cards, args)
           for path, sp in sps.items()}
    mesh = sps["eager"].mesh
    out["halo_events"] = halo_events(mesh, cards)
    out["halo_events_replayed"] = halo_events(mesh, cards, replayed=True)
    halo_permute.check()
    return out


def worker(args) -> int:
    """One process of layout (c)."""
    import faulthandler

    import torch

    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel import distributed
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    faulthandler.dump_traceback_later(WORKER_SECONDS, exit=True)
    distributed.maybe_initialize(args.coordinator, args.num_processes,
                                 args.process_id)
    job = distributed.job()
    mesh = make_radar_mesh(1, 4)
    sps, planes = pipelines(mesh)
    cards = list(job.cards)
    mine = {"process": distributed.process_index(), "cards": cards,
            "backend": job.backend}
    for path, sp in sps.items():
        halo_permute.pairs = dict.fromkeys(halo_permute.pairs, 0)
        # Each process profiled in a window of its own; the others run the
        # same steps, since every process makes the same calls.
        got = None
        for k in range(distributed.process_count()):
            if k == distributed.process_index():
                got = measure(sp, planes, cards, args,
                              ready=torch.distributed.barrier)
            else:
                sp(*planes)
                host_times(lambda: sp(*planes), cards, args.steps,
                           args.warmup)
                event_times(lambda: sp(*planes), cards, args.steps,
                            args.warmup)
                torch.distributed.barrier()
                host_times(lambda: sp(*planes), cards, PROFILED_STEPS, 0)
        calls = 1 + 2 * (args.steps + args.warmup) + PROFILED_STEPS
        got["pairs_per_step"] = {
            k: v / (distributed.process_count() * calls)
            for k, v in halo_permute.pairs.items()}
        mine[path] = got
        print(f"process {distributed.process_index()}: {path} measured",
              flush=True)
    mine["halo_events"] = halo_events(mesh, cards)
    mine["halo_events_replayed"] = halo_events(mesh, cards, replayed=True)
    halo_permute.check()
    every = distributed.all_gather_object(mine)
    if distributed.process_index() == 0:
        with open(args.out, "w") as f:
            json.dump(every, f)
    distributed.shutdown()
    print(f"process {mine['process']}: left the job", flush=True)
    return 0


def layout_processes(args):
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "every.json")
        port = chip_smoke.free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes",
             str(N_CARDS), "--process-id", str(k), "--out", out,
             "--steps", str(args.steps), "--warmup", str(args.warmup)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for k in range(N_CARDS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORKER_SECONDS + 60)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for k, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"process {k} exited {p.returncode}:\n"
                                   f"{log[-6000:]}")
        with open(out) as f:
            every = json.load(f)
    return {"processes": every,
            **{path: {"ms_process_0": every[0][path]["ms"],
                      "ms_slowest_median": max(e[path]["ms"]["median"]
                                               for e in every)}
               for path in ("eager", "graph")}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    import torch

    if not torch.cuda.is_available():
        print("torch_multiprocess_timing: needs a CUDA card",
              file=sys.stderr)
        return 2
    import chip_smoke

    n = torch.cuda.device_count()
    cuda = [torch.device("cuda", i) for i in range(n)]
    result = {"cards_visible": n, "steps": args.steps,
              "warmup": args.warmup,
              "a_one_process_one_card": layout_one_process([cuda[0]] * 4,
                                                           args)}
    if n >= N_CARDS:
        result["b_one_process_four_cards"] = layout_one_process(
            cuda[:N_CARDS], args)
        result["c_four_processes_four_cards"] = layout_processes(args)
    else:
        result["note"] = (f"{n} card(s) visible: layouts (b) and (c) need "
                          f"{N_CARDS}")
    result["card"] = chip_smoke.card_line()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
