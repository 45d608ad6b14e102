"""CLI entry point: ``python -m blah2_tpu_torch.runtime.cli --config <yml>``
(counterpart of ``blah2_tpu/runtime/cli.py``).

Mirrors the reference binary's interface ``blah2 -c config.yml``
(`src/blah2.cpp:387-436`), plus flags for the port: the device, CPI count
limits, in-process vs TCP API wiring, and a web root for the display layer.
The runtime runs on the card unless ``--device cpu`` asks for the host; with
no card it exits non-zero. ``--mesh CPIxPULSE`` runs the sharded pipeline
over that many logical ranks: on the CPU with ``--device cpu``, else on
the process's cards in rank order, several ranks to a card when there are
fewer cards than ranks (``--mesh 1x4`` runs on one card).

Multi-process and multi-host runs: ``--coordinator host:port
--num-processes N --process-id K`` (or ``BLAH2_COORDINATOR``,
``BLAH2_NUM_PROCESSES``, ``BLAH2_PROCESS_ID``; ``--coordinator auto`` takes
torchrun's environment) on each of N processes. Each initialises
``torch.distributed`` before anything touches a card, prints one
``distributed:`` line (its cards and the backend, chosen from the job's
layout: NCCL where every process computes on cards of its own, else gloo),
and ``--mesh CPIxPULSE`` then builds one mesh over every process's ranks.
Only process 0 serves the API.

``--profile-dir D`` writes the ``torch.profiler`` trace of the run to
``D/trace.json`` with the runtime's spans of its last CPIs
(``RadarRuntime.spans``, ``runtime/spans.py``) merged in on the trace's
clock: complete events of ``cat`` "span" on two tracks named for the radar
thread, so that host phases and device work share one timeline.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="blah2_tpu_torch",
        description="passive radar on an NVIDIA card (PyTorch/CUDA)")
    parser.add_argument("--config", "-c", required=True,
                        help="YAML config file (blah2 schema)")
    parser.add_argument("--cpis", type=int, default=None,
                        help="stop after N CPIs (default: run forever)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card, "
                             "cuda; cpu runs on the host)")
    parser.add_argument("--no-api", action="store_true",
                        help="do not start the REST API server")
    parser.add_argument("--tcp-egress", action="store_true",
                        help="send products over the six TCP streams "
                             "(reference wire contract) instead of "
                             "in-process publishing")
    default_web = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "web")
    parser.add_argument("--web-root",
                        default=default_web if os.path.isdir(default_web)
                        else None,
                        help="serve the web frontend from this directory "
                             "(default: the repo's web/)")
    parser.add_argument("--staged-timing", action="store_true",
                        help="time each DSP stage separately (fills all "
                             "reference timing keys; waits after each "
                             "stage)")
    parser.add_argument("--staged-sample-every", type=int, default=16,
                        metavar="N",
                        help="run a staged sample (each stage waited "
                             "for and timed) every N CPIs (0 disables; "
                             "default 16)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the run to "
                             "this directory (trace.json), the runtime's "
                             "spans merged in")
    parser.add_argument("--eager", action="store_true",
                        help="run each CPI from eager Python instead of "
                             "replaying its CUDA graph (on a card: the "
                             "single-device loop, and the mesh loop where "
                             "every rank lies on one card of one process; "
                             "default: the graph)")
    parser.add_argument("--no-defer-fetch", action="store_true",
                        help="fetch each CPI's products synchronously "
                             "instead of one CPI behind (deferred fetch "
                             "waits for a CPI's products behind the next "
                             "CPI's work; default on)")
    parser.add_argument("--transport-recycle", type=int, default=0,
                        metavar="N",
                        help="every N CPIs, flush the pending CPI and drop "
                             "the retained chunks and overlap tails "
                             "(0 disables)")
    parser.add_argument("--ingest-chunks", type=int, default=None,
                        help="stream each CPI to the card in this many "
                             "blocks as capture delivers them (default: "
                             "auto)")
    parser.add_argument("--mesh", default=None, metavar="CPIxPULSE",
                        help="run the sharded pipeline on a (cpi, pulse) "
                             "mesh of logical ranks, e.g. 1x4 (one card "
                             "holds several ranks)")
    parser.add_argument("--halo-backend", default="ppermute",
                        choices=("ppermute", "pallas"),
                        help="overlap-save halo exchange in mesh mode "
                             "(pallas: the CUDA halo kernel on a card)")
    parser.add_argument("--row-shard", default="auto",
                        choices=("auto", "on", "off", "calibrate"),
                        help="mesh-mode Doppler-output layout (calibrate: "
                             "time both on the mesh and keep the faster)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-process: coordinator host:port (or "
                             "'auto' for torchrun's environment); also via "
                             "BLAH2_COORDINATOR")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-process: total process count "
                             "(BLAH2_NUM_PROCESSES)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-process: this process's index "
                             "(BLAH2_PROCESS_ID)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    from blah2_tpu_torch.device import resolve_device
    from blah2_tpu_torch.parallel import distributed

    mesh = None
    try:
        # First of all: in a job, the process's cards follow from the
        # layout that the initialisation publishes.
        multiprocess = distributed.maybe_initialize(
            args.coordinator, args.num_processes, args.process_id,
            device=args.device)
        device = resolve_device(args.device)
        if args.mesh:
            from blah2_tpu_torch.parallel.mesh import RadarMesh, rank_devices

            try:
                n_cpi, n_pulse = (int(v) for v in
                                  args.mesh.lower().split("x"))
            except ValueError:
                parser.error(f"--mesh must look like 2x4, got {args.mesh!r}")
            n_local, extra = divmod(n_cpi * n_pulse,
                                    distributed.process_count())
            if extra:
                parser.error(f"--mesh {args.mesh} does not split over "
                             f"{distributed.process_count()} processes")
            mesh = RadarMesh(n_cpi, n_pulse,
                             rank_devices(n_local, args.device))
            device = mesh.device
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    config = load_config(args.config)
    if multiprocess and distributed.process_index() != 0:
        # One API and egress owner per job: the other processes compute.
        args.no_api = True

    api_server = None
    if not args.no_api:
        from blah2_tpu_torch.net.api import ApiServer

        api_server = ApiServer(config, web_root=args.web_root)
        api_server.start(with_ingest=args.tcp_egress)
        print(f"API on http://{config.network.ip}:{config.network.api}",
              flush=True)

    runtime = RadarRuntime(config, api_server=api_server,
                           use_tcp_egress=args.tcp_egress,
                           staged_timing=args.staged_timing,
                           staged_sample_every=args.staged_sample_every,
                           ingest_chunks=args.ingest_chunks,
                           defer_fetch=not args.no_defer_fetch,
                           graph=False if args.eager else "auto",
                           recycle_every_cpis=args.transport_recycle,
                           mesh=mesh, halo_backend=args.halo_backend,
                           row_shard={"on": True, "off": False}.get(
                               args.row_shard, args.row_shard),
                           device=device)
    if runtime.sharded is not None:
        step = "CUDA graph" if runtime.sharded.graph else "eager"
        print(f"[mesh] step: {step} ({runtime.sharded.graph_reason})",
              flush=True)
    runtime.install_signal_handlers()
    runtime.start_capture()
    profiler = None
    if args.profile_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
    try:
        runtime.run(n_cpis=args.cpis, quiet=args.quiet)
    finally:
        if profiler is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            profiler.export_chrome_trace(path)
            from blah2_tpu_torch.runtime.spans import merge_into_trace

            merge_into_trace(path, runtime.spans)
        if runtime.sharded is None and runtime.defer_fetch:
            print(f"[runtime] deferred CPIs: {runtime.flushed_in_fill} "
                  f"emitted in the next fill ({runtime.flushed_waited} "
                  f"after a wait for the card), {runtime.flushed_behind} "
                  f"behind the next dispatch; stage marks lost: "
                  f"{runtime.marks_lost}", flush=True)
        runtime.stop()
        if api_server is not None:
            api_server.stop()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
