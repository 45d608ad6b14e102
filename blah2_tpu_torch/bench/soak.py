"""Production-runtime soak: N CPIs end to end with stability monitoring
(counterpart of ``tools/soak_runtime.py``).

The reference deployment runs for days under a watchdog whose staleness
bound is 60 s (`script/blah2_rspduo_restart.bash:8-11`). This soak runs the
port's ``RadarRuntime`` as :mod:`blah2_tpu_torch.bench.runtime` builds it
(looped replay → rings → chunked packed-12 ingest → the CPI pipeline with
staged samples every 16 CPIs → tracker → JSON → API) for ``--cpis`` CPIs
after 3 warm-up ones, in windows of 10, and prints one JSON line per
window: the median and maximum ``cpi``, the window's wall, the process RSS
and the rings' drop counters.

It fails (exit code 1) when a CPI exceeds the watchdog's 60 s, the RSS of
the last window exceeds the first window's by more than 10 %, or the rings
dropped samples after the warm-up (:func:`soak_failures`).
``--recycle-every N`` runs ``RadarRuntime.recycle_transport`` every N CPIs
(a seam: the pending CPI flushed, retained chunks and overlap tails
dropped; a card attached to its host has no transport to tear down).

    python -m blah2_tpu_torch.bench.soak --cpis 60            # on the card
    python -m blah2_tpu_torch.bench.soak --device cpu --fs 200000 --cpi 0.1

Prints one JSON line per window, then the result line.
"""

from __future__ import annotations

import argparse
import gc
import tempfile
import time

from blah2_tpu_torch.bench.common import (DEFAULT_CPI, DEFAULT_FS, at,
                                          add_device_args, default_config,
                                          device_detail, device_or_exit, emit,
                                          record_scene)
from blah2_tpu_torch.bench.runtime import (STAGED_WARMUP_S, WARM_CPIS,
                                           build_runtime)

SOAK_PORT = 18799
WINDOW_CPIS = 10
#: The failure criteria: the watchdog's staleness bound, the RSS growth
#: allowed over the run, as a share of the first window's.
WATCHDOG_MS = 60_000.0
RSS_GROWTH = 0.10


def rss_mb(pid="self") -> float:
    """Resident set size in MiB of process ``pid`` (default: this one),
    from ``/proc/<pid>/status``; 0 once the process has gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def soak_failures(cpi_ms, rss_windows, drops_end) -> list:
    """What failed, as messages: a CPI over the watchdog's 60 s, the last
    window's RSS over the first's by more than 10 %, or ring drops after
    the warm-up (``tools/soak_runtime.py:122-129``)."""
    fails = []
    if max(cpi_ms) > WATCHDOG_MS:
        fails.append("watchdog: a CPI exceeded the 60 s staleness bound")
    if len(rss_windows) >= 2 and \
            rss_windows[-1] > rss_windows[0] * (1.0 + RSS_GROWTH):
        fails.append(f"rss grew {rss_windows[0]} -> {rss_windows[-1]} MB "
                     f"(>10%)")
    if any(d > 0 for d in drops_end):
        fails.append(f"ring drops after warmup: {drops_end}")
    return fails


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(ap, fs=DEFAULT_FS, cpi=DEFAULT_CPI)
    ap.add_argument("--cpis", type=int, default=60)
    ap.add_argument("--recycle-every", type=int, default=0, metavar="N",
                    help="RadarRuntime.recycle_transport every N CPIs "
                         "(0 disables)")
    ap.add_argument("--gc-every-window", action="store_true",
                    help="gc.collect() after each window (leak triage: "
                         "cycle-held buffers against native growth)")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)

    cfg0 = default_config(args.fs, args.cpi)
    budget_ms = 1e3 * cfg0.n_samples / cfg0.capture.fs
    windows = []
    with tempfile.TemporaryDirectory(prefix="bench_soak_") as tmp:
        fname = record_scene(cfg0, tmp)
        api, rt, timings = build_runtime(args.fs, args.cpi, fname, SOAK_PORT,
                                         16, True, dev)
        rt.recycle_every_cpis = max(0, args.recycle_every)
        rt._start_staged_warmup()
        rt._staged_warmup_thread.join(timeout=STAGED_WARMUP_S)

        rt.start_capture()
        t0 = time.perf_counter()
        try:
            rt.run(n_cpis=WARM_CPIS, quiet=True)
            done = WARM_CPIS
            while done < WARM_CPIS + args.cpis:
                step = min(WINDOW_CPIS, WARM_CPIS + args.cpis - done)
                t_w = time.perf_counter()
                rt.run(n_cpis=done + step, quiet=True)
                done += step
                if args.gc_every_window:
                    gc.collect()
                seg = sorted(d["cpi"] for d in timings[done - step:done])
                windows.append(emit({
                    "cpi_ms_median": at(seg, 0.5),
                    "cpi_ms_max": max(seg),
                    "wall_s": time.perf_counter() - t_w,
                    "rss_mb": rss_mb(),
                    "drops": [int(getattr(rt.buffer1, "dropped", 0)),
                              int(getattr(rt.buffer2, "dropped", 0))],
                }))
        finally:
            rt.stop()
            api.stop()
        wall_total = time.perf_counter() - t0

    cpi_ms = sorted(d["cpi"] for d in timings[WARM_CPIS:])
    rss = [w["rss_mb"] for w in windows]
    drops_end = windows[-1]["drops"] if windows else []
    median = at(cpi_ms, 0.5)
    return emit({
        "metric": "runtime_soak",
        "value": median,
        "unit": "ms/CPI median over soak",
        "vs_baseline": budget_ms / median,
        "detail": {
            "n_cpis": len(cpi_ms),
            "wall_total_s": wall_total,
            "cpi_ms_p90": at(cpi_ms, 0.9),
            "cpi_ms_max": max(cpi_ms),
            "rss_mb_first_window": rss[0] if rss else None,
            "rss_mb_last_window": rss[-1] if rss else None,
            "drops": drops_end,
            "windows": windows,
            "failures": soak_failures(cpi_ms, rss, drops_end),
            "recycle_every": rt.recycle_every_cpis,
            **device_detail(dev),
        },
    })


if __name__ == "__main__":
    raise SystemExit(1 if main()["detail"]["failures"] else 0)
