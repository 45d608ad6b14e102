"""Benchmark: the production runtime end to end on one card (counterpart of
``bench_runtime.py``).

It runs the port's ``RadarRuntime`` (``runtime/radar.py``): looped,
unpaced replay → rings → chunked packed-12 ingest through pinned memory on
a copy stream → the CPI pipeline (the detect kernel on a card) → tracker →
JSON → an in-process ``ApiServer``, at the default config (fs 2 MHz, tCpi
0.75 s) on ``bench_runtime.py``'s recorded two-CPI scene, with its tracker
settings. The timing product is captured by wrapping ``_emit``.

Scored quantity: the timing product's ``cpi`` key (extraction → all
products emitted), the 25th percentile over the measured CPIs after the
warm-up ones, against the reference's real-time criterion
(`src/blah2.cpp:334-338`: under tCpi·1000 = 750 ms). Staged samples
(``--staged-sample-every``, default 16) are live once the runtime's own
staged warm-up thread has finished; the bench waits for it before it
measures.

``--wire ab`` decides the wire format with data: a packed-12 and an int16
runtime side by side on the card, in alternating windows with the order
of the arms alternating round to round; the decision is the median over
rounds of the paired window-mean delta, with a 2 % tie band that keeps
packed-12 (25 % fewer bytes).

What ``bench_runtime.py`` does for a TPU has no counterpart: the persistent
compile cache and the long wait for a cold one (eager PyTorch compiles
nothing; the staged warm-up builds cuFFT plans and the cuSOLVER handle in
seconds).

vs_baseline = tCpi·1000 / score (×1.0 = exactly real time; >1 = faster).

    python -m blah2_tpu_torch.bench.runtime                  # on the card
    python -m blah2_tpu_torch.bench.runtime --device cpu --fs 200000 --cpi 0.1
    python -m blah2_tpu_torch.bench.runtime --wire ab

Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import tempfile
import time

import numpy as np

from blah2_tpu_torch.bench.common import (DEFAULT_CPI, DEFAULT_FS, at,
                                          add_device_args, default_config,
                                          device_detail, device_or_exit, emit,
                                          record_scene)
from blah2_tpu_torch.net.api import ApiServer
from blah2_tpu_torch.runtime.radar import RadarRuntime

#: API ports of the single run and of the wire decision's two arms.
SINGLE_PORT = 18765
ARM_PORTS = {"packed12": 18766, "int16": 18767}
#: CPIs run before the scored ones.
WARM_CPIS = 3
#: Longest wait for the staged warm-up thread before measuring anyway.
STAGED_WARMUP_S = 300.0
#: The wire decision's tie band, a share of the faster arm's median window.
TIE_BAND = 0.02
STAGE_KEYS = ("extract_buffer", "wire_transfer", "spectrum",
              "clutter_filter", "ambiguity_processing", "detector",
              "tracker", "output_radar_data")


def build_runtime(fs, cpi, fname, api_port, staged_every, enable_pack12,
                  device):
    """``bench_runtime.py:72-105``: the runtime on a looped replay of
    ``fname`` with the tracker on (M/N 3 of 5, max acceleration 2, delete
    after 8), publishing into an in-process API on ``api_port``. Returns
    (api, runtime, the parsed timing products as they are emitted)."""
    cfg = default_config(fs, cpi)
    cfg.process.tracker.enable = True
    cfg.process.tracker.m, cfg.process.tracker.n = 3, 5
    cfg.process.tracker.max_acc = 2.0
    cfg.process.tracker.n_delete = 8
    cfg.capture.replay.state = True
    cfg.capture.replay.loop = True
    cfg.capture.replay.file = fname
    cfg.network.api = api_port

    api = ApiServer(cfg)
    api.start(with_ingest=False)
    rt = RadarRuntime(cfg, api_server=api, staged_sample_every=staged_every,
                      enable_pack12=enable_pack12, device=device)
    timings = []
    orig = rt._emit

    def capture(product, payload, parsed=None):
        if product == "timing":
            timings.append(json.loads(payload))
        return orig(product, payload, parsed=parsed)

    rt._emit = capture
    return api, rt, timings


def _run_single(fs, cpi, device, staged_every, n_meas) -> dict:
    cfg0 = default_config(fs, cpi)
    n = cfg0.n_samples
    budget_ms = 1e3 * n / cfg0.capture.fs
    with tempfile.TemporaryDirectory(prefix="bench_runtime_") as tmp:
        fname = record_scene(cfg0, tmp)
        api, rt, timings = build_runtime(fs, cpi, fname, SINGLE_PORT,
                                         staged_every, True, device)
        staged_live = warmup_overlapped = False
        if staged_every > 0:
            # The staged stages warm up on the runtime's own thread; measure
            # once they are warm, so no sample times a first call.
            rt._start_staged_warmup()
            t = rt._staged_warmup_thread
            t.join(timeout=STAGED_WARMUP_S)
            warmup_overlapped = t.is_alive()
            staged_live = (not warmup_overlapped and
                           rt._staged_ready.is_set() and
                           rt._staged_warmed_dtype ==
                           rt._staged_input_dtype())
            if not staged_live:
                rt.staged_sample_every = 0  # keep the stream clean

        rt.start_capture()
        t0 = time.perf_counter()
        try:
            rt.run(n_cpis=WARM_CPIS + n_meas, quiet=True)
        finally:
            rt.stop()
            api.stop()
        wall_total = time.perf_counter() - t0

    steady = timings[WARM_CPIS:]
    cpi_ms = sorted(d["cpi"] for d in steady)
    latency_ms = sorted(d["latency"] for d in steady)
    score = at(cpi_ms, 0.25)

    # Staged-sampling overhead: sample CPIs (index % every == 0, counted
    # from CPI 0) against the median fused CPI.
    overhead_pct = None
    if staged_live:
        every = staged_every
        sample_ms = [timings[i]["cpi"]
                     for i in range(WARM_CPIS, WARM_CPIS + len(steady))
                     if i % every == 0 and i < len(timings)]
        fused_ms = [d["cpi"] for i, d in enumerate(timings)
                    if i >= WARM_CPIS and (i % every)]
        if sample_ms and fused_ms:
            med = statistics.median(fused_ms)
            extra = sum(max(0.0, s - med) for s in sample_ms)
            overhead_pct = 100.0 * extra / (1e3 * wall_total)

    return {
        "metric": "runtime_e2e_cpi_wall",
        "value": score,
        "unit": "ms/CPI",
        "vs_baseline": budget_ms / score,
        "detail": {
            "n_samples_per_cpi": n,
            "realtime_budget_ms": budget_ms,
            "cpi_ms_p25": score,
            "cpi_ms_median": at(cpi_ms, 0.5),
            "cpi_ms_p90": at(cpi_ms, 0.9),
            "latency_ms_median": at(latency_ms, 0.5),
            "latency_ms_p90": at(latency_ms, 0.9),
            "stage_means_ms": {
                k: float(np.mean([d.get(k, 0.0) for d in steady]))
                for k in STAGE_KEYS},
            "staged_timing_live": staged_live,
            "staged_sample_every": rt.staged_sample_every,
            "staged_overhead_pct_wall": overhead_pct,
            "staged_warmup_overlapped_measurement": warmup_overlapped,
            "n_cpis_measured": len(steady),
            "wall_total_s": wall_total,
            "ingest_chunks": rt.ingest_chunks,
            **device_detail(rt.device),
        },
    }


def wire_decision(packed12_windows, int16_windows,
                  tie_band: float = TIE_BAND) -> dict:
    """The wire format from the two arms' window means (ms), paired round
    by round (``bench_runtime.py:248-282``): the median of the rounds'
    int16 − packed12 deltas, against a tie band of ``tie_band`` times the
    faster arm's median window. A tie keeps packed-12, which moves 6 bytes
    a sample to int16's 8."""
    deltas = [i16 - p12 for p12, i16 in zip(packed12_windows,
                                            int16_windows)]
    ordered = sorted(deltas)
    med = float(np.median(deltas))
    band = tie_band * min(float(np.median(packed12_windows)),
                          float(np.median(int16_windows)))
    if abs(med) <= band:
        winner, why = "packed12", (
            f"tie: |median paired delta| {abs(med):.1f} ms <= {band:.1f} ms "
            "band; packed12 keeps the default on wire bytes (6 B/sample "
            "vs 8)")
    elif med > 0:
        winner = "packed12"
        why = f"packed12 faster by {med:.1f} ms median paired delta"
    else:
        winner = "int16"
        why = f"int16 faster by {-med:.1f} ms median paired delta"
    return {
        "per_round": deltas,
        "median": med,
        "iqr": [ordered[len(deltas) // 4], ordered[(3 * len(deltas)) // 4]],
        "n_rounds_packed12_faster": sum(1 for d in deltas if d > 0),
        "tie_band_ms": band,
        "winner": winner,
        "decision": why,
    }


def _run_wire_ab(fs, cpi, device, rounds, per_window) -> dict:
    """Packed-12 and int16 runtimes side by side, ``rounds`` rounds of
    ``per_window`` CPIs per arm, the arms alternating within each round and
    the order alternating round to round (``bench_runtime.py:205-317``)."""
    cfg0 = default_config(fs, cpi)
    n = cfg0.n_samples
    budget_ms = 1e3 * n / cfg0.capture.fs
    arms = {}
    with tempfile.TemporaryDirectory(prefix="bench_runtime_") as tmp:
        fname = record_scene(cfg0, tmp)
        try:
            for name, port in ARM_PORTS.items():
                api, rt, timings = build_runtime(
                    fs, cpi, fname, port, 0, name == "packed12", device)
                arms[name] = dict(api=api, rt=rt, timings=timings,
                                  windows=[])
                rt.start_capture()

            for a in arms.values():
                a["rt"].run(n_cpis=a["rt"].n_cpis_done + WARM_CPIS,
                            quiet=True)
            for a in arms.values():
                a["n_warm_end"] = len(a["timings"])

            t0 = time.perf_counter()
            for r in range(rounds):
                order = list(arms.values())
                if r % 2:
                    order.reverse()
                for a in order:
                    start = len(a["timings"])
                    a["rt"].run(n_cpis=a["rt"].n_cpis_done + per_window,
                                quiet=True)
                    win = [d["cpi"] for d in a["timings"][start:]]
                    a["windows"].append(float(np.mean(win)) if win
                                        else float("nan"))
            wall_total = time.perf_counter() - t0
        finally:
            for a in arms.values():
                a["rt"].stop()
                a["api"].stop()

    out = {}
    for name, a in arms.items():
        steady = sorted(d["cpi"] for d in a["timings"][a["n_warm_end"]:])
        out[name] = {
            "cpi_ms_p25": at(steady, 0.25),
            "cpi_ms_median": at(steady, 0.5),
            "window_means_ms": a["windows"],
            "n_cpis": len(steady),
        }
    decision = wire_decision(arms["packed12"]["windows"],
                             arms["int16"]["windows"])
    winner = decision.pop("winner")
    why = decision.pop("decision")
    shipped = "packed12" if inspect.signature(RadarRuntime.__init__) \
        .parameters["enable_pack12"].default else "int16"
    score = out[winner]["cpi_ms_median"]
    return {
        "metric": "runtime_wire_format_ab",
        "value": score,
        "unit": "ms/CPI",
        "vs_baseline": budget_ms / score,
        "detail": {
            "protocol": f"paired: {rounds} rounds x {per_window} CPIs per "
                        "arm, arms interleaved within each round, round "
                        "order alternating; decision = median paired "
                        "per-round delta with 2% tie band",
            "arms": out,
            "paired_delta_int16_minus_packed12_ms": decision,
            "winner": winner,
            "decision": why,
            "shipped_default": shipped,
            "shipped_default_agrees": shipped == winner,
            "wall_total_s": wall_total,
            **device_detail(arms["packed12"]["rt"].device),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(ap, fs=DEFAULT_FS, cpi=DEFAULT_CPI)
    ap.add_argument("--wire", choices=("packed", "ab"), default="packed",
                    help="packed: production default; ab: interleaved "
                         "packed-12 vs int16 decision run")
    ap.add_argument("--staged-sample-every", type=int, default=16)
    ap.add_argument("--measured-cpis", type=int, default=21,
                    help="CPIs scored (default 21)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="--wire ab: rounds (default 10)")
    ap.add_argument("--per-window", type=int, default=3,
                    help="--wire ab: CPIs per arm a round (default 3)")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    if args.wire == "ab":
        result = _run_wire_ab(args.fs, args.cpi, dev, args.rounds,
                              args.per_window)
    else:
        result = _run_single(args.fs, args.cpi, dev,
                             args.staged_sample_every, args.measured_cpis)
    return emit(result)


if __name__ == "__main__":
    main()
