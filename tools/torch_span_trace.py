"""The runtime's spans on the card (``blah2_tpu_torch/runtime/spans.py``):
what they cost, whether the fused CPI's stage marks time inside its CUDA
graph, and a ``--profile-dir`` trace of upstream's default deployment
(``config/config.yml``, the RSPduo at 2 MHz and 0.75 s CPIs) under replay,
read for the shared clock and for the longest idle gaps of the card, each
named by the span the radar thread was in.

    python3 tools/torch_span_trace.py [--cpis 48] [--out span_trace]

prints one JSON line (``cost``, ``marks``, ``clock``, ``idle_gaps``) and
writes it, with the trace and the saved timing documents, under ``--out``.
``--device cpu`` runs the same at ``config/config-synthetic.yml``'s size in
seconds (no events: the cost of a span and the clock of CPU operators).

- ``cost``: ns a span (one clock read, the ring's stores, the key's sum);
  µs to record a CPI's ``begin`` event, and to read the stage marks and
  the device pair a CPI; the spans a fused CPI logs.
- ``marks``: over the fused CPIs of the run (the saved timing documents,
  rounded to 0.01 ms), the four stages' sum against ``device``, the pair
  of events around the CPI: the marks time inside the graph if the sum
  never passes ``device`` by more than 5 %.
- ``clock``: every ``cudaGraphLaunch`` of the radar thread inside a
  ``dispatch`` span, every stager ``cudaMemcpyAsync`` (its copy host to
  device) inside an ``ingest_copy`` span, each within 50 µs; the worst
  distance outside.
- ``idle_gaps``: after the first four CPIs (the capture), the ten longest
  stretches in which no kernel, copy or memset ran, in ms, with the
  innermost span of the radar thread and its CUDA call when each began,
  and the span that covers most of it; ``idle_ms_by_span``: all the
  window's idle time by the spans it overlaps; ``busy_ms_per_cpi``: the
  device's busy time over the window's CPIs, beside ``device``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SLACK_US = 50.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def cost(device: str, spans_per_cpi: float) -> dict:
    import torch

    from blah2_tpu_torch.runtime.spans import SpanLog, SpanTimer, StageMarks

    st = SpanTimer(SpanLog(4096))
    n = 200_000
    t = time.perf_counter_ns()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        t = st.span(0, t)
    span_ns = (time.perf_counter_ns() - t0) / n
    out = {"span_ns": span_ns, "spans_per_cpi": spans_per_cpi,
           "spans_us_per_cpi": span_ns * spans_per_cpi / 1e3}
    if device != "cuda":
        return out
    dev = torch.device("cuda")
    x = torch.zeros(1 << 20, device=dev)
    torch.cuda.synchronize()
    k = 2000
    marks = StageMarks(dev)
    t0 = time.perf_counter_ns()
    for _ in range(k):
        marks.begin()
    begin_us = (time.perf_counter_ns() - t0) / k / 1e3
    for i in range(len(marks.events)):
        x.mul_(1.0)
        marks.mark(i)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(k):
        marks.read()
        marks.events[0].elapsed_time(end)
    read_us = (time.perf_counter_ns() - t0) / k / 1e3
    out.update(event_record_us=begin_us, marks_read_us=read_us,
               cpi_us=out["spans_us_per_cpi"] + begin_us + read_us)
    return out


def deployment(out: str, device: str) -> str:
    """The deployment's YAML under ``out``: upstream's file (the synthetic
    one on the CPU) replaying a recorded scene, on free ports, saving its
    timing documents."""
    import yaml

    from blah2_tpu_torch.bench.common import record_scene
    from blah2_tpu_torch.config import load_config

    base = os.path.join(REPO, "config", "config.yml" if device == "cuda"
                        else "config-synthetic.yml")
    with open(base) as f:
        doc = yaml.safe_load(f)
    fname = record_scene(load_config(base), out)
    doc["capture"]["replay"] = {"state": True, "loop": True, "file": fname}
    names = ("api", "map", "detection", "track", "timestamp", "timing",
             "iqdata", "config")
    doc["network"]["ip"] = "127.0.0.1"
    doc["network"]["ports"] = dict(zip(names, free_ports(len(names))))
    save = os.path.join(out, "save")
    shutil.rmtree(save, ignore_errors=True)
    doc["save"] = {"iq": False, "map": False, "detection": False,
                   "timing": True, "path": save}
    path = os.path.join(out, "deployment.yml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


def inside(ivs, a, b):
    """How far [a, b] lies outside the nearest interval of ``ivs``, in
    µs (0 inside)."""
    return min((max(0.0, lo - a) + max(0.0, b - hi) for lo, hi in ivs),
               default=float("inf"))


def read_trace(path: str, skip_cpis: int = 4) -> dict:
    from benchmark.trace import union
    from blah2_tpu_torch.runtime.spans import TRACK_TID

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    radar = int(tracks[TRACK_TID].split()[2].rstrip(":"))
    spans = sorted((e for e in events if e.get("cat") == "span"
                    and e["tid"] == TRACK_TID), key=lambda e: e["ts"])
    by_name: dict = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(
            (e["ts"], e["ts"] + e["dur"]))
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                      and e.get("tid") == radar), key=lambda e: e["ts"])
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    copies = {e["args"].get("correlation"): e["name"] for e in device
              if e["cat"] == "gpu_memcpy"}

    def check(records, ivs):
        far = [inside(ivs, e["ts"], e["ts"] + e["dur"]) for e in records]
        return {"n": len(far),
                "outside": sum(1 for d in far if d > SLACK_US),
                "worst_us": max(far, default=0.0)}

    launches = [e for e in runtime if e["name"] == "cudaGraphLaunch"]
    h2d = [e for e in runtime if e["name"] == "cudaMemcpyAsync"
           and "HtoD" in copies.get(e["args"].get("correlation"), "")]
    clock = {"graph_launch_in_dispatch": check(
                 launches, by_name.get("dispatch", [])),
             "h2d_copy_in_ingest_copy": check(
                 h2d, by_name.get("ingest_copy", []))}

    # The device's idle gaps after the capture's CPIs.
    dispatch = by_name.get("dispatch", [])
    lo = dispatch[skip_cpis][1] if len(dispatch) > skip_cpis else 0.0
    hi = max((e["ts"] + e["dur"] for e in device), default=lo)
    busy = union(iv for iv in ((max(e["ts"], lo), min(e["ts"] + e["dur"],
                                                       hi))
                               for e in device) if iv[1] > iv[0])
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(reverse=True)

    def innermost(records, t):
        best = None
        for e in records:
            if e["ts"] > t:
                break
            if e["ts"] + e["dur"] >= t and (best is None
                                            or e["ts"] >= best["ts"]):
                best = e
        return best

    def overlap(t, d):
        """The gap [t, t + d]'s µs in each span name of the radar track
        (the rest "no span")."""
        out = {}
        for e in spans:
            a, b = max(e["ts"], t), min(e["ts"] + e["dur"], t + d)
            if b > a:
                out[e["name"]] = out.get(e["name"], 0.0) + b - a
        out["no span"] = d - sum(out.values())
        return out

    named = []
    for d, t in gaps[:10]:
        s = innermost(spans, t)
        c = innermost(runtime, t)
        share = overlap(t, d)
        most = max(share, key=share.get)
        named.append({"ms": d / 1e3,
                      "span_at_start": s["name"] if s else "no span",
                      "cpi": s["args"]["cpi"] if s else None,
                      "cuda_call": c["name"] if c else None,
                      "most_in": most, "most_share": share[most] / d})
    window = (hi - lo) / 1e3
    idle = sum(d for d, _ in gaps) / 1e3
    by_span: dict = {}
    for d, t in gaps:
        for name, us in overlap(t, d).items():
            by_span[name] = by_span.get(name, 0.0) + us / 1e3
    n_cpis = sum(1 for a, _ in dispatch if a >= lo)
    return {"clock": clock, "window_ms": window,
            "idle_share": idle / window if window > 0 else None,
            "busy_ms_per_cpi": (window - idle) / n_cpis if n_cpis else None,
            "idle_ms_by_span": dict(sorted(by_span.items(),
                                           key=lambda kv: -kv[1])),
            "idle_gaps": named,
            "spans": {k: len(v) for k, v in by_name.items()}}


def marks(save_dir: str) -> dict:
    docs = []
    for name in sorted(os.listdir(save_dir)):
        if name.endswith(".timing"):
            with open(os.path.join(save_dir, name)) as f:
                docs += json.load(f)
    stages = ("spectrum", "clutter_filter", "ambiguity_processing",
              "detector")
    fused = [d for d in docs[4:] if d.get("dispatch", 0.0) > 0.0]
    ratio = [sum(d[k] for k in stages) / d["device"] for d in fused
             if d["device"] > 0]

    def med(key):
        return statistics.median(d[key] for d in fused) if fused else None

    keys = stages + ("wire_transfer", "device", "dispatch", "fetch_wait",
                     "deferral", "ring_wait", "ring_pop", "ingest_cast",
                     "ingest_pack", "ingest_copy", "serialize", "publish",
                     "output_radar_data", "cpi", "latency")
    return {"fused_cpis": len(fused),
            "stage_sum_over_device": {
                "min": min(ratio, default=None),
                "median": statistics.median(ratio) if ratio else None,
                "max": max(ratio, default=None),
                "above_1.05": sum(1 for r in ratio if r > 1.05)},
            "median_ms": {k: med(k) for k in keys}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cpis", type=int, default=48)
    ap.add_argument("--out", default=os.path.join(REPO, "span_trace"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    yml = deployment(args.out, args.device)
    cmd = [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", "--config",
           yml, "--cpis", str(args.cpis), "--quiet", "--profile-dir",
           args.out]
    if args.device == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    if run.returncode != 0:
        print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
        return 1
    result = {"cli_s": time.perf_counter() - t0}
    trace = read_trace(os.path.join(args.out, "trace.json"))
    result.update(marks=marks(os.path.join(args.out, "save")),
                  **trace)
    fused_spans = sum(trace["spans"].values()) / max(1, args.cpis)
    result["cost"] = cost(args.device, fused_spans)
    if args.device == "cuda":
        import subprocess as sp

        result["card"] = sp.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    line = json.dumps(result)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
