"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``host`` (``hostload.py``: what the machine did in the
window); ``checks`` comes last, each number compared with its limit.
The same numbers end standard error. Exit codes: 0 with a result; 2 without
enough CUDA cards; 3 if JAX or the JAX package was loaded; 1 on any other
failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

FORBIDDEN = {"jax", "jaxlib", "flax", "blah2_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None, device: str = "cuda", **overrides) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness, manifest, stats

    man = manifest.load()
    spec = manifest.cell(args.workload, man)
    chips = spec["workload"]["chips"]
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"benchmark: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, device=device, man=man,
                           **overrides)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    metrics = {}
    if args.trace:
        for m in spec["per_layer"]:
            mod = manifest.load_module(m["file"], "benchmark_metric")
            value = mod.read(res["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    on_card = device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": res["peak"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    summary = res["summary"]
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
        out["breakdown"] = {
            "device_ops": [[name[:160], sec] for name, (sec, _) in ops[:10]],
            "idle_gaps": summary["idle_gaps"]}
    out["card"] = card_line() if on_card else "cpu"
    out["judged"] = res["judged"]
    out["host"] = res["host"]
    print("host:", json.dumps(res["host"]), file=sys.stderr, flush=True)
    # A reading that cannot be a number (a detection no rounding explains)
    # is printed as NEVER: JSON has no infinity.
    out["checks"] = {k: {"value": min(c["value"], stats.NEVER_MS),
                         "limit": c["limit"]}
                     for k, c in res["checks"].items()}
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
