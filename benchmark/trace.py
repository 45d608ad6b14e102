"""The traced run's device window: ``torch.profiler`` over the whole
measured window, opened and closed by marker bursts (the idea of the
smoke's ``profile_window``: the tracer has dropped records at a window's
edges, so each edge is a burst of spin kernels that nothing else launches,
waited for, and left out of every count).

From the trace: the window's length on the device (the end of the opening
burst to the start of the closing one), the union of its kernels, copies
and memsets (busy time), each kernel's time and count by name, and the
longest idle gaps with the CUDA call the host was in when each began.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List

MARKER_CYCLES = 4_000_000
MARKER_LAUNCHES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def markers() -> None:
    """One burst of spin kernels on the current stream, waited for."""
    import torch

    for _ in range(MARKER_LAUNCHES):
        torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()


def union(intervals) -> List[tuple]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


class Window:
    """The device trace of a whole measured window. ``open()`` starts the
    profiler during set-up: importing and starting it holds the interpreter
    for long enough (up to a second seen) to overflow an open loop's rings,
    so nothing of it may fall inside the window. ``close()`` stops it after
    the window; ``summary()`` reads the trace then."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        # Device activity only: recording the host's operators too slowed
        # the runtime's host path two- to threefold. The CUDA runtime's
        # calls are still in the trace and name the idle gaps.
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.is_open = False

    def open(self) -> None:
        markers()  # the spin kernel loaded before the trace starts
        self._prof.__enter__()
        self.is_open = True
        markers()

    def close(self) -> None:
        if not self.is_open:
            return
        self.is_open = False
        try:
            markers()
        finally:
            self._prof.__exit__(None, None, None)

    def summary(self) -> Dict:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        return summarize(events)


def summarize(events) -> Dict:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    marks = sorted((e for e in dev if "spin_kernel" in e["name"]),
                   key=lambda e: e["ts"])
    own = [e for e in dev if "spin_kernel" not in e["name"]]
    if len(marks) < 2 * MARKER_LAUNCHES:
        # An edge lost its markers: fall back to the device records' span.
        lo = min((e["ts"] for e in own), default=0.0)
        hi = max((e["ts"] + e["dur"] for e in own), default=0.0)
    else:
        lo = marks[MARKER_LAUNCHES - 1]["ts"] + marks[MARKER_LAUNCHES - 1][
            "dur"]
        hi = marks[-MARKER_LAUNCHES]["ts"]
    spans = []
    by_name: Dict[str, list] = {}
    for e in own:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        spans.append((a, b))
        tot = by_name.setdefault(e["name"], [0.0, 0])
        tot[0] += e["dur"]
        tot[1] += 1
    busy = union(spans)
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {k: (v[0] / 1e6, v[1]) for k, v in by_name.items()},
        "idle_gaps": [[_host_at(host, t0), d / 1e6] for d, t0 in gaps[:10]],
    }


def _host_at(host, t: float) -> str:
    """The innermost host event running at ``t`` (us), by name."""
    best = None
    for e in host:
        if e["ts"] > t:
            break
        if e["ts"] + e.get("dur", 0) >= t and (
                best is None or e["ts"] >= best["ts"]):
            best = e
    return (f"host: {best['name'][:80]}" if best
            else "host: Python, no CUDA call running")
