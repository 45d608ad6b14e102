"""What the run's processes did while a window ran, read at its edges, so
that a run slowed by its own waiting can be told from one on a slow machine.

  - ``process_cpu_ms``: this process's CPU time (``time.process_time``);
  - ``threads``: the CPU time of its named threads (the radar loop, the
    generator), from each thread's CPU clock;
  - ``children``: the CPU time of each child process (the API process, the
    poller), from ``/proc/<pid>/stat``;
  - ``gc``: the collector's collections in the window and their time;
  - ``cpu_mhz``: the mean of ``/proc/cpuinfo``'s clocks at the close.

A reading that the machine does not give is left out; reading never fails
a run. (The whole machine's load cannot be read on the card's machine,
whose ``/proc/stat`` and per-thread scheduler statistics read 0, so it is
not tried.)
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, Optional


def _child_ticks(pid: int) -> Optional[int]:
    """utime + stime of a process, in clock ticks."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[11]) + int(fields[12])
    except (OSError, ValueError, IndexError):
        return None


def _thread_clock(ident: int) -> Optional[int]:
    try:
        return time.pthread_getcpuclockid(ident)
    except (AttributeError, OSError):
        return None


def _clock(clock) -> Optional[float]:
    try:
        return None if clock is None else time.clock_gettime(clock)
    except OSError:
        return None


def _mhz() -> Optional[float]:
    try:
        with open("/proc/cpuinfo") as f:
            vals = [float(line.split(":")[1]) for line in f
                    if line.startswith("cpu MHz")]
        return round(sum(vals) / len(vals), 1) if vals else None
    except (OSError, ValueError):
        return None


class HostLoad:
    """``threads``: {name: Python thread ident}; ``children``: {name: pid}."""

    def __init__(self, threads: Dict[str, int], children: Dict[str, int]):
        self.clocks = {name: _thread_clock(ident)
                       for name, ident in threads.items()}
        self.children = children
        self.gc_n = 0
        self.gc_s = 0.0
        self._gc_t0 = None
        self._a = None

    def add_thread(self, name: str, ident: int) -> None:
        """A thread started after :meth:`open`: counted from now."""
        self.clocks[name] = _thread_clock(ident)
        if self._a is not None:
            self._a["threads"][name] = _clock(self.clocks[name])

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_n += 1
            self.gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def _read(self) -> dict:
        return {"t": time.perf_counter(), "cpu": time.process_time(),
                "threads": {n: _clock(c) for n, c in self.clocks.items()},
                "children": {n: _child_ticks(p)
                             for n, p in self.children.items()}}

    def open(self) -> None:
        self._a = self._read()
        gc.callbacks.append(self._gc)

    def close(self) -> dict:
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        a, b = self._a, self._read()
        secs = b["t"] - a["t"]
        tick = os.sysconf("SC_CLK_TCK")
        out = {"window_s": round(secs, 3),
               "process_cpu_ms": round((b["cpu"] - a["cpu"]) * 1e3, 3),
               "threads": {}, "children": {},
               "gc": {"collections": self.gc_n,
                      "ms": round(self.gc_s * 1e3, 3)},
               "cpu_mhz": _mhz()}
        for name, t in b["threads"].items():
            t0 = a["threads"].get(name)
            if t is not None and t0 is not None and t > t0:
                out["threads"][name] = round((t - t0) * 1e3, 3)
        for name, t in b["children"].items():
            t0 = a["children"].get(name)
            if t is not None and t0 is not None and t > t0:
                out["children"][name] = round((t - t0) / tick * 1e3, 3)
        return out
