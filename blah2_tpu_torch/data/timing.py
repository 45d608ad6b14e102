"""Per-CPI stage timing product.

Parity with reference `src/data/meta/Timing.{h,cpp}`: ``update`` installs the
per-stage (name, ms) vectors and uptime; ``to_json`` flattens names into JSON
members with keys timestamp / nCpi / uptime_s / uptime_days / <stage names>
(`Timing.cpp:17-49`); JSON-array file append (`Timing.cpp:52-104`).

Stage names follow `src/blah2.cpp:261-337`: extract_buffer, spectrum,
clutter_filter, ambiguity_processing, detector, tracker, output_radar_data, cpi.
"""

from __future__ import annotations

from typing import List, Sequence

from blah2_tpu_torch.utils import jsonfmt


class Timing:
    def __init__(self, t_start_ms: int):
        self.t_start = int(t_start_ms)
        self.t_now = int(t_start_ms)
        self.n_cpi = 0
        self.uptime_ms = 0
        self.names: List[str] = []
        self.times_ms: List[float] = []

    def update(self, t_now_ms: int, times_ms: Sequence[float],
               names: Sequence[str]) -> None:
        self.n_cpi += 1
        self.t_now = int(t_now_ms)
        self.times_ms = list(times_ms)
        self.names = list(names)
        self.uptime_ms = self.t_now - self.t_start

    def to_doc(self) -> dict:
        doc = {
            "timestamp": self.t_now,
            "nCpi": self.n_cpi,
            "uptime_s": self.uptime_ms / 1000.0,
            "uptime_days": self.uptime_ms / 1000.0 / 60 / 60 / 24,
        }
        for name, t in zip(self.names, self.times_ms):
            doc[name] = float(t)
        return doc

    def to_json(self) -> str:
        return jsonfmt.dumps(self.to_doc())

    @staticmethod
    def save(json_str: str, path: str) -> bool:
        return jsonfmt.append_json_array(json_str, path)


class StageTimer:
    """Accumulates per-stage wall-clock deltas like `timing_helper`
    (`src/blah2.cpp:465-473`)."""

    def __init__(self):
        import time as _time

        self._time = _time
        self.marks_us: List[int] = []
        self.names: List[str] = []
        self.times_ms: List[float] = []

    def start(self) -> None:
        self.marks_us = [int(self._time.perf_counter() * 1e6)]
        self.names = []
        self.times_ms = []

    @property
    def t0_us(self) -> int:
        return self.marks_us[0]

    def stage(self, name: str) -> None:
        if not self.marks_us:
            self.start()
        now = int(self._time.perf_counter() * 1e6)
        self.times_ms.append((now - self.marks_us[-1]) / 1000.0)
        self.names.append(name)
        self.marks_us.append(now)

    def record(self, name: str, ms: float) -> None:
        """Install a stage time measured (or apportioned) externally; the
        mark advances by ``ms`` so subsequent ``stage()`` deltas and
        ``finish_cpi`` stay consistent."""
        if not self.marks_us:
            self.start()
        self.times_ms.append(float(ms))
        self.names.append(name)
        self.marks_us.append(self.marks_us[-1] + int(ms * 1000.0))

    def finish_cpi(self) -> float:
        """Close out the CPI: records total 'cpi' time, returns it in ms."""
        now = int(self._time.perf_counter() * 1e6)
        delta_ms = (now - self.marks_us[0]) / 1000.0
        self.names.append("cpi")
        self.times_ms.append(delta_ms)
        return delta_ms
