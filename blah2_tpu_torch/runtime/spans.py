"""Spans of the radar runtime: each phase of a CPI as an interval with a
start and an end, summed per CPI into the timing product's keys and kept
in a bounded ring that ``runtime/cli.py --profile-dir`` merges into the
``torch.profiler`` trace.

A span is two reads of the host's monotonic clock
(``time.perf_counter_ns``). :class:`SpanLog` keeps the last spans in
preallocated lists written round (the log never grows) with one anchor
of that clock against unix time (``time.time_ns``), taken when the log is
made; :meth:`SpanLog.trace_events` converts through it to the clock of the
profiler's Chrome trace, which is unix time (``baseTimeNanoseconds`` plus
``ts`` in µs). With no profiler running the log is only written.

:class:`SpanTimer` is the runtime's ``StageTimer`` (``data/timing.py``)
with spans: ``span(key, t0)`` logs ``[t0, now]``, adds it to the CPI's sum
of ``key`` and returns ``now``, the next span's start, so a chain of
phases reads the clock once each. The eleven sums (:data:`KEYS`) go into
every timing document, 0.0 where a path has no such phase. ``apart()``
keeps a stretch that belongs to another CPI (the flush of a deferred CPI
inside a staged sample) out of ``finish_cpi``'s ``cpi``.

:class:`StageMarks` marks the start of a fused CPI's body and the stage
boundaries of ``CpiPipeline.forward``: on a card timing CUDA events made
``external``, so that a capture turns their records into event-record
nodes of the CPI's CUDA graph and each replay re-records them; on the CPU
host stamps, the eager call being synchronous there. They are read without
a wait, or not at all (see the class).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List, Optional

import torch

from blah2_tpu_torch.data.timing import StageTimer

#: The timing product's span keys, in ms, on every document.
KEYS = ("ring_wait", "ring_pop", "ingest_cast", "ingest_pack",
        "ingest_copy", "dispatch", "deferral", "fetch_wait", "device",
        "serialize", "publish")
(RING_WAIT, RING_POP, INGEST_CAST, INGEST_PACK, INGEST_COPY, DISPATCH,
 DEFERRAL, FETCH_WAIT, DEVICE, SERIALIZE, PUBLISH) = range(len(KEYS))
#: Spans of the timeline that are no key of their own: the tracker (the
#: reference's ``tracker`` key times it already) and a staged sample's
#: stages (its stage keys time them).
TRACKER, STAGED = len(KEYS), len(KEYS) + 1
NAMES = KEYS + ("tracker", "staged")

#: The device stages that :class:`StageMarks` bound, in order (the
#: reference's names, `src/blah2.cpp:261-337`).
STAGES = ("spectrum", "clutter_filter", "ambiguity_processing", "detector")

#: Tracks of the exported spans: the radar loop's phases nest, a CPI's
#: deferral overlaps the next CPI's, so deferrals get a track of their own.
#: Their thread ids lie above any Linux thread id (at most 2**22).
TRACK_TID = 1 << 30
DEFERRAL_TID = (1 << 30) + (1 << 23)


def clock_anchor(tries: int = 5) -> tuple:
    """(``perf_counter_ns``, ``time_ns``) read as close together as the
    tightest of ``tries`` bracketed reads."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, unix)
    return best[1], best[2]


class SpanLog:
    """The last ``capacity`` spans: name index (:data:`NAMES`) and CPI in
    one code (``name | cpi << 8``), start and end on ``perf_counter_ns``,
    in three preallocated lists written round. ``thread``: the native id
    of the thread that logs (the radar loop's), set by the loop."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.code = [0] * self.capacity
        self.start = [0] * self.capacity
        self.end = [0] * self.capacity
        self.n = 0
        self.anchor = clock_anchor()
        self.thread: Optional[int] = None

    def add(self, name: int, cpi: int, t0: int, t1: int) -> None:
        i = self.n % self.capacity
        self.code[i] = name | cpi << 8
        self.start[i] = t0
        self.end[i] = t1
        self.n += 1

    def spans(self) -> List[tuple]:
        """The kept spans, oldest first, as (name, CPI, start, end) with
        start and end in unix ns."""
        k = min(self.n, self.capacity)
        perf0, unix0 = self.anchor
        out = []
        for j in range(self.n - k, self.n):
            i = j % self.capacity
            out.append((NAMES[self.code[i] & 0xFF], self.code[i] >> 8,
                        self.start[i] - perf0 + unix0,
                        self.end[i] - perf0 + unix0))
        return out

    def trace_events(self, base_ns: int = 0, pid: Optional[int] = None
                     ) -> List[dict]:
        """The kept spans as Chrome trace complete events (``"ph": "X"``,
        ``cat`` "span", ``ts`` and ``dur`` in µs after ``base_ns``) on two
        tracks named for the radar thread, with their names."""
        pid = os.getpid() if pid is None else pid
        who = f"radar thread {self.thread}" if self.thread else "radar"
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "ts": 0, "args": {"name": f"{who}: {what}"}}
               for tid, what in ((TRACK_TID, "spans"),
                                 (DEFERRAL_TID, "deferral"))]
        for name, cpi, t0, t1 in self.spans():
            out.append({
                "ph": "X", "cat": "span", "name": name, "pid": pid,
                "tid": DEFERRAL_TID if name == "deferral" else TRACK_TID,
                "ts": (t0 - base_ns) / 1e3, "dur": (t1 - t0) / 1e3,
                "args": {"cpi": cpi}})
        return out


def merge_into_trace(path: str, log: SpanLog) -> int:
    """Add ``log``'s spans to the Chrome trace at ``path`` (as
    ``torch.profiler`` exports it), on its clock; returns how many."""
    with open(path) as f:
        doc = json.load(f)
    events = log.trace_events(int(doc.get("baseTimeNanoseconds", 0)))
    doc.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events) - 2


class SpanTimer(StageTimer):
    """A CPI's ``StageTimer`` with spans logged to ``log`` under CPI
    ``cpi`` and summed per key (:data:`KEYS`) in ``ns``."""

    def __init__(self, log: Optional[SpanLog] = None, cpi: int = 0):
        super().__init__()
        self.log = log
        self.cpi = cpi
        self.ns = [0] * len(KEYS)
        self._apart_us = 0

    def span(self, key: int, t0: int) -> int:
        """Log ``[t0, now]`` as span ``key`` (a :data:`NAMES` index), add
        it to the key's sum, and return ``now``."""
        t1 = time.perf_counter_ns()
        if key < len(KEYS):
            self.ns[key] += t1 - t0
        if self.log is not None:
            self.log.add(key, self.cpi, t0, t1)
        return t1

    def set_ms(self, key: int, ms: float) -> None:
        """Install a key's value measured elsewhere (the device's events)."""
        self.ns[key] = int(round(ms * 1e6))

    def take(self) -> List[int]:
        """The span sums so far, in ns; the timer's start from zero."""
        ns, self.ns = self.ns, [0] * len(KEYS)
        return ns

    def start(self) -> None:
        super().start()
        self._apart_us = 0

    @contextlib.contextmanager
    def apart(self):
        """Keep the wall inside the block out of :meth:`finish_cpi`."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._apart_us += (time.perf_counter_ns() - t0) // 1000

    def finish_cpi(self) -> float:
        now = int(self._time.perf_counter() * 1e6)
        delta_ms = (now - self.marks_us[0] - self._apart_us) / 1000.0
        self.names.append("cpi")
        self.times_ms.append(delta_ms)
        return delta_ms


class StageMarks:
    """Marks in a fused CPI's body: at its start (before the wire decode)
    and at the five stage boundaries of ``CpiPipeline.forward`` (before
    the spectrum, after it, the clutter filter, the ambiguity map and the
    detection). On a card each is a timing CUDA event made ``external``:
    recorded under a capture it is an event-record node of the graph,
    re-recorded by every replay. On the CPU each is a host stamp.

    So a CPI's marks can be read only between the end of its work on the
    card and the next CPI's call: :meth:`read` never waits, and the runtime
    reads them just before that call, or loses them where the CPI is still
    running then. The ``device`` time of a CPI whose marks were lost starts
    at :meth:`begin`'s event instead."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.events = [torch.cuda.Event(enable_timing=True,
                                             external=True)
                           for _ in range(len(STAGES) + 2)]
            self._begins = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
        self._n_begins = 0
        self.stamps = [0] * (len(STAGES) + 2)

    def mark(self, i: int) -> None:
        if self.on_card:
            self.events[i].record()
        else:
            self.stamps[i] = time.perf_counter_ns()

    def begin(self) -> Optional["torch.cuda.Event"]:
        """On a card, a timing event recorded on the current stream now,
        before a CPI's call: where the stream is still busy with the CPI
        before, it completes as that work ends, and the CPI's body starts
        behind it. Two are taken in turn, as a CPI's is read before the
        next CPI's call but one. None on the CPU."""
        if not self.on_card:
            return None
        ev = self._begins[self._n_begins % 2]
        self._n_begins += 1
        ev.record()
        return ev

    def read(self, end: Optional["torch.cuda.Event"] = None
             ) -> Optional[tuple]:
        """(each stage's time, the time from the body's start to ``end``),
        in ms, from the last recorded marks; ``end`` is a timing event
        recorded after them (the fetch's; the last mark where there is
        none). None while ``end`` has not completed on the card: this never
        waits. On the CPU the second is None: the eager call is
        synchronous, and the host's clock times it."""
        n = len(STAGES)
        if not self.on_card:
            s = self.stamps
            return [(s[i + 1] - s[i]) / 1e6 for i in range(1, n + 1)], None
        ev = self.events
        last = ev[-1] if end is None else end
        if not last.query():
            return None
        stages = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, n + 1)]
        return stages, None if end is None else ev[0].elapsed_time(end)
