"""Track store for the M-of-N delay-Doppler tracker.

Parity with reference `src/data/Track.{h,cpp}`:
  - 4-hex-digit uppercase track IDs wrapping at 65535 (`Track.cpp:13,31-36,97`)
  - states {TENTATIVE, ASSOCIATED, ACTIVE, COASTING} with full per-track state
    history (`Track.h:4-10`)
  - ``promote``: M-of-N over the last N states counting ACTIVE/ASSOCIATED
    (`Track.cpp:115-135`)
  - ``to_json`` hides TENTATIVE tracks and emits id/state/delay/doppler/
    acceleration/n/associated_* plus global state counts (`Track.cpp:172-236`)
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from blah2_tpu_torch.utils import jsonfmt

MAX_INDEX = 65535


class TrackState:
    TENTATIVE = "TENTATIVE"
    ASSOCIATED = "ASSOCIATED"
    ACTIVE = "ACTIVE"
    COASTING = "COASTING"


@dataclasses.dataclass
class TrackRecord:
    id: str
    states: List[str]
    # current kinematic point: (delay bins, doppler Hz, snr dB)
    current: Tuple[float, float, float]
    acceleration: float
    associated: List[Tuple[float, float, float]]
    n_inactive: int = 0
    # Pre-rounded (2-dp, wire format) association history, maintained
    # incrementally so per-CPI serialization is O(new points), not a
    # recursive conversion over the whole history.
    assoc_delay: List[float] = dataclasses.field(default_factory=list)
    assoc_doppler: List[float] = dataclasses.field(default_factory=list)
    # Kalman smoothing state (tracker.smooth: kalman): 3x3 covariance,
    # lazily initialized on the first associated update; not serialized.
    kf_p: object = None

    @property
    def state(self) -> str:
        return self.states[-1]

    def associate(self, point: Tuple[float, float, float]) -> None:
        """Record an associated detection (updates the rounded cache)."""
        self.current = point
        self.associated.append(point)
        self.assoc_delay.append(round(float(point[0]), 2))
        self.assoc_doppler.append(round(float(point[1]), 2))


class TrackStore:
    def __init__(self):
        self.tracks: List[TrackRecord] = []
        self._i_next = 0

    def __len__(self) -> int:
        return len(self.tracks)

    @staticmethod
    def _uint2hex(number: int) -> str:
        return f"{number:04X}"

    def add(self, detection: Tuple[float, float, float]) -> TrackRecord:
        rec = TrackRecord(
            id=self._uint2hex(self._i_next),
            states=[TrackState.TENTATIVE],
            current=detection,
            acceleration=0.0,
            associated=[detection],
            assoc_delay=[round(float(detection[0]), 2)],
            assoc_doppler=[round(float(detection[1]), 2)],
        )
        self.tracks.append(rec)
        self._i_next += 1
        if self._i_next >= MAX_INDEX:
            self._i_next = 0
        return rec

    def remove(self, rec: TrackRecord) -> None:
        self.tracks.remove(rec)

    def promote(self, rec: TrackRecord, m: int, n: int) -> None:
        """Promote to ACTIVE when ≥ m of the last n states are hits."""
        if len(rec.states) >= n:
            hits = sum(
                1
                for s in rec.states[-n:]
                if s in (TrackState.ACTIVE, TrackState.ASSOCIATED)
            )
            if hits >= m:
                rec.states[-1] = TrackState.ACTIVE

    def count_state(self, state: str) -> int:
        return sum(1 for t in self.tracks if t.state == state)

    def to_json(self, timestamp_ms: int) -> str:
        import json

        data = []
        for t in self.tracks:
            if t.state == TrackState.TENTATIVE:
                continue
            data.append(
                {
                    "id": t.id,
                    "state": t.state,
                    "delay": jsonfmt.round2(float(t.current[0])),
                    "doppler": jsonfmt.round2(float(t.current[1])),
                    "acceleration": jsonfmt.round2(float(t.acceleration)),
                    "n": len(t.associated),
                    # pre-rounded caches: no per-CPI re-conversion of the
                    # full history (the reference pays this in rapidjson)
                    "associated_delay": t.assoc_delay,
                    "associated_doppler": t.assoc_doppler,
                    "associated_state": t.states[: len(t.associated)],
                }
            )
        doc = {
            "timestamp": int(timestamp_ms),
            "n": len(self.tracks),
            "nTentative": self.count_state(TrackState.TENTATIVE),
            "nAssociated": self.count_state(TrackState.ASSOCIATED),
            "nActive": self.count_state(TrackState.ACTIVE),
            "nCoasting": self.count_state(TrackState.COASTING),
            "data": data,
        }
        return json.dumps(doc, separators=(",", ":"))
