"""Upstream blah2's M-of-N delay-Doppler tracker (`Tracker.cpp`,
`Track.cpp`), written plainly, with ``smooth: none``.

Each CPI: every track, in creation order, predicts its delay by
``(f t lambda + a t^2 / 2) / (c / fs)`` bins and its Doppler by ``a t`` and
takes the first unused detection within 1 bin and ``1 / cpi`` Hz of the
prediction; on a hit it moves there, re-estimates its acceleration as the
Doppler change over ``t``, and becomes ACTIVE once ``M`` of its last ``N``
states are hits; on a miss it coasts to the prediction (ACTIVE to COASTING,
ASSOCIATED to TENTATIVE) and goes after ``delete`` misses in a row. Each
unused detection then starts one TENTATIVE track per acceleration on the
grid ``+-maxAcc`` at ``1 / cpi^2``. ``t`` is the time between the CPIs'
timestamps; the gate is the prediction's, not upstream's uninitialised one
(a bug the port does not copy).

``q`` rounds every number the tracker stores (positions, predictions,
accelerations): the identity for the reference, a rounding to bfloat16 for
the control.
"""

from __future__ import annotations

from typing import Callable, List

TENTATIVE, ASSOCIATED, ACTIVE, COASTING = (
    "TENTATIVE", "ASSOCIATED", "ACTIVE", "COASTING")


def identity(v: float) -> float:
    return v


class Track:
    def __init__(self, point, acceleration: float):
        self.states = [TENTATIVE]
        self.current = point
        self.acceleration = acceleration
        self.associated = [point]     # every detection it took, the first too
        self.n_inactive = 0

    @property
    def n_associated(self) -> int:
        return len(self.associated)


class MofN:
    def __init__(self, m: int, n: int, n_delete: int, cpi: float,
                 max_acc: float, range_res: float, wavelength: float,
                 q: Callable[[float], float] = identity):
        self.m, self.n, self.n_delete, self.q = m, n, n_delete, q
        self.cpi, self.range_res, self.wavelength = cpi, range_res, wavelength
        res_acc = 1.0 / (cpi * cpi)
        k = int(max_acc / res_acc)
        self.acc_init = [q(res_acc * (i - k)) for i in range(2 * k + 1)]
        self.tracks: List[Track] = []
        self.timestamp_ms = None

    def process(self, detections, timestamp_ms: int) -> None:
        """One CPI's detections, each (delay bins, Doppler Hz, SNR dB)."""
        q = self.q
        detections = [(q(d), q(f), s) for d, f, s in detections]
        used = [False] * len(detections)
        if self.tracks:
            t = (timestamp_ms - self.timestamp_ms) / 1000.0
            self.timestamp_ms = timestamp_ms
            gone = []
            for trk in self.tracks:
                d, f = trk.current[0], trk.current[1]
                a = trk.acceleration
                pd = q(d + (f * t * self.wavelength + 0.5 * a * t * t)
                       / self.range_res)
                pf = q(f + a * t)
                hit = next((j for j, det in enumerate(detections)
                            if not used[j] and abs(det[0] - pd) < 1.0
                            and abs(det[1] - pf) < 1.0 / self.cpi), None)
                if hit is not None:
                    det = detections[hit]
                    trk.current = tuple(det)
                    trk.associated.append(trk.current)
                    if t > 0:
                        trk.acceleration = q((det[1] - f) / t)
                    trk.n_inactive = 0
                    trk.states.append(ASSOCIATED)
                    last = trk.states[-self.n:]
                    if len(trk.states) >= self.n and sum(
                            s in (ACTIVE, ASSOCIATED) for s in last) >= self.m:
                        trk.states[-1] = ACTIVE
                    used[hit] = True
                else:
                    trk.current = (pd, pf, 0.0)
                    trk.states.append({ACTIVE: COASTING,
                                       ASSOCIATED: TENTATIVE}.get(
                                           trk.states[-1], trk.states[-1]))
                    trk.n_inactive += 1
                    if trk.n_inactive > self.n_delete:
                        gone.append(trk)
            for trk in gone:
                self.tracks.remove(trk)
        else:
            self.timestamp_ms = timestamp_ms
        for j, det in enumerate(detections):
            if not used[j]:
                for acc in self.acc_init:
                    self.tracks.append(Track(tuple(det), acc))

    def confirmed(self) -> list:
        """(state, delay bins, Doppler Hz, associations) of every ACTIVE or
        COASTING track."""
        return [(t.states[-1], t.current[0], t.current[1], t.n_associated)
                for t in self.tracks if t.states[-1] in (ACTIVE, COASTING)]

    def document(self) -> dict:
        """What the served track document says, unrounded: the counts by
        state, and each track that is not TENTATIVE, in creation order."""
        states = [t.states[-1] for t in self.tracks]
        return {
            "n": len(self.tracks),
            "nTentative": states.count(TENTATIVE),
            "nAssociated": states.count(ASSOCIATED),
            "nActive": states.count(ACTIVE),
            "nCoasting": states.count(COASTING),
            "data": [{"state": t.states[-1], "delay": t.current[0],
                      "doppler": t.current[1],
                      "acceleration": t.acceleration,
                      "n": t.n_associated,
                      "associated_delay": [p[0] for p in t.associated],
                      "associated_doppler": [p[1] for p in t.associated]}
                     for t in self.tracks if t.states[-1] != TENTATIVE]}

    def active(self) -> list:
        """(delay bins, Doppler Hz) of every ACTIVE track."""
        return [(t.current[0], t.current[1]) for t in self.tracks
                if t.states[-1] == ACTIVE]
