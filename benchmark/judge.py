"""Whether what the API served is right: each served product against the
plain reference (``reference/``) of the same samples.

Numbers compared, each the worst over the run's judged CPIs:

  - ``map_gap_db``: the served map (dB - noise, 2 decimals) against the
    reference's, over the cells no more than 10 dB under the map's mean
    that are not zero-Doppler clutter lags (there the filter's cancellation
    leaves rounding of the order of the cell itself), and its
    ``noisePower`` and ``maxPower``.
  - ``detection_gap_db``: served detections against the reference's,
    matched when they lie in one cell or within half a bin in delay and
    Doppler (the interpolation moves a peak by up to half a bin either
    way, and a flat peak's offset is unsteady). A matched pair reads
    its SNR gap. A detection on one side only reads how far the
    reference's decision about that cell was from flipping: for a cell the
    reference keeps, the smallest of its test margins (CFAR, centroid,
    the interpolation's peak tests, in dB); for one it drops, the largest
    margin among the tests it fails (inf for one that no rounding can
    flip: a cell the geometry excludes, the map's edge, or a cell the
    reference detects elsewhere or that was served twice).
  - ``delay_gap_db`` and ``doppler_gap_db``: where a matched pair lies.
    The served delay (km, 2 decimals) and Doppler (Hz, 2 decimals) stand
    for an interval of offsets from the reference's cell; the number is the
    smallest change, in dB, to any of the three map cells the reference
    interpolated over (the cell and its neighbours in delay, or in
    Doppler) that would move its 3-point interpolation into that interval.
    So it is on the SNR's scale: a sharp peak whose place is off by a tenth
    of a bin reads some tenths of a dB, and a flat peak, whose offset the
    least rounding moves, reads what it takes to move it. A served cell
    centre, or an offset of the wrong sign, reads as far off as the peak is
    sharp.
  - ``track_mismatch`` (a deployment with the tracker on): served ACTIVE
    tracks with no reference ACTIVE track within 0.05 bins and 0.05 Hz,
    and reference ACTIVE tracks with no served one, summed over the judged
    track documents. The reference tracker runs on the reference's own
    detections of every CPI since the first, timed by the served
    timestamps. COASTING tracks and association counts carry the history
    of detections at the CFAR threshold, which rounding may flip (a
    target's faint neighbour picked up by a coasting track): they are not
    compared here.
  - ``track_state_mismatch`` (tracker on): the tracker layer on its own.
    A second reference tracker is fed the detections the program's tracker
    was given, every CPI since the first (``served["tracker_inputs"]``; the
    detections are judged above), and every judged track document is
    compared with its state whole: the counts by state, and each track that
    is not TENTATIVE, in order, by state, association count and history,
    place and acceleration (within the JSON's 0.01 step). The number is
    the count of counts and tracks that differ.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List

import numpy as np

from benchmark.reference import dsp
from benchmark.reference.tracker import MofN

TRACK_DELAY_TOL = 0.05     # bins: the served delay's 2 decimals, and more
TRACK_DOPPLER_TOL = 0.05   # Hz
# The JSON's 2 decimals: half a step each side of a served number, and a
# whole step between two roundings of one float that lies near a half.
HALF_STEP = 0.005
STEP = 0.01 + 1e-9


def map_gap(doc, ref: dsp.Cpi, g: dsp.Geometry) -> float:
    """``doc``: the served map document, as JSON text or parsed."""
    doc = json.loads(doc) if isinstance(doc, str) else doc
    data = np.asarray(doc["data"], dtype=np.float64)
    if data.shape != ref.db_rel.shape:
        return math.inf
    delay = g.delay_axis
    null = np.zeros(data.shape, dtype=bool)
    null[g.doppler_axis == 0.0, :] = (delay >= g.clutter_min) & (
        delay < g.clutter_max)
    bulk = (ref.db_rel >= -10.0) & ~null
    return float(max(np.abs(data - ref.db_rel)[bulk].max(),
                     abs(doc["noisePower"] - ref.noise),
                     abs(doc["maxPower"] - ref.max_power)))


def _cell(d: float, f: float, g: dsp.Geometry):
    return (int(round((f - g.doppler_axis[0]) / g.res)),
            int(round(d - g.delay_min)))


def offset_gap_db(s0: float, s1: float, s2: float, lo: float,
                  hi: float) -> float:
    """The smallest change, in dB, to any of ``s0``, ``s1``, ``s2`` (a peak
    and its two neighbours) that moves their 3-point interpolation's offset
    ``(s0 - s2) / (2 (s0 - 2 s1 + s2))``, in bins, into [``lo``, ``hi``].

    The offset is ``t`` where ``a - 2 t b = 0`` (``a = s0 - s2``,
    ``b = s0 - 2 s1 + s2``). Moving the cells by ``e0, e1, e2`` changes
    ``a - 2 t b`` by ``(1 - 2t) e0 + 4t e1 - (1 + 2t) e2``, so the least
    largest ``|e_i|`` that brings it to 0 is ``|a - 2 t b|`` over
    ``|1 - 2t| + |4t| + |1 + 2t|``, at the end of the interval nearer the
    reference's offset."""
    a, b = s0 - s2, s0 - 2.0 * s1 + s2
    off = a / (2.0 * b) if b != 0.0 else 0.0
    if lo <= off <= hi:
        return 0.0
    t = lo if off < lo else hi
    return abs(a - 2.0 * t * b) / (abs(2.0 * t - 1.0) + abs(4.0 * t)
                                   + abs(2.0 * t + 1.0))


def _place_gaps(d: float, f: float, ref: dsp.Cpi, r: int, c: int,
                g: dsp.Geometry):
    """(delay, Doppler) gaps in dB of a detection served at ``d`` bins and
    ``f`` Hz against the reference's interpolation at cell (r, c)."""
    s = ref.db_rel
    half_d = HALF_STEP / g.km_per_bin + 1e-9
    half_f = (HALF_STEP + 1e-9) / g.res
    od = d - g.delay_axis[c]
    of = (f - g.doppler_axis[r]) / g.res
    return (offset_gap_db(s[r, c - 1], s[r, c], s[r, c + 1],
                          od - half_d, od + half_d),
            offset_gap_db(s[r - 1, c], s[r, c], s[r + 1, c],
                          of - half_f, of + half_f))


def detection_gaps(served: np.ndarray, ref: dsp.Cpi,
                   g: dsp.Geometry) -> Dict[str, float]:
    """``served``: (k, 3) delay bins, Doppler Hz, SNR dB of one CPI.
    ``detection_gap_db``, ``delay_gap_db`` and ``doppler_gap_db``."""
    want = ref.detections
    free = list(range(len(want)))
    worst = {"detection_gap_db": 0.0, "delay_gap_db": 0.0,
             "doppler_gap_db": 0.0}
    for d, f, s in served:
        cell = _cell(d, f, g)
        best, dist = None, None
        for j in free:
            dd = abs(want[j, 0] - d)
            df = abs(want[j, 1] - f) / g.res
            if (ref.cells[j] == cell or dd <= 0.5 and df <= 0.5) and (
                    dist is None or dd + df < dist):
                best, dist = j, dd + df
        if best is not None:
            free.remove(best)
            gap_d, gap_f = _place_gaps(d, f, ref, *ref.cells[best], g)
            worst["detection_gap_db"] = max(worst["detection_gap_db"],
                                            abs(want[best, 2] - s))
            worst["delay_gap_db"] = max(worst["delay_gap_db"], gap_d)
            worst["doppler_gap_db"] = max(worst["doppler_gap_db"], gap_f)
            continue
        # A cell the reference keeps too, but whose detection is taken or
        # lies elsewhere, is no rounding: inf.
        fails = [abs(m) for m in dsp.margins(ref, *cell, g).values()
                 if m < 0.0]
        worst["detection_gap_db"] = max(worst["detection_gap_db"],
                                        max(fails, default=math.inf))
    for j in free:
        r, c = ref.cells[j]
        worst["detection_gap_db"] = max(
            worst["detection_gap_db"],
            min(dsp.margins(ref, r, c, g).values()))
    return {k: float(v) for k, v in worst.items()}


def _active_served(text: str) -> List[tuple]:
    doc = json.loads(text)
    return [(t["delay"], t["doppler"]) for t in doc["data"]
            if t["state"] == "ACTIVE"]


def track_mismatch(served: List[tuple], ref: List[tuple]) -> int:
    """Unmatched (delay bins, Doppler Hz) of ACTIVE tracks, both sides."""
    left = list(ref)
    missing = 0
    for d, f in served:
        hit = next((r for r in left if abs(r[0] - d) <= TRACK_DELAY_TOL
                    and abs(r[1] - f) <= TRACK_DOPPLER_TOL), None)
        if hit is None:
            missing += 1
        else:
            left.remove(hit)
    return missing + len(left)


def _near(a, b) -> bool:
    return abs(a - b) <= STEP


def _same_track(got: dict, want: dict) -> bool:
    return (got["state"] == want["state"] and got["n"] == want["n"]
            and _near(got["delay"], want["delay"])
            and _near(got["doppler"], want["doppler"])
            and _near(got["acceleration"], want["acceleration"])
            and len(got["associated_delay"]) == want["n"]
            and len(got["associated_doppler"]) == want["n"]
            and all(map(_near, got["associated_delay"],
                        want["associated_delay"]))
            and all(map(_near, got["associated_doppler"],
                        want["associated_doppler"])))


def track_state_mismatch(text: str, want: dict) -> int:
    """The counts by state and the non-TENTATIVE tracks of a served track
    document that differ from ``want`` (``MofN.document()``)."""
    doc = json.loads(text)
    bad = sum(doc[k] != want[k] for k in (
        "n", "nTentative", "nAssociated", "nActive", "nCoasting"))
    got, ref = doc["data"], want["data"]
    bad += abs(len(got) - len(ref))
    return bad + sum(not _same_track(a, b) for a, b in zip(got, ref))


_TS = re.compile(r'"timestamp":(\d+)')


def doc_timestamp(text: str) -> int:
    return int(_TS.search(text).group(1))


def judge(served: Dict, refs: List[dsp.Cpi], g: dsp.Geometry,
          timestamps: List[int], judged: List[int]):
    """(the numbers compared, what was judged), over the CPIs ``judged``.

    ``served``: ``maps`` {CPI: map JSON}, ``detections`` {CPI: (k, 3)
    array in bins}, ``tracks`` {CPI: tracker JSON}; ``refs`` the
    reference's CPIs of the scene (CPI k is scene CPI k % len(refs));
    ``timestamps`` every CPI's served timestamp from the first."""
    k_ref = len(refs)
    judged_set = set(judged)
    out = {"map_gap_db": 0.0, "detection_gap_db": 0.0, "delay_gap_db": 0.0,
           "doppler_gap_db": 0.0}
    seen = {"cpis": len(judged), "maps": 0, "detections": 0}
    for k, text in served["maps"].items():
        if k in judged_set:
            seen["maps"] += 1
            out["map_gap_db"] = max(out["map_gap_db"],
                                    map_gap(text, refs[k % k_ref], g))
    for k in judged:
        dets = served["detections"].get(k, np.zeros((0, 3)))
        seen["detections"] += len(dets)
        for key, v in detection_gaps(dets, refs[k % k_ref], g).items():
            out[key] = max(out[key], v)
    if g.tracker:
        tracks = {k: v for k, v in served["tracks"].items()
                  if k in judged_set}
        trk = MofN(g.m, g.n_of, g.n_delete, g.cpi, g.max_acc, g.range_res,
                   g.wavelength)
        mism = 0
        seen["track_docs"] = len(tracks)
        seen["active_tracks"] = 0
        for k in range(max(tracks, default=-1) + 1):
            trk.process([tuple(d) for d in refs[k % k_ref].detections],
                        timestamps[k])
            if k in tracks:
                active = _active_served(tracks[k])
                seen["active_tracks"] += len(active)
                miss = track_mismatch(active, trk.active())
                if miss and "first_track_mismatch" not in seen:
                    seen["first_track_mismatch"] = {
                        "cpi": k, "served": active,
                        "reference": [(round(d, 3), round(f, 3))
                                      for d, f in trk.active()]}
                mism += miss
        out["track_mismatch"] = float(mism)
        out["track_state_mismatch"] = float(_track_states(
            served["tracker_inputs"], tracks, timestamps, g, seen))
    return out, seen


def _track_states(inputs, tracks: Dict[int, str], timestamps: List[int],
                  g: dsp.Geometry, seen: dict) -> int:
    """The reference tracker fed ``inputs``, the program tracker's (its
    timestamp, its detections) of each call in order, against every served
    track document in ``tracks`` ({CPI: JSON})."""
    trk = MofN(g.m, g.n_of, g.n_delete, g.cpi, g.max_acc, g.range_res,
               g.wavelength)
    index = {ts: k for k, ts in enumerate(timestamps)}
    bad = judged = 0
    for ts, dets in inputs:
        trk.process(dets, ts)
        k = index.get(ts)
        if k in tracks:
            judged += 1
            miss = track_state_mismatch(tracks[k], trk.document())
            if miss and "first_track_state_mismatch" not in seen:
                seen["first_track_state_mismatch"] = {"cpi": k,
                                                      "differ": miss}
            bad += miss
    seen["track_state_docs"] = judged
    return bad + len(tracks) - judged
