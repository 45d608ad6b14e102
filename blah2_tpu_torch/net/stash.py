"""Rolling-window product stashes.

Parity with reference `api/stash/*.js`, which self-poll the REST API at 10 Hz
and maintain rolling windows. Here they are in-process observers updated on
each product publish (same windows and output shapes, no polling loop):

  - maxhold (`maxhold.js`): last 20 CPI maps; serves the latest map JSON with
    ``data`` replaced by the element-wise max over the window;
  - detection (`detection.js`): detections of the last 300 s flattened into
    parallel timestamp/delay/doppler/snr arrays;
  - iqdata (`iqdata.js`): last 20 spectra as a waterfall — the latest iqdata
    doc with ``spectrum``/``frequency``/``timestamp`` as lists-of-lists;
  - timing (`timing.js`): per-stage timing series over the last 20 CPIs.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List

import numpy as np


class MaxholdStash:
    """Element-wise max surface over the last 20 CPI maps.

    The window holds numpy arrays; the max-reduction and serialization run
    lazily in ``get()`` (the reference computes per UI poll too,
    `api/stash/maxhold.js`), cached by map timestamp. The in-process
    publish path hands the dB array plus the already-serialized head via
    ``update_serialized`` — no JSON round-trip at all; the TCP ingest
    path hands the parsed doc via ``update_parsed``.
    """

    N_CPI = 20

    def __init__(self):
        self._maps: List[np.ndarray] = []
        self._head_json: str = ""
        self._head_ts = None
        self._lock = threading.Lock()
        self._cache: str = ""
        self._cache_ts = None

    def update(self, map_json: str) -> None:
        try:
            doc = json.loads(map_json)
        except json.JSONDecodeError:
            return
        self.update_parsed(doc)

    def update_parsed(self, doc: Dict[str, Any]) -> None:
        data = doc.get("data")
        if data is None:
            return
        head = {k: v for k, v in doc.items() if k != "data"}
        self.update_serialized(
            json.dumps(head, separators=(",", ":")),
            head.get("timestamp"), np.asarray(data, dtype=np.float32))

    def update_serialized(self, head_json: str, timestamp,
                          data: np.ndarray) -> None:
        """Zero-parse fast path: ``head_json`` is the map doc WITHOUT its
        ``data`` member, already serialized (the radar runtime has it as a
        byproduct of building the map JSON); ``data`` the dB array."""
        with self._lock:
            if self._maps and self._maps[-1].shape != data.shape:
                self._maps.clear()
            self._maps.append(data)
            if len(self._maps) > self.N_CPI:
                self._maps.pop(0)
            self._head_json = head_json
            self._head_ts = timestamp
            self._cache_ts = None  # invalidate

    def get(self) -> str:
        with self._lock:
            if not self._maps:
                return ""
            if self._cache_ts is not None and self._cache_ts == self._head_ts:
                return self._cache
            acc = np.maximum.reduce(self._maps)
            from blah2_tpu_torch import native

            data_json = native.json_f32_matrix(acc)
            if data_json is None:
                data_json = json.dumps(
                    np.round(acc, 2).astype(np.float64).tolist(),
                    separators=(",", ":"))
            self._cache = self._head_json[:-1] + ',"data":' + data_json + "}"
            self._cache_ts = self._head_ts
            return self._cache


class DetectionStash:
    WINDOW_S = 300

    def __init__(self):
        self._docs: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def update(self, detection_json: str) -> None:
        try:
            doc = json.loads(detection_json)
        except json.JSONDecodeError:
            return
        self.update_parsed(doc)

    def update_parsed(self, doc: Dict[str, Any]) -> None:
        with self._lock:
            self._docs.append(doc)
            now = doc.get("timestamp", 0)
            while self._docs and (now - self._docs[0].get("timestamp", 0)) \
                    / 1000.0 > self.WINDOW_S:
                self._docs.pop(0)

    def get(self) -> str:
        with self._lock:
            ts, delay, doppler, snr = [], [], [], []
            for d in self._docs:
                for j in range(len(d.get("delay", []))):
                    ts.append(d["timestamp"])
                    delay.append(d["delay"][j])
                    doppler.append(d["doppler"][j])
                    snr.append(d["snr"][j])
            return json.dumps(
                {"timestamp": ts, "delay": delay, "doppler": doppler,
                 "snr": snr}
            )


class IqDataStash:
    N_CPI = 20

    def __init__(self):
        self._spectrum: List[Any] = []
        self._frequency: List[Any] = []
        self._timestamp: List[Any] = []
        #: rows contributed by each retained CPI doc (subSpectra docs
        #: contribute k rows) — retention is counted in CPIs, not rows,
        #: so a doc without subSpectra amid sub-carrying ones never
        #: collapses the window.
        self._rows_per_doc: List[int] = []
        self._latest: Dict[str, Any] = {}
        self._prev_doc_ts = None
        self._lock = threading.Lock()

    def update(self, iqdata_json: str) -> None:
        try:
            doc = json.loads(iqdata_json)
        except json.JSONDecodeError:
            return
        self.update_parsed(doc)

    def update_parsed(self, doc: Dict[str, Any]) -> None:
        doc = dict(doc)  # mutated below; never alias the caller's doc
        with self._lock:
            # Sub-CPI spectra (process.spectrum.nSub): each CPI contributes
            # its k sub-rows to the waterfall instead of one full-CPI row —
            # a k×-finer time axis over the same N_CPI window
            # (`SpectrumAnalyser.h:6` TODO "k spectrum plots from sub-CPIs").
            sub = doc.get("subSpectra")
            rows = sub if sub else [doc.get("spectrum")]
            t0 = doc.get("timestamp")
            k = len(rows)
            # Truthful sub-row time axis: sub-spectrum s covers segment s
            # of the CPI window ending at t0, so it gets
            # t0 − (k−1−s)·cpi/k with the CPI span inferred from the
            # inter-doc timestamp delta (first doc: duplicated t0).
            span = 0
            if k > 1 and isinstance(t0, (int, float)) and \
                    isinstance(self._prev_doc_ts, (int, float)):
                span = max(0, t0 - self._prev_doc_ts)
            self._prev_doc_ts = t0
            for s, r in enumerate(rows):
                self._spectrum.append(r)
                self._frequency.append(doc.get("frequency"))
                self._timestamp.append(
                    t0 - round(span * (k - 1 - s) / k) if span else t0)
            self._rows_per_doc.append(len(rows))
            while len(self._rows_per_doc) > self.N_CPI:
                n = self._rows_per_doc.pop(0)
                del self._spectrum[:n]
                del self._frequency[:n]
                del self._timestamp[:n]
            doc["spectrum"] = list(self._spectrum)
            doc["frequency"] = list(self._frequency)
            doc["timestamp"] = list(self._timestamp)
            self._latest = doc

    def get(self) -> str:
        with self._lock:
            return json.dumps(self._latest) if self._latest else ""


class TimingStash:
    N_CPI = 20

    def __init__(self):
        self._series: Dict[str, List[Any]] = {}
        self._lock = threading.Lock()

    def update(self, timing_json: str) -> None:
        try:
            doc = json.loads(timing_json)
        except json.JSONDecodeError:
            return
        self.update_parsed(doc)

    def update_parsed(self, doc: Dict[str, Any]) -> None:
        with self._lock:
            for key, val in doc.items():
                if key in ("uptime", "nCpi"):
                    continue
                self._series.setdefault(key, []).append(val)
                if len(self._series[key]) > self.N_CPI:
                    self._series[key].pop(0)

    def get(self) -> str:
        with self._lock:
            return json.dumps(self._series)
