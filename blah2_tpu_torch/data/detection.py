"""Detection product: parallel delay/doppler/snr arrays.

Parity with reference `src/data/Detection.{h,cpp}`: constructor from parallel
vectors, ``to_json`` with keys timestamp/delay/doppler/snr
(`Detection.cpp:47-106`), ``delay_bin_to_km`` rewriting the delay array to
bistatic km (`Detection.cpp:108-130`), and JSON-array file append
(`Detection.cpp:132-161`).
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

from blah2_tpu_torch.constants import SPEED_OF_LIGHT
from blah2_tpu_torch.utils import jsonfmt


class Detection:
    def __init__(
        self,
        delay: Sequence[float] = (),
        doppler: Sequence[float] = (),
        snr: Sequence[float] = (),
    ):
        self.delay = list(float(d) for d in delay)
        self.doppler = list(float(d) for d in doppler)
        self.snr = list(float(s) for s in snr)

    @property
    def n_detections(self) -> int:
        return len(self.delay)

    def __len__(self) -> int:
        return self.n_detections

    def to_doc(self, timestamp_ms: int, fs_km: int = None) -> dict:
        """The product as a dict; with ``fs_km`` the delay values are
        emitted in bistatic km directly (`Detection.cpp:108-130`
        semantics)."""
        if fs_km is not None:
            scale = (SPEED_OF_LIGHT / float(fs_km)) / 1000.0
            delay = [round(d * scale, 2) for d in self.delay]
        else:
            delay = [round(d, 2) for d in self.delay]
        return {
            "timestamp": int(timestamp_ms),
            "delay": delay,
            "doppler": [round(d, 2) for d in self.doppler],
            "snr": [round(s, 2) for s in self.snr],
        }

    def to_json(self, timestamp_ms: int, fs_km: int = None) -> str:
        return json.dumps(self.to_doc(timestamp_ms, fs_km),
                          separators=(",", ":"))

    def delay_bin_to_km(self, json_str: str, fs: int) -> str:
        doc = json.loads(json_str)
        doc["delay"] = [
            float(d) * (SPEED_OF_LIGHT / float(fs)) / 1000.0 for d in self.delay
        ]
        return jsonfmt.dumps(doc)

    @staticmethod
    def save(json_str: str, path: str) -> bool:
        return jsonfmt.append_json_array(json_str, path)

    @staticmethod
    def from_arrays(delay: np.ndarray, doppler: np.ndarray, snr: np.ndarray,
                    valid: np.ndarray) -> "Detection":
        """Build from fixed-capacity masked arrays produced by the jitted chain."""
        valid = np.asarray(valid, dtype=bool)
        return Detection(
            np.asarray(delay)[valid],
            np.asarray(doppler)[valid],
            np.asarray(snr)[valid],
        )
