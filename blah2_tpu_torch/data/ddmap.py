"""Delay-Doppler (ambiguity) map product.

The TPU pipeline produces the map as a dense complex array (rows = Doppler,
cols = delay) plus its axes; this class is the host-side product wrapper that
owns metrics and the JSON wire contract.

Parity with reference `src/data/Map.{h,cpp}`:
  - axes: ``delay`` in bins, ``doppler`` in Hz (`Map.h:30-36`)
  - ``set_metrics``: noisePower = mean over the dB map, maxPower = max − noise
    (`Map.cpp:188-206`; note the reference max-accumulator starts at 0, so the
    raw max is clamped at ≥ 0 — reproduced here for parity)
  - ``to_json``: per-cell values are dB minus noisePower, keys timestamp /
    nRows / nCols / noisePower / maxPower / delay / doppler / data
    (`Map.cpp:116-163`), floats at ≤ 2 decimals
  - ``delay_bin_to_km``: rewrites the delay axis to bistatic km,
    delay · (c/fs) / 1000 (`Map.cpp:166-185`)
  - ``save``: append to a JSON-array file (`Map.cpp:209-262`)
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from blah2_tpu_torch.constants import SPEED_OF_LIGHT
from blah2_tpu_torch.utils import jsonfmt


class DelayDopplerMap:
    def __init__(
        self,
        data: Optional[np.ndarray],
        delay: Sequence[int],
        doppler: Sequence[float],
        db_data: Optional[np.ndarray] = None,
    ):
        """Either the complex map ``data`` or a precomputed dB map ``db_data``
        (the TPU pipeline returns the latter) must be provided."""
        self.data = None if data is None else np.asarray(data)
        self._db = None if db_data is None else np.asarray(db_data)
        self.delay = np.asarray(delay)
        self.doppler = np.asarray(doppler)
        self.noise_power: float = 0.0
        self.max_power: float = 0.0

    @property
    def _shape(self):
        return self.data.shape if self.data is not None else self._db.shape

    @property
    def n_rows(self) -> int:
        return self._shape[0]

    @property
    def n_cols(self) -> int:
        return self._shape[1]

    def db(self) -> np.ndarray:
        """Map in dB: 10·log10(|z|)."""
        if self._db is not None:
            return self._db
        mag = np.abs(self.data)
        with np.errstate(divide="ignore"):
            return 10.0 * np.log10(mag)

    def set_metrics(self, noise_power: Optional[float] = None,
                    max_power: Optional[float] = None) -> None:
        """Compute (or install device-computed) noisePower and maxPower."""
        if noise_power is not None and max_power is not None:
            self.noise_power = float(noise_power)
            self.max_power = float(max_power)
            return
        db = self.db()
        noise = float(np.mean(db))
        # Reference accumulator starts at 0 ⇒ effective max(0, max(db)).
        raw_max = max(0.0, float(np.max(db)))
        self.noise_power = noise
        self.max_power = raw_max - noise

    def doppler_hz_to_bin(self, doppler_hz: float) -> int:
        """Exact-match Doppler Hz → row index (`Map.cpp:103-113`); 0 if absent."""
        matches = np.nonzero(self.doppler == doppler_hz)[0]
        return int(matches[0]) if matches.size else 0

    def to_json(self, timestamp_ms: int, fs_km: Optional[int] = None) -> str:
        return self.to_json_parts(timestamp_ms, fs_km)[0]

    def to_json_parts(self, timestamp_ms: int,
                      fs_km: Optional[int] = None) -> tuple:
        """Serialize the map product. With ``fs_km`` the delay axis is
        emitted directly in bistatic km (what the reference achieves by
        mutating the axis before serializing, `Map.cpp:166-185`), avoiding
        a reparse of the full map. Rounding is vectorized: the map body is
        the largest JSON product (≥100k values at full config).

        Returns ``(full_json, head_json, db)``: the full document, the
        document WITHOUT its ``data`` member (a complete JSON object — the
        maxhold stash's zero-parse ``update_serialized`` input), and the
        unrounded dB-minus-noise array the data member was built from."""
        from blah2_tpu_torch import native

        db = np.nan_to_num(self.db() - self.noise_power,
                           nan=0.0, posinf=0.0, neginf=0.0)
        if fs_km is not None:
            delay_axis = np.asarray(
                self.delay * (SPEED_OF_LIGHT / float(fs_km)) / 1000.0,
                dtype=np.float64)
            delay_json = native.json_f64_vector(delay_axis) or json.dumps(
                np.round(delay_axis, 2).tolist(), separators=(",", ":"))
        else:
            delay_json = json.dumps([int(d) for d in self.delay],
                                    separators=(",", ":"))
        doppler_axis = np.asarray(self.doppler, dtype=np.float64)
        doppler_json = native.json_f64_vector(doppler_axis) or json.dumps(
            np.round(doppler_axis, 2).tolist(), separators=(",", ":"))
        data_json = native.json_f32_matrix(db)
        if data_json is None:
            data_json = json.dumps(
                np.round(db, 2).astype(np.float64).tolist(),
                separators=(",", ":"))
        head = (
            f'{{"timestamp":{int(timestamp_ms)},'
            f'"nRows":{self.n_rows},"nCols":{self.n_cols},'
            f'"noisePower":{jsonfmt.round2(float(self.noise_power))},'
            f'"maxPower":{jsonfmt.round2(float(self.max_power))},'
            f'"delay":{delay_json},"doppler":{doppler_json}'
        )
        return (head + f',"data":{data_json}}}', head + "}", db)

    def delay_bin_to_km(self, json_str: str, fs: int) -> str:
        """Rewrite the delay axis of an emitted JSON doc to bistatic km."""
        doc = json.loads(json_str)
        doc["delay"] = [
            float(d) * (SPEED_OF_LIGHT / float(fs)) / 1000.0 for d in self.delay
        ]
        return jsonfmt.dumps(doc)

    @staticmethod
    def save(json_str: str, path: str) -> bool:
        return jsonfmt.append_json_array(json_str, path)
