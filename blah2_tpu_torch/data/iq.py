"""Host-side IQ sample ring buffer and per-channel spectrum metadata.

The reference couples capture and process threads through a mutex-guarded
``std::deque<std::complex<double>>`` pushed one sample at a time
(`src/data/IqData.{h,cpp}`, `IqData.cpp:42-53`). On the TPU host that
per-sample contract would dominate the CPI budget, so this rebuild uses a
vectorized numpy ring with block push/pop under a condition variable: the
capture side feeds contiguous blocks, the process side extracts one CPI of
samples at a time and ships it to the device in a single transfer.

Overwrite semantics match the reference: when full, the oldest samples are
dropped (`IqData.cpp:42-53`). A blocking `push_wait` covers the replay path,
which only pushes when space is available (`RspDuo.cpp:150-179`).

`IqMetadata` carries the reference-channel spectrum published by the spectrum
analyser, with the `IqData::to_json` wire contract (keys timestamp / min /
max / mean / frequency / spectrum, spectrum in dB — `IqData.cpp:93-126`).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from blah2_tpu_torch.utils import jsonfmt


class IqRingBuffer:
    def __init__(self, capacity: int, dtype=np.complex64):
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, dtype=dtype)
        self._start = 0  # index of oldest sample
        self._len = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.closed = False
        self._dropped = 0  # total overflow drops, monotonic

    def __len__(self) -> int:
        with self._lock:
            return self._len

    @property
    def dropped(self) -> int:
        """Total samples lost to overflow (seam detection for overlapped
        CPI extraction)."""
        with self._lock:
            return self._dropped

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def _write(self, block: np.ndarray) -> None:
        n = len(block)
        end = (self._start + self._len) % self.capacity
        first = min(n, self.capacity - end)
        self._buf[end : end + first] = block[:first]
        if n > first:
            self._buf[: n - first] = block[first:]
        overflow = max(0, self._len + n - self.capacity)
        self._start = (self._start + overflow) % self.capacity
        self._len = min(self._len + n, self.capacity)
        self._dropped += overflow

    def push(self, block: np.ndarray) -> None:
        """Push a block, dropping the oldest samples if the ring is full."""
        block = np.asarray(block)
        trunc = max(0, len(block) - self.capacity)
        if trunc:
            block = block[-self.capacity :]
        with self._lock:
            self._dropped += trunc
            self._write(block)
            self._not_empty.notify_all()

    def push_wait(self, block: np.ndarray, timeout: Optional[float] = None) -> bool:
        """Push a block, blocking until it fits (replay pacing)."""
        block = np.asarray(block)
        with self._lock:
            while self.capacity - self._len < len(block) and not self.closed:
                if not self._not_full.wait(timeout):
                    return False
            if self.closed:
                return False
            self._write(block)
            self._not_empty.notify_all()
            return True

    def wait_for(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until at least ``n`` samples are available (or closed/
        timeout). Does not consume. Returns availability."""
        with self._lock:
            if not self._not_empty.wait_for(
                    lambda: self._len >= n or self.closed, timeout):
                return False
            return self._len >= n

    def pop(self, n: int, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        """Pop the oldest ``n`` samples, blocking until available."""
        with self._lock:
            while self._len < n and not self.closed:
                if not self._not_empty.wait(timeout):
                    return None
            if self._len < n:
                return None
            out = np.empty(n, dtype=self._buf.dtype)
            first = min(n, self.capacity - self._start)
            out[:first] = self._buf[self._start : self._start + first]
            if n > first:
                out[first:] = self._buf[: n - first]
            self._start = (self._start + n) % self.capacity
            self._len -= n
            self._not_full.notify_all()
            return out


class IqMetadata:
    """Reference-channel spectrum metadata (filled by the spectrum analyser)."""

    def __init__(self):
        self.frequency_khz = np.zeros(0, dtype=np.float64)
        self.spectrum_db = np.zeros(0, dtype=np.float64)
        # Sub-CPI spectra (process.spectrum.nSub, `SpectrumAnalyser.h:6`
        # TODO): (k, n_spectrum) dB or None. Retained across CPIs whose
        # pipeline output omits them (staged timing samples), so the
        # product never flickers.
        self.sub_spectra_db = None

    def update(self, frequency_khz: np.ndarray, spectrum_db: np.ndarray,
               sub_spectra_db=None) -> None:
        self.frequency_khz = np.asarray(frequency_khz, dtype=np.float64)
        self.spectrum_db = np.asarray(spectrum_db, dtype=np.float64)
        if sub_spectra_db is not None:
            self.sub_spectra_db = np.asarray(sub_spectra_db,
                                             dtype=np.float64)

    def to_doc(self, timestamp_ms: int) -> dict:
        spec = self.spectrum_db
        finite = spec[np.isfinite(spec)]
        doc = {
            "timestamp": int(timestamp_ms),
            "min": jsonfmt.round2(float(finite.min()) if finite.size else 0.0),
            "max": jsonfmt.round2(float(finite.max()) if finite.size else 0.0),
            "mean": jsonfmt.round2(
                float(finite.mean()) if finite.size else 0.0),
            "frequency": np.round(self.frequency_khz, 2).tolist(),
            "spectrum": np.round(
                np.nan_to_num(spec, nan=0.0, posinf=0.0, neginf=0.0),
                2).tolist(),
        }
        if self.sub_spectra_db is not None:
            doc["subSpectra"] = np.round(
                np.nan_to_num(self.sub_spectra_db,
                              nan=0.0, posinf=0.0, neginf=0.0),
                2).tolist()
        return doc

    def to_json(self, timestamp_ms: int) -> str:
        import json

        return json.dumps(self.to_doc(timestamp_ms), separators=(",", ":"))
