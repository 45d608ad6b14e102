"""Peaks of the card and the bytes each kernel's call must move, counted
from its shapes: the yardstick of the per-layer roofline metrics."""

from __future__ import annotations

#: NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12

#: The map-mode detect kernel's device records in a trace.
DETECT_KERNEL = "detect_tile"


def detect_bytes(n_rows: int, n_cols: int) -> int:
    """Bytes the map-mode detect call (``ops/detect.py`` ``detect`` on a
    complex64 map) must move, each read and written once: the complex64
    map (8 B a cell) and the float32 cell mask (4 B) in; the float32 dB map
    and keep mask (4 B each) out; the per-column CFAR scale (4 B a column)
    in; noise and rawmax (4 B each) out."""
    cells = n_rows * n_cols
    return cells * (8 + 4 + 4 + 4) + 4 * n_cols + 8


def detect_roofline_pct(n_rows: int, n_cols: int, seconds: float) -> float:
    """The detect call's share of its bandwidth roofline, in %, at
    ``seconds`` of device time a call."""
    return detect_bytes(n_rows, n_cols) / HBM_BYTES_PER_S / seconds * 100.0
