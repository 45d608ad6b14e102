"""Cell-averaging CFAR across delay, per Doppler row (counterpart of
``blah2_tpu/dsp/cfar.py``).

Parity with reference `src/process/detection/CfarDetector1D.{h,cpp}`:
  - CFAR runs across delay only, per Doppler row (`CfarDetector1D.h:4`);
  - threshold α = N·(pfa^(−1/N) − 1) over the N valid train cells, with
    n_guard guard cells each side (`CfarDetector1D.cpp:57-83`); the
    train-cell count shrinks at map edges as the reference's index clipping
    does, including the quirk that left-side train cells require k > 0
    (`CfarDetector1D.cpp:59-65`);
  - rows with |doppler| < min_doppler and cells with delay < min_delay are
    skipped (`CfarDetector1D.cpp:39-43,52-56`);
  - cell power is |z|² and reported SNR is 10·log10|z| − noisePower
    (`CfarDetector1D.cpp:47-48`).

The detection list has a fixed capacity (``max_detections``), filled in the
reference's row-major scan order; ``count`` may exceed it. Row and column
indices are int64, torch's index type.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blah2_tpu_torch.device import as_numpy, resolve_device


class CfarDetections(NamedTuple):
    """Fixed-capacity detection set (invalid slots masked out)."""

    row: torch.Tensor      # Doppler row index into the map, int64 (K,)
    col: torch.Tensor      # delay column index into the map, int64 (K,)
    delay: torch.Tensor    # delay in bins (col + delay_axis[0]) (K,)
    doppler: torch.Tensor  # Doppler in Hz (K,)
    snr: torch.Tensor      # SNR in dB (K,)
    valid: torch.Tensor    # bool (K,)
    count: torch.Tensor    # total detections found (may exceed K), int32


def cfar_train_count(n_guard: int, n_train: int, n_cols: int) -> np.ndarray:
    """Per-column valid train-cell count N, shrunk at map edges as the
    reference's index clipping does, including the k>0 left-train quirk
    (`CfarDetector1D.cpp:57-83`)."""
    g, t = int(n_guard), int(n_train)
    j = np.arange(n_cols)
    cnt = np.zeros(n_cols, dtype=np.int64)
    for o in range(g + 1, g + t + 1):
        cnt += (j - o > 0).astype(np.int64)   # k > 0 (reference quirk)
        cnt += (j + o < n_cols).astype(np.int64)
    return cnt


def cfar_threshold_scale(pfa: float, n_guard: int, n_train: int,
                         n_cols: int) -> np.ndarray:
    """Per-column CFAR threshold scale α/N (applied to the train *sum*);
    ∞ where no train cell exists."""
    cnt = cfar_train_count(n_guard, n_train, n_cols)
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = cnt * (float(pfa) ** (-1.0 / np.maximum(cnt, 1)) - 1.0)
    return np.where(cnt > 0, alpha / np.maximum(cnt, 1), np.inf)


def extract_topk(flat_mask: torch.Tensor, n_cols: int, max_detections: int):
    """Fixed-capacity index extraction in row-major scan order, over the
    last dimension of ``flat_mask`` (leading dimensions batch).

    The K smallest of (index where hit, else n_cells) are the first K hit
    indices. Returns (row, col, valid, count)."""
    n_cells = flat_mask.shape[-1]
    count = torch.sum(flat_mask, dim=-1).to(torch.int32)
    score = torch.where(
        flat_mask, torch.arange(n_cells, device=flat_mask.device), n_cells)
    idx = torch.topk(score, max_detections, dim=-1, largest=False,
                     sorted=True).values
    valid = idx < n_cells
    idx = torch.clamp(idx, max=n_cells - 1)
    return idx // n_cols, idx % n_cols, valid, count


class CfarDetector(nn.Module):
    def __init__(
        self,
        pfa: float,
        n_guard: int,
        n_train: int,
        min_delay: int,
        min_doppler: float,
        delay_axis,
        doppler_axis,
        max_detections: int = 128,
        real_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.pfa = float(pfa)
        self.n_guard = int(n_guard)
        self.n_train = int(n_train)
        self.min_delay = int(min_delay)
        self.min_doppler = float(min_doppler)
        self.max_detections = int(max_detections)
        self.real_dtype = real_dtype

        delay_axis = as_numpy(delay_axis)
        doppler_axis = as_numpy(doppler_axis).astype(np.float64)
        self.n_rows = len(doppler_axis)
        self.n_cols = len(delay_axis)

        def buf(name, a, dtype=None):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(device, dtype))

        buf("_row_ok", np.abs(doppler_axis) >= self.min_doppler)
        buf("_col_ok", delay_axis >= self.min_delay)
        buf("_delay_axis", delay_axis, torch.float32)
        buf("_doppler_axis", doppler_axis, torch.float32)
        # alpha/cnt scales the train *sum*: threshold = alpha * sum/cnt.
        buf("_thresh_scale", cfar_threshold_scale(
            self.pfa, self.n_guard, self.n_train, self.n_cols), real_dtype)

    def forward(self, z: torch.Tensor,
                noise_power: torch.Tensor) -> CfarDetections:
        """CFAR on a complex (n_rows, n_cols) delay-Doppler map, with the
        scalar map noise power in dB."""
        g, t = self.n_guard, self.n_train
        nc = self.n_cols
        maxo = g + t

        mag = torch.abs(z).to(self.real_dtype)
        power = mag * mag
        snr_db = 10.0 * torch.log10(mag) - noise_power.to(self.real_dtype)

        # Train sums via shifted slices of zero-padded maps.
        p_left = power.clone()
        p_left[:, 0] = 0.0  # left train cells require k > 0
        pl = F.pad(p_left, (maxo, 0))
        pr = F.pad(power, (0, maxo))
        train = torch.zeros_like(power)
        for o in range(g + 1, maxo + 1):
            train = train + pl[:, maxo - o: maxo - o + nc]
            train = train + pr[:, o: o + nc]

        detect = ((power > self._thresh_scale[None, :] * train)
                  & self._row_ok[:, None] & self._col_ok[None, :])
        row, col, valid, count = extract_topk(
            detect.reshape(-1), nc, self.max_detections)
        return CfarDetections(
            row=row,
            col=col,
            delay=self._delay_axis[col],
            doppler=self._doppler_axis[row],
            snr=snr_db[row, col],
            valid=valid,
            count=count,
        )


def make_cfar(det_cfg, delay_axis, doppler_axis, max_detections: int = 128,
              real_dtype: torch.dtype = torch.float32,
              device=None) -> CfarDetector:
    """CFAR factory by config: ``process.detection.cfar`` "ca" (the
    reference algorithm); "os" is not ported yet."""
    kind = (getattr(det_cfg, "cfar", "ca") or "ca").lower()
    if kind in ("ca", "ca-cfar", "cacfar"):
        return CfarDetector(
            pfa=det_cfg.pfa, n_guard=det_cfg.n_guard, n_train=det_cfg.n_train,
            min_delay=det_cfg.min_delay, min_doppler=det_cfg.min_doppler,
            delay_axis=delay_axis, doppler_axis=doppler_axis,
            max_detections=max_detections, real_dtype=real_dtype,
            device=device)
    if kind in ("os", "os-cfar", "oscfar"):
        raise NotImplementedError(
            "OS-CFAR is not ported to blah2_tpu_torch yet "
            "(ROADMAP.md queue 1: 'Alternative algorithms')")
    raise ValueError(f"unknown process.detection.cfar: {kind!r}")
