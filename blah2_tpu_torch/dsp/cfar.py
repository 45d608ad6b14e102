"""Cell-averaging and ordered-statistics CFAR across delay, per Doppler row
(counterpart of ``blah2_tpu/dsp/cfar.py``).

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

A detector runs in two stages, which the row-sharded pipeline runs apart:
:meth:`_CfarBase.hits` on any block of rows (CFAR needs no row but its
own), and :meth:`_CfarBase.extract` on the whole map's mask and dB map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def os_cfar_alpha(pfa: float, n: int, k: int) -> float:
    """OS-CFAR threshold multiplier α for train size ``n`` and order
    statistic rank ``k`` (1-indexed, k ≤ n).

    For an exponential (square-law-detected Rayleigh noise) background,
    Pfa(α) = ∏_{i=0}^{k−1} (n−i)/(n−i+α), monotone decreasing in α
    (Rohling 1983); solved by bisection in log space."""
    if n <= 0:
        return float("inf")
    k = min(max(int(k), 1), int(n))
    i = np.arange(k, dtype=np.float64)
    log_pfa = np.log(float(pfa))

    def f(alpha: float) -> float:
        return float(np.sum(np.log(n - i) - np.log(n - i + alpha))) - log_pfa

    lo, hi = 0.0, 1.0
    while f(hi) > 0.0:
        hi *= 2.0
        if hi > 1e12:  # pfa ~ 0: unreachable threshold
            return float("inf")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


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


class _CfarBase(nn.Module):
    """What the CA and OS detectors share: the parameters, the geometry
    masks and axes as buffers, the map's power and SNR, the train cells as
    shifted slices, and the fixed-capacity extraction. A subclass gives
    the threshold rule (``_hits``)."""

    def __init__(self, pfa, n_guard, n_train, min_delay, min_doppler,
                 delay_axis, doppler_axis, max_detections, real_dtype,
                 device):
        super().__init__()
        self._device = resolve_device(device)
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
        self._buf("_row_ok", np.abs(doppler_axis) >= self.min_doppler)
        self._buf("_col_ok", delay_axis >= self.min_delay)
        self._buf("_delay_axis", delay_axis, torch.float32)
        self._buf("_doppler_axis", doppler_axis, torch.float32)

    def _buf(self, name, a, dtype=None):
        self.register_buffer(name, torch.from_numpy(
            np.ascontiguousarray(a)).to(self._device, dtype))

    def _train_slices(self, power: torch.Tensor, fill: float):
        """The 2·n_train train cells of every cell, as shifted slices of the
        padded map; ``fill`` stands for out-of-map cells and for the left
        train cell at k = 0 (the reference's k > 0 quirk)."""
        g, t, nc = self.n_guard, self.n_train, self.n_cols
        maxo = g + t
        p_left = power.clone()
        p_left[..., 0] = fill
        pl = F.pad(p_left, (maxo, 0), value=fill)
        pr = F.pad(power, (0, maxo), value=fill)
        for o in range(g + 1, maxo + 1):
            yield pl[..., maxo - o: maxo - o + nc]
            yield pr[..., o: o + nc]

    def _hits(self, power: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def hits(self, power: torch.Tensor,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The detection mask of (..., R, n_cols) cell power (|z|² in
        ``real_dtype``): threshold hits in cells whose row and column the
        geometry keeps. ``rows``: the map rows of the R rows, int64,
        broadcastable to (..., R); rows at or past ``n_rows`` are outside
        the map. None: the whole map. The geometry is taken to the power's
        device (a row block may lie on another card than the module)."""
        dev = power.device
        row_ok = self._row_ok.to(dev)
        if rows is not None:
            row_ok = F.pad(row_ok, (0, 1))[rows.clamp(max=self.n_rows)]
        return self._hits(power) & row_ok[..., None] & self._col_ok.to(dev)

    def extract(self, mask: torch.Tensor, db: torch.Tensor,
                noise_power: torch.Tensor) -> CfarDetections:
        """The detection list of an (n_rows, n_cols) mask: its first
        ``max_detections`` cells in raster order, SNR ``db`` (10·log10|z|)
        − noise_power in ``real_dtype``."""
        row, col, valid, count = extract_topk(
            mask.reshape(-1), self.n_cols, self.max_detections)
        rd = self.real_dtype
        return CfarDetections(
            row=row,
            col=col,
            delay=self._delay_axis[col],
            doppler=self._doppler_axis[row],
            snr=db[row, col].to(rd) - noise_power.to(rd),
            valid=valid,
            count=count,
        )

    def forward(self, z: torch.Tensor,
                noise_power: torch.Tensor) -> CfarDetections:
        """CFAR on a complex (n_rows, n_cols) delay-Doppler map, with the
        scalar map noise power in dB."""
        mag = torch.abs(z).to(self.real_dtype)
        return self.extract(self.hits(mag * mag), 10.0 * torch.log10(mag),
                            noise_power)


class CfarDetector(_CfarBase):
    """Cell-averaging CFAR: the threshold is α/N times the train sum."""

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
        super().__init__(pfa, n_guard, n_train, min_delay, min_doppler,
                         delay_axis, doppler_axis, max_detections,
                         real_dtype, device)
        # alpha/cnt scales the train *sum*: threshold = alpha * sum/cnt.
        self._buf("_thresh_scale", cfar_threshold_scale(
            self.pfa, self.n_guard, self.n_train, self.n_cols), real_dtype)

    def _hits(self, power: torch.Tensor) -> torch.Tensor:
        train = torch.zeros_like(power)
        for s in self._train_slices(power, 0.0):
            train = train + s
        return power > self._thresh_scale.to(power.device)[None, :] * train


class OsCfarDetector(_CfarBase):
    """Ordered-statistics CFAR across delay, per Doppler row.

    The threshold is α · (the k-th smallest train-cell power) instead of
    α · mean, which keeps a target inside another's train window from
    masking it. Rank k = ⌈rank·N⌉ (Rohling's 3/4 by default) and α are
    solved per column from the edge-shrunk train count N
    (:func:`os_cfar_alpha`). The train windows are the CA detector's
    shifted slices stacked on a trailing axis of 2·n_train and sorted
    there; out-of-map cells and the k>0 left-train quirk cell are +inf, so
    they sort last.
    """

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
        rank: float = 0.75,
        real_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.rank = float(rank)
        if not 0.0 < self.rank <= 1.0:
            raise ValueError(f"OS-CFAR rank must be in (0, 1], got {rank}")
        super().__init__(pfa, n_guard, n_train, min_delay, min_doppler,
                         delay_axis, doppler_axis, max_detections,
                         real_dtype, device)
        cnt = cfar_train_count(self.n_guard, self.n_train, self.n_cols)
        k = np.maximum(1, np.ceil(self.rank * cnt)).astype(np.int64)
        self._buf("_k_idx", np.minimum(k - 1, 2 * self.n_train - 1),
                  torch.int64)
        # Solved in float64, cast to the map's real dtype.
        self._buf("_alpha", np.asarray([
            os_cfar_alpha(self.pfa, int(n), int(kk))
            for n, kk in zip(cnt, k)]), real_dtype)

    def _hits(self, power: torch.Tensor) -> torch.Tensor:
        train = torch.sort(torch.stack(
            list(self._train_slices(power, float("inf"))), dim=-1),
            dim=-1).values
        dev = power.device
        idx = self._k_idx.to(dev).reshape((1,) * (train.dim() - 2) + (-1, 1))
        kth = torch.take_along_dim(train, idx, dim=-1)[..., 0]
        threshold = self._alpha.to(dev)[None, :] * kth
        return (power > threshold) & torch.isfinite(threshold)


def make_cfar(det_cfg, delay_axis, doppler_axis, max_detections: int = 128,
              real_dtype: torch.dtype = torch.float32, device=None):
    """CFAR factory by config: ``process.detection.cfar`` ∈ {"ca", "os"}
    ("ca" is the reference algorithm)."""
    kind = (getattr(det_cfg, "cfar", "ca") or "ca").lower()
    common = dict(
        pfa=det_cfg.pfa, n_guard=det_cfg.n_guard, n_train=det_cfg.n_train,
        min_delay=det_cfg.min_delay, min_doppler=det_cfg.min_doppler,
        delay_axis=delay_axis, doppler_axis=doppler_axis,
        max_detections=max_detections, real_dtype=real_dtype, device=device)
    if kind in ("os", "os-cfar", "oscfar"):
        return OsCfarDetector(rank=getattr(det_cfg, "os_rank", 0.75),
                              **common)
    if kind in ("ca", "ca-cfar", "cacfar"):
        return CfarDetector(**common)
    raise ValueError(f"unknown process.detection.cfar: {kind!r}")
