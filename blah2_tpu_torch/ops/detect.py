"""Fused map metrics + CA-CFAR + centroid suppression (counterpart of
``blah2_tpu/ops/pallas_detect.py``).

One pass over the delay-Doppler power map gives, in place of four separate
stages (``map_metrics``, ``CfarDetector``, ``CentroidFilter``):

  - the dB map 5·log10(p) (= 10·log10|z|);
  - noise = mean(dB) and rawmax = max(0, max dB) (`Map.cpp:188-206`);
  - the CA-CFAR hit mask: train sums over ``n_train`` cells past ``n_guard``
    guards on each side along delay, the left side skipping column 0 (the
    reference's k>0 quirk), a per-column scale α/N and a cell mask for
    ``min_delay`` and ``min_doppler`` (`CfarDetector1D.cpp:57-83`);
  - centroid suppression: a hit survives iff its power equals the max of
    hit power over ±win_rows × ±win_cols (`Centroid.cpp:34-69`, strict
    inequality, so equal peaks both survive).

On the card this is the hand-written kernel ``csrc/detect.cu``; on the CPU
it is :func:`detect_plain`, the same function in plain torch. The wrapper
:data:`detect` chooses by the device of the tensor it is given and nothing
else: a CUDA tensor launches the kernel or raises.

As in the JAX module, the grid form centroids every hit cell while the
unfused chain centroids the capacity-capped list: the two agree whenever the
hit count fits ``max_detections``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blah2_tpu_torch.device import as_numpy, resolve_device
from blah2_tpu_torch.dsp.cfar import (CfarDetections, cfar_threshold_scale,
                                      extract_topk)


class DetectKernelOutputs(NamedTuple):
    db: torch.Tensor      # ([B,] nr, nc) f32 absolute dB map
    keep: torch.Tensor    # ([B,] nr, nc) f32 {0,1}: hit surviving centroid
    noise: torch.Tensor   # ([B]) f32 mean dB of each map
    rawmax: torch.Tensor  # ([B]) f32 max(0, max dB) of each map


def detect_plain(pwr: torch.Tensor, scale: torch.Tensor,
                 cell_ok: torch.Tensor, n_guard: int, n_train: int,
                 win_rows: int, win_cols: int) -> DetectKernelOutputs:
    """The detect function in plain torch, the kernel's twin: ``pwr`` an
    (nr, nc) f32 power map or a (B, nr, nc) stack of them, ``scale``
    (1, nc) α/N, ``cell_ok`` (nr, nc) {0, 1}, both shared by the stack."""
    nr, nc = pwr.shape[-2:]
    db = 5.0 * torch.log10(pwr)
    noise = torch.sum(db, dim=(-2, -1)) * (1.0 / (nr * nc))
    rawmax = torch.clamp(torch.amax(db, dim=(-2, -1)), min=0.0)

    # Train sums in the kernel's order: for each offset, left then right.
    # Left cells read a copy with column 0 zeroed (the k>0 quirk).
    pwr_l = pwr.clone()
    pwr_l[..., 0] = 0.0
    left = F.pad(pwr_l, (n_guard + n_train, 0))
    right = F.pad(pwr, (0, n_guard + n_train))
    train = torch.zeros_like(pwr)
    for o in range(n_guard + 1, n_guard + n_train + 1):
        train = train + left[..., n_guard + n_train - o:
                             n_guard + n_train - o + nc]
        train = train + right[..., o: o + nc]
    hit = (pwr > scale * train) & (cell_ok > 0.0)

    # Window max of hit power; power is >= 0 and the window holds its own
    # cell, so max pooling's -inf padding is the clipped window.
    m = torch.where(hit, pwr, 0.0)
    wmax = F.max_pool2d(m.reshape(-1, 1, nr, nc),
                        (2 * win_rows + 1, 2 * win_cols + 1), stride=1,
                        padding=(win_rows, win_cols)).reshape(pwr.shape)
    keep = (hit & (pwr >= wmax)).to(torch.float32)
    return DetectKernelOutputs(db, keep, noise, rawmax)


def _check(pwr, scale, cell_ok, *ints):
    if pwr.dim() not in (2, 3) or pwr.numel() == 0:
        raise ValueError(f"detect: pwr must be a non-empty (nr, nc) map or "
                         f"(B, nr, nc) stack, got shape {tuple(pwr.shape)}")
    nr, nc = pwr.shape[-2:]
    if nr * nc >= 2 ** 31:
        raise ValueError("detect: map too large for 32-bit indexing")
    if pwr.dim() == 3 and not 1 <= pwr.shape[0] <= 65535:
        raise ValueError(f"detect: a stack holds 1 to 65535 maps, got "
                         f"{pwr.shape[0]}")
    want = {"pwr": (pwr, tuple(pwr.shape)), "scale": (scale, (1, nc)),
            "cell_ok": (cell_ok, (nr, nc))}
    for name, (t, shape) in want.items():
        if t.device != pwr.device:
            raise ValueError(f"detect: {name} is on {t.device}, pwr on "
                             f"{pwr.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"detect: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"detect: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"detect: {name} must be contiguous")
    if any(int(v) < 0 for v in ints):
        raise ValueError(f"detect: window extents must be >= 0, got {ints}")


class DetectKernel:
    """Wrapper of the CUDA kernel ``csrc/detect.cu``: CPU tensors take
    :func:`detect_plain`; CUDA tensors launch the kernel (three launches on
    the current stream, for one map or a (B, nr, nc) stack) or raise.
    ``launches`` counts the calls that launched the kernel."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from blah2_tpu_torch.ops import _build

            lib = _build.load("detect")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.detect_scratch_floats.argtypes = [ci, ci, ci]
            lib.detect_scratch_floats.restype = ctypes.c_longlong
            lib.detect_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            lib.detect_launch.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, pwr: torch.Tensor, scale: torch.Tensor,
                 cell_ok: torch.Tensor, n_guard: int, n_train: int,
                 win_rows: int, win_cols: int) -> DetectKernelOutputs:
        if pwr.device.type == "cpu":
            return detect_plain(pwr, scale, cell_ok, n_guard, n_train,
                                win_rows, win_cols)
        if pwr.device.type != "cuda":
            raise ValueError(f"detect: unsupported device {pwr.device}")
        _check(pwr, scale, cell_ok, n_guard, n_train, win_rows, win_cols)
        lib = self._library()
        nr, nc = pwr.shape[-2:]
        batch = pwr.shape[0] if pwr.dim() == 3 else 1
        db = torch.empty_like(pwr)
        keep = torch.empty_like(pwr)
        noise = torch.empty(pwr.shape[:-2], dtype=torch.float32,
                            device=pwr.device)
        rawmax = torch.empty_like(noise)
        scratch = torch.empty(lib.detect_scratch_floats(batch, nr, nc),
                              dtype=torch.float32, device=pwr.device)
        with torch.cuda.device(pwr.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.detect_launch(
                pwr.data_ptr(), scale.data_ptr(), cell_ok.data_ptr(),
                db.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
                noise.data_ptr(), rawmax.data_ptr(), batch, nr, nc,
                int(n_guard),
                int(n_train), int(win_rows), int(win_cols), stream)
        if err != 0:
            raise RuntimeError(f"detect kernel launch failed: CUDA error {err}")
        self.launches += 1
        return DetectKernelOutputs(db, keep, noise, rawmax)


#: The detect wrapper used by :class:`FusedDetector`; its ``launches``
#: count shows whether a run went through the kernel.
detect = DetectKernel()


class FusedDetector(nn.Module):
    """Metrics + CFAR + centroid on the CPI map in one call.

    Gives the same ``(db, noise, max_power)`` as
    :func:`blah2_tpu_torch.dsp.ambiguity.map_metrics` and the same
    :class:`CfarDetections` as ``CentroidFilter(CfarDetector(...))`` when the
    hit count fits ``max_detections``.
    """

    def __init__(
        self,
        pfa: float,
        n_guard: int,
        n_train: int,
        min_delay: int,
        min_doppler: float,
        n_centroid_delay: int,
        n_centroid_doppler: int,
        centroid_doppler_resolution: float,  # Hz window half-step (1/tCpi cfg)
        delay_axis,
        doppler_axis,
        max_detections: int = 128,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        delay_axis = as_numpy(delay_axis)
        doppler_axis = as_numpy(doppler_axis).astype(np.float64)
        self.n_rows = nr = len(doppler_axis)
        self.n_cols = nc = len(delay_axis)
        self.max_detections = int(max_detections)
        self.n_guard, self.n_train = int(n_guard), int(n_train)

        # Centroid window half-extents on the map grid. Delay values are
        # integer bins, so strict |Δdelay| < n_delay ⇒ |Δcol| ≤ n_delay−1.
        # Doppler: strict |Δrow|·res_map < n_doppler·res_cfg.
        self.win_cols = max(0, int(n_centroid_delay) - 1)
        res_map = float(doppler_axis[1] - doppler_axis[0]) if nr > 1 else 1.0
        bound = float(n_centroid_doppler) * float(centroid_doppler_resolution)
        self.win_rows = max(0, int(np.ceil(bound / res_map - 1e-9)) - 1)

        row_ok = np.abs(doppler_axis) >= float(min_doppler)
        col_ok = delay_axis >= int(min_delay)
        scale = cfar_threshold_scale(pfa, self.n_guard, self.n_train, nc)

        def buf(name, a):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(device, torch.float32))

        buf("_scale", scale[None, :])
        buf("_cell_ok", row_ok[:, None] & col_ok[None, :])
        buf("_delay_f32", delay_axis)
        buf("_doppler_f32", doppler_axis)

    @classmethod
    def from_config(cls, proc, ambiguity, max_detections: int = 128,
                    device=None) -> "FusedDetector":
        """Build from a ``config.process`` section and an
        :class:`AmbiguityProcessor`."""
        det = proc.detection
        return cls(
            det.pfa, det.n_guard, det.n_train, det.min_delay,
            det.min_doppler, det.n_centroid, det.n_centroid,
            # Centroid Doppler window uses the configured CPI (1/tCpi), as
            # in `src/blah2.cpp:186`.
            1.0 / proc.data.cpi,
            ambiguity.delay_axis, ambiguity.doppler_axis,
            max_detections=max_detections, device=device,
        )

    def forward(self, z: torch.Tensor):
        """z: complex (nr, nc) ambiguity map, or a (B, nr, nc) stack of
        them in one kernel call. Returns ``(db, noise, max_power,
        detections)``, each with the stack's leading dimension."""
        zr, zi = z.real, z.imag
        pwr = (zr * zr + zi * zi).to(torch.float32).contiguous()
        db, keep, noise, rawmax = detect(
            pwr, self._scale, self._cell_ok, self.n_guard, self.n_train,
            self.win_rows, self.win_cols)
        lead = pwr.shape[:-2]
        flat = keep.reshape(lead + (-1,)) > 0.0
        row, col, valid, count = extract_topk(flat, self.n_cols,
                                              self.max_detections)
        if lead:
            snr = db.reshape(lead + (-1,)).gather(-1, row * self.n_cols + col)
        else:
            snr = db[row, col]
        det = CfarDetections(
            row=row,
            col=col,
            delay=self._delay_f32[col],
            doppler=self._doppler_f32[row],
            snr=snr - noise.unsqueeze(-1),
            valid=valid,
            count=count,
        )
        return db, noise, rawmax - noise, det
