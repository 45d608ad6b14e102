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

The input is the float32 power map p = |z|² (the TPU kernel's input), or
the complex64 map z itself, whose power is formed as re·re + im·im.

On the card this is the hand-written kernel ``csrc/detect.cu``, one launch
over tiles of the map (:func:`tile_geometry`); on the CPU it is
:func:`detect_plain`, the same function in plain torch. The wrapper
:data:`detect` chooses by the device of the tensor it is given and nothing
else: a CUDA tensor launches the kernel or raises.

As in the JAX module, the grid form centroids every hit cell while the
unfused chain centroids the capacity-capped list: the two agree whenever the
hit count fits ``max_detections``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blah2_tpu_torch.device import (as_numpy, current_stream_handle,
                                    resolve_device)
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
    (nr, nc) f32 power map or a (B, nr, nc) stack of them, or the complex
    map(s) whose power re·re + im·im it forms first; ``scale`` (1, nc) α/N,
    ``cell_ok`` (nr, nc) {0, 1}, both shared by the stack."""
    if pwr.is_complex():
        pwr = (pwr.real * pwr.real + pwr.imag * pwr.imag).to(torch.float32)
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


#: The kernel's tile (``kTileRows`` x ``kTileCols`` of ``csrc/detect.cu``;
#: the wrapper checks the library agrees). 24 x 48 cuts a 301 x 411 map
#: into 13 x 9 = 117 blocks, one wave on the H100's 132 SMs.
TILE_ROWS, TILE_COLS = 24, 48
#: Shared memory a block may use on Hopper, and the kernel's static part.
MAX_SMEM_BYTES = 232_448
STATIC_SMEM_BYTES = 2 * 32 * 4 + 16


class TileGeometry(NamedTuple):
    tile_rows: int        # map rows a block keeps
    tile_cols: int        # map columns a block keeps
    halo_rows: int        # rows loaded above and below the tile
    halo_cols: int        # power columns loaded left and right of the tile
    hit_halo_cols: int    # hit-power columns formed left and right
    grid: tuple           # (column tiles, row tiles) per map
    smem_bytes: int       # dynamic shared memory of a block


@functools.lru_cache(maxsize=64)
def tile_geometry(nr: int, nc: int, n_guard: int, n_train: int,
                  win_rows: int, win_cols: int, tile_rows: int = TILE_ROWS,
                  tile_cols: int = TILE_COLS) -> TileGeometry:
    """How the kernel tiles an (nr, nc) map: a block keeps a tile and loads
    its power with ``halo_rows`` rows (the centroid window) and
    ``halo_cols`` columns (the CFAR reach plus the window) on each side,
    and forms hit power over the tile with the window's halo
    (``hit_halo_cols`` columns). Shared memory holds the power and cell_ok
    (then hit power) over the loaded region, scale, the power of map
    column 0 and the row maxima (``smem_floats`` of ``csrc/detect.cu``,
    whose launcher refuses less). Raises where a block's shared memory
    would pass Hopper's 227 KB. Another tile than the kernel's is for
    builds of the kernel with other tile constants."""
    rh = tile_rows + 2 * win_rows
    halo_cols = n_guard + n_train + win_cols
    pw = tile_cols + 2 * halo_cols
    mw = tile_cols + 2 * win_cols
    smem = 4 * (2 * rh * pw + pw + rh + tile_rows * mw)
    if smem + STATIC_SMEM_BYTES > MAX_SMEM_BYTES:
        raise ValueError(f"detect: windows (guard {n_guard}, train "
                         f"{n_train}, centroid {win_rows} x {win_cols}) need "
                         f"{smem} B of shared memory a block, more than "
                         f"Hopper's {MAX_SMEM_BYTES - STATIC_SMEM_BYTES}")
    return TileGeometry(tile_rows, tile_cols, win_rows, halo_cols, win_cols,
                        (-(-nc // tile_cols), -(-nr // tile_rows)), smem)


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
    if pwr.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"detect: pwr must be float32 power or a complex64 "
                        f"map, got {pwr.dtype}")
    for name, t, shape in (("pwr", pwr, pwr.shape), ("scale", scale, (1, nc)),
                           ("cell_ok", cell_ok, (nr, nc))):
        if t.device != pwr.device:
            raise ValueError(f"detect: {name} is on {t.device}, pwr on "
                             f"{pwr.device}")
        if t is not pwr and t.dtype != torch.float32:
            raise TypeError(f"detect: {name} must be float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"detect: {name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"detect: {name} must be contiguous")
    if any(int(v) < 0 for v in ints):
        raise ValueError(f"detect: window extents must be >= 0, got {ints}")


class DetectKernel:
    """Wrapper of the CUDA kernel ``csrc/detect.cu``: CPU tensors take
    :func:`detect_plain`; CUDA tensors launch the kernel (one launch on the
    current stream, for one map or a (B, nr, nc) stack, float32 power or
    complex64) or raise. ``launches`` counts the kernel launches."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        # Ticket counters and partials: one buffer per (device, stream), as
        # two streams must not share a counter, held with the (B, nr, nc)
        # it was last laid out for.
        self._scratch: dict = {}

    def _library(self):
        if self._lib is None:
            from blah2_tpu_torch.ops import _build

            lib = _build.load("detect")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.detect_tile_rows, lib.detect_tile_cols,
                       lib.detect_static_smem):
                fn.argtypes, fn.restype = [], ci
            tile = (lib.detect_tile_rows(), lib.detect_tile_cols())
            if tile != (TILE_ROWS, TILE_COLS) \
                    or lib.detect_static_smem() != STATIC_SMEM_BYTES:
                raise RuntimeError(f"detect: csrc/detect.cu tiles {tile}, "
                                   f"ops/detect.py {(TILE_ROWS, TILE_COLS)}")
            lib.detect_scratch_words.argtypes = [ci, ci, ci]
            lib.detect_scratch_words.restype = ctypes.c_longlong
            lib.detect_launch.argtypes = ([vp, ci] + [vp] * 7 + [ci] * 9
                                          + [vp])
            lib.detect_launch.restype = ci
            self._lib = lib
        return self._lib

    def __call__(self, pwr: torch.Tensor, scale: torch.Tensor,
                 cell_ok: torch.Tensor, n_guard: int, n_train: int,
                 win_rows: int, win_cols: int) -> DetectKernelOutputs:
        dev = pwr.device
        if dev.type == "cpu":
            return detect_plain(pwr, scale, cell_ok, n_guard, n_train,
                                win_rows, win_cols)
        if dev.type != "cuda":
            raise ValueError(f"detect: unsupported device {dev}")
        _check(pwr, scale, cell_ok, n_guard, n_train, win_rows, win_cols)
        lib = self._library()
        g, t, wr, wc = int(n_guard), int(n_train), int(win_rows), \
            int(win_cols)
        lead, (nr, nc) = pwr.shape[:-2], pwr.shape[-2:]
        batch = lead[0] if lead else 1
        geo = tile_geometry(nr, nc, g, t, wr, wc)
        stream = current_stream_handle(dev.index)
        key, layout = (dev.index, stream), (batch, nr, nc)
        held = self._scratch.get(key)
        if held is None or held[0] != layout:
            # A new layout puts the counters where partials may lie: zero
            # them, on this stream, after the launches that used the old.
            words = lib.detect_scratch_words(batch, nr, nc)
            if held is not None and held[1].numel() >= words:
                held[1][:batch].zero_()
                held = (layout, held[1])
            else:
                held = (layout, torch.zeros(words, dtype=torch.int32,
                                            device=dev))
            self._scratch[key] = held
        scratch = held[1]
        maps = torch.empty((2,) + tuple(pwr.shape), dtype=torch.float32,
                           device=dev)
        stats = torch.empty((2,) + tuple(lead), dtype=torch.float32,
                            device=dev)
        db, keep = maps.unbind(0)
        noise, rawmax = stats.unbind(0)
        err = lib.detect_launch(
            pwr.data_ptr(), int(pwr.is_complex()), scale.data_ptr(),
            cell_ok.data_ptr(), db.data_ptr(), keep.data_ptr(),
            scratch.data_ptr(), noise.data_ptr(), rawmax.data_ptr(), batch,
            nr, nc, g, t, wr, wc, geo.smem_bytes, dev.index, stream)
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
        detections)``, each with the stack's leading dimension. A complex64
        map goes to the kernel as it is, which forms |z|² itself; complex128
        is reduced to float32 power first, as the JAX detector does."""
        if z.dtype == torch.complex64:
            m = z.contiguous()
        else:
            zr, zi = z.real, z.imag
            m = (zr * zr + zi * zi).to(torch.float32).contiguous()
        db, keep, noise, rawmax = detect(
            m, self._scale, self._cell_ok, self.n_guard, self.n_train,
            self.win_rows, self.win_cols)
        lead = m.shape[:-2]
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
