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

The row-block mode (:meth:`DetectKernel.rows`, :func:`detect_rows_plain`)
serves the row-sharded pipeline, where each pulse rank holds a block of the
map's rows: per block its kept rows with ``win_rows`` rows above and below
(from the neighbouring ranks), and the map row of its first kept row. Rows
outside the map (halo rows past its edges, phantom rows past ``nr``) count
as outside it. It gives db and keep of the kept rows, the bits that the
single-map mode gives on the whole map, and per block the dB sum and
max(0, max dB) over the kept rows inside the map, which the caller reduces
over the ranks in place of noise and rawmax.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blah2_tpu_torch.device import (as_numpy, current_stream_handle,
                                    resolve_device)
from blah2_tpu_torch.dsp.cfar import (CfarDetections, cfar_threshold_scale,
                                      extract_topk)
from blah2_tpu_torch.dsp.graph import COUNTERS


class DetectKernelOutputs(NamedTuple):
    db: torch.Tensor      # ([B,] nr, nc) f32 absolute dB map
    keep: torch.Tensor    # ([B,] nr, nc) f32 {0,1}: hit surviving centroid
    noise: torch.Tensor   # ([B]) f32 mean dB of each map
    rawmax: torch.Tensor  # ([B]) f32 max(0, max dB) of each map


class DetectBlockOutputs(NamedTuple):
    db: torch.Tensor      # (N, R, nc) f32 dB of each block's kept rows
    keep: torch.Tensor    # (N, R, nc) f32 {0,1}: hit surviving centroid
    sums: torch.Tensor    # (N,) f32 dB sum over kept rows inside the map
    maxes: torch.Tensor   # (N,) f32 max(0, their max dB)


class _RowPlan(NamedTuple):
    kept: int             # kept rows a block
    nc: int
    complex_input: int    # 1: complex64 parts, 0: float32 power
    windows: tuple        # (n_guard, n_train, win_rows, win_cols)
    smem_bytes: int
    launches: tuple       # (first block, pointer table, first rows, word)


def _power(pwr: torch.Tensor) -> torch.Tensor:
    """Float32 power: ``pwr`` itself, or re·re + im·im of a complex map."""
    if pwr.is_complex():
        return (pwr.real * pwr.real + pwr.imag * pwr.imag).to(torch.float32)
    return pwr


def detect_plain(pwr: torch.Tensor, scale: torch.Tensor,
                 cell_ok: torch.Tensor, n_guard: int, n_train: int,
                 win_rows: int, win_cols: int) -> DetectKernelOutputs:
    """The detect function in plain torch, the kernel's twin: ``pwr`` an
    (nr, nc) f32 power map or a (B, nr, nc) stack of them, or the complex
    map(s) whose power re·re + im·im it forms first; ``scale`` (1, nc) α/N,
    ``cell_ok`` (nr, nc) {0, 1}, both shared by the stack."""
    pwr = _power(pwr)
    nr, nc = pwr.shape[-2:]
    db = 5.0 * torch.log10(pwr)
    noise = torch.sum(db, dim=(-2, -1)) * (1.0 / (nr * nc))
    rawmax = torch.clamp(torch.amax(db, dim=(-2, -1)), min=0.0)
    keep = _keep(pwr, scale, cell_ok, n_guard, n_train, win_rows, win_cols)
    return DetectKernelOutputs(db, keep, noise, rawmax)


def detect_rows_plain(pwr: torch.Tensor, first_rows, n_rows: int,
                      scale: torch.Tensor, cell_ok: torch.Tensor,
                      n_guard: int, n_train: int, win_rows: int,
                      win_cols: int) -> DetectBlockOutputs:
    """The row-block mode in plain torch, the kernel's twin: ``pwr`` an
    (N, R + 2·win_rows, nc) stack of blocks (f32 power or complex), block
    k holding map rows ``first_rows[k]`` − win_rows … ``first_rows[k]`` +
    R + win_rows − 1; ``cell_ok`` the map's (n_rows, nc). Rows outside
    [0, n_rows) are outside the map: power 0, cell_ok 0."""
    pwr = _power(pwr)
    n, rows, nc = pwr.shape
    kept = rows - 2 * win_rows
    first = torch.as_tensor(first_rows, dtype=torch.int64, device=pwr.device)
    g = first[:, None] - win_rows + torch.arange(rows, device=pwr.device)
    inside = ((g >= 0) & (g < n_rows))[..., None]
    pwr = torch.where(inside, pwr, 0.0)
    ok = cell_ok[g.clamp(0, n_rows - 1)] * inside
    keep = _keep(pwr, scale, ok, n_guard, n_train, win_rows,
                 win_cols)[:, win_rows:win_rows + kept]
    db = 5.0 * torch.log10(pwr[:, win_rows:win_rows + kept])
    inside = inside[:, win_rows:win_rows + kept]
    sums = torch.sum(torch.where(inside, db, 0.0), dim=(-2, -1),
                     dtype=torch.float64).to(torch.float32)
    maxes = torch.clamp(torch.amax(torch.where(inside, db, -torch.inf),
                                   dim=(-2, -1)), min=0.0)
    return DetectBlockOutputs(db, keep, sums, maxes)


def _keep(pwr, scale, cell_ok, n_guard, n_train, win_rows, win_cols):
    """CA-CFAR hits along delay and centroid keep of (..., rows, nc)
    power, as f32 {0, 1}."""
    nr, nc = pwr.shape[-2:]
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
    return (hit & (pwr >= wmax)).to(torch.float32)


#: The kernel's tile (``kTileRows`` x ``kTileCols`` of ``csrc/detect.cu``;
#: the wrapper checks the library agrees). 24 x 48 cuts a 301 x 411 map
#: into 13 x 9 = 117 blocks, one wave on the H100's 132 SMs.
TILE_ROWS, TILE_COLS = 24, 48
#: The row-block mode's tile rows (``kBlockTileRows``): four 76-row blocks
#: (a 1 x 4 mesh at the default config) in 4 x 3 x 9 = 108 blocks, one wave.
BLOCK_TILE_ROWS = 32
#: Row blocks a launch takes (``kMaxBlocks``); more go in several launches.
MAX_BLOCKS = 128
#: Shared memory a block may use on Hopper, and the kernel's static part.
MAX_SMEM_BYTES = 232_448
STATIC_SMEM_BYTES = 2 * 32 * 4 + 4 + 4 * max(TILE_ROWS, BLOCK_TILE_ROWS)


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


def _check_rows(blocks, first_rows, n_rows, scale, cell_ok, dev, *ints):
    kept, nc = blocks[0][1].shape
    dtype = blocks[0][1].dtype
    win_rows = int(ints[2])
    if dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"detect: blocks must be float32 power or "
                        f"complex64, got {dtype}")
    if any(int(v) < 0 for v in ints):
        raise ValueError(f"detect: window extents must be >= 0, got {ints}")
    if len(first_rows) != len(blocks):
        raise ValueError(f"detect: {len(first_rows)} first rows for "
                         f"{len(blocks)} blocks")
    if max(n_rows, len(blocks) * kept) * nc >= 2 ** 31:
        raise ValueError("detect: blocks too large for 32-bit indexing")
    for name, t, shape in (("scale", scale, (1, nc)),
                           ("cell_ok", cell_ok, (n_rows, nc))):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"detect: {name} must be a contiguous float32 "
                             f"{shape} on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    shapes = ((win_rows, nc), (kept, nc), (win_rows, nc))
    for b in blocks:
        for t, shape in zip(b, shapes):
            rows_ok = t.numel() == 0 or (
                t.stride(1) == 1 and (t.shape[0] == 1 or t.stride(0) == nc))
            if (t.shape != shape or t.dtype != dtype or t.device != dev
                    or not rows_ok):
                raise ValueError(
                    f"detect: a block's parts must be {shapes} {dtype} with "
                    f"contiguous rows on {dev}, got {tuple(t.shape)} "
                    f"{t.dtype} strides {t.stride()} on {t.device}")


class DetectKernel:
    """Wrapper of the CUDA kernel ``csrc/detect.cu``: CPU tensors take
    :func:`detect_plain`; CUDA tensors launch the kernel (one launch on the
    current stream, for one map or a (B, nr, nc) stack, float32 power or
    complex64) or raise. ``launches`` counts the kernel launches, of both
    modes; ``row_launches`` those of the row-block mode (:meth:`rows`). A
    CUDA graph that holds launches adds them on every replay
    (:meth:`add_launches`), so the counts stay kernel launches."""

    def __init__(self):
        self.launches = 0
        self.row_launches = 0
        self._lib = None
        # Ticket counters and partials: one buffer per (device, stream), as
        # two streams must not share a counter, held with the (B, nr, nc)
        # it was last laid out for; the row-block mode's apart.
        self._scratch: dict = {}
        self._row_scratch: dict = {}
        # The row-block mode's checked layouts (:meth:`_row_plan`).
        self._row_plans: dict = {}

    def _library(self):
        if self._lib is None:
            from blah2_tpu_torch.ops import _build

            lib = _build.load("detect")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.detect_tile_rows, lib.detect_tile_cols,
                       lib.detect_block_tile_rows, lib.detect_max_blocks,
                       lib.detect_static_smem):
                fn.argtypes, fn.restype = [], ci
            tile = (lib.detect_tile_rows(), lib.detect_tile_cols(),
                    lib.detect_block_tile_rows(), lib.detect_max_blocks(),
                    lib.detect_static_smem())
            want = (TILE_ROWS, TILE_COLS, BLOCK_TILE_ROWS, MAX_BLOCKS,
                    STATIC_SMEM_BYTES)
            if tile != want:
                raise RuntimeError(f"detect: csrc/detect.cu tiles, blocks "
                                   f"and static shared memory {tile}, "
                                   f"ops/detect.py {want}")
            for fn in (lib.detect_scratch_words,
                       lib.detect_block_scratch_words):
                fn.argtypes = [ci, ci, ci]
                fn.restype = ctypes.c_longlong
            lib.detect_launch.argtypes = ([vp, ci] + [vp] * 7 + [ci] * 9
                                          + [vp])
            lib.detect_launch.restype = ci
            lib.detect_launch_blocks.argtypes = (
                [ci, ctypes.POINTER(vp), ctypes.POINTER(ci), ci]
                + [vp] * 7 + [ci] * 9 + [vp])
            lib.detect_launch_blocks.restype = ci
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
        scratch = self._scratch_for(self._scratch, dev, stream, batch, nr,
                                    nc, lib.detect_scratch_words)
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

    def add_launches(self, launches: int, row_launches: int = 0) -> None:
        """Count launches made without a call of this wrapper: a CUDA
        graph's replay adds those it holds; its capture, which launches
        nothing, takes back what its calls counted."""
        self.launches += launches
        self.row_launches += row_launches

    def snapshot(self) -> dict:
        """The counts by name, for ``dsp/graph.py`` ``COUNTERS``."""
        return {"detect": self.launches, "detect_rows": self.row_launches}

    def add(self, delta: dict, sign: int = 1) -> None:
        """Add ``sign`` times ``delta``'s entries of :meth:`snapshot`'s
        names."""
        self.add_launches(sign * delta.get("detect", 0),
                          sign * delta.get("detect_rows", 0))

    def scratch(self, device_index: int, stream: int, rows: bool = False):
        """The map mode's scratch (the row-block mode's, with ``rows``) on
        card ``device_index`` and stream handle ``stream`` (int32: one
        ticket counter per map or block, then the partials), or None
        before a launch there."""
        table = self._row_scratch if rows else self._scratch
        held = table.get((device_index, stream))
        return None if held is None else held[1]

    @staticmethod
    def _scratch_for(table, dev, stream, batch, rows, nc, words_of):
        """The ticket counters and partials of a launch on ``stream``, laid
        out for ``batch`` maps or blocks of ``rows`` rows, from ``table``
        (one per mode)."""
        key, layout = (dev.index, stream), (batch, rows, nc)
        held = table.get(key)
        if held is None or held[0] != layout:
            # A new layout puts counters where partials may lie: zero the
            # buffer, on this stream, after the launches that used the old.
            words = words_of(batch, rows, nc)
            if held is not None and held[1].numel() >= words:
                held[1].zero_()
                held = (layout, held[1])
            else:
                held = (layout, torch.zeros(words, dtype=torch.int32,
                                            device=dev))
            table[key] = held
        return held[1]

    def rows(self, blocks, first_rows, n_rows: int, scale: torch.Tensor,
             cell_ok: torch.Tensor, n_guard: int, n_train: int,
             win_rows: int, win_cols: int) -> DetectBlockOutputs:
        """The row-block mode: ``blocks`` a list of (above, kept, below)
        row parts, (win_rows, nc), (R, nc) and (win_rows, nc), each with
        contiguous rows, all float32 power or all complex64, on one device;
        ``first_rows`` the map row of each block's first kept row;
        ``cell_ok`` the map's (n_rows, nc). CPU parts take
        :func:`detect_rows_plain` on the blocks joined; CUDA parts launch
        the kernel on them where they lie, one launch for up to
        :data:`MAX_BLOCKS` blocks, or raise."""
        dev = blocks[0][1].device
        if dev.type == "cpu":
            return detect_rows_plain(
                torch.stack([torch.cat(b, dim=-2) for b in blocks]),
                first_rows, n_rows, scale, cell_ok, n_guard, n_train,
                win_rows, win_cols)
        if dev.type != "cuda":
            raise ValueError(f"detect: unsupported device {dev}")
        stream = current_stream_handle(dev.index)
        # The checks and the launches' tables hold for every call with the
        # same layout: parts' shapes, strides, types and cards, the
        # constants', the windows and the blocks' first rows (and the
        # thread, whose calls refill the pointer tables).
        key = (tuple([(t.shape, t.stride(), t.dtype, t.get_device())
                      for b in blocks for t in b]), tuple(first_rows),
               int(n_rows), scale.shape, scale.stride(), scale.dtype,
               scale.get_device(), cell_ok.shape, cell_ok.stride(),
               cell_ok.dtype, cell_ok.get_device(), int(n_guard),
               int(n_train), int(win_rows), int(win_cols),
               threading.get_ident())
        plan = self._row_plans.get(key)
        if plan is None:
            plan = self._row_plan(blocks, first_rows, n_rows, scale, cell_ok,
                                  dev, n_guard, n_train, win_rows, win_cols)
            if len(self._row_plans) >= 64:
                self._row_plans.clear()
            self._row_plans[key] = plan
        n, kept, nc = len(blocks), plan.kept, plan.nc
        lib = self._lib
        # Scratch per call: another layout on this stream zeroes it.
        scratch = self._scratch_for(self._row_scratch, dev, stream, n, kept,
                                    nc, lib.detect_block_scratch_words) \
            .data_ptr()
        maps = torch.empty((2, n, kept, nc), dtype=torch.float32, device=dev)
        stats = torch.empty((2, n), dtype=torch.float32, device=dev)
        out, st, cell = maps.data_ptr(), stats.data_ptr(), kept * nc
        for a, ptrs, rows0, word in plan.launches:
            ptrs[:] = [b[k].data_ptr() for k in range(3)
                       for b in blocks[a:a + MAX_BLOCKS]]
            err = lib.detect_launch_blocks(
                len(rows0), ptrs, rows0, plan.complex_input,
                scale.data_ptr(), cell_ok.data_ptr(), out + 4 * a * cell,
                out + 4 * (n + a) * cell, scratch + 4 * word, st + 4 * a,
                st + 4 * (n + a), kept, n_rows, nc, *plan.windows,
                plan.smem_bytes, dev.index, stream)
            if err != 0:
                raise RuntimeError(f"detect kernel launch failed: CUDA "
                                   f"error {err}")
            self.launches += 1
            self.row_launches += 1
        db, keep = maps.unbind(0)
        sums, maxes = stats.unbind(0)
        return DetectBlockOutputs(db, keep, sums, maxes)

    def _row_plan(self, blocks, first_rows, n_rows, scale, cell_ok, dev,
                  n_guard, n_train, win_rows, win_cols) -> _RowPlan:
        """Check a row-block layout and lay out its launches: up to
        :data:`MAX_BLOCKS` blocks each, with a pointer table to fill on
        every call, the blocks' first rows and the word of the stream's
        scratch (counters and partials) where the launch's region
        starts."""
        kept, nc = blocks[0][1].shape
        _check_rows(blocks, first_rows, n_rows, scale, cell_ok, dev,
                    n_guard, n_train, win_rows, win_cols)
        lib = self._library()
        windows = (int(n_guard), int(n_train), int(win_rows), int(win_cols))
        geo = tile_geometry(kept, nc, *windows, BLOCK_TILE_ROWS)
        words = lib.detect_block_scratch_words
        launches = []
        for a in range(0, len(blocks), MAX_BLOCKS):
            rows = [int(r) for r in first_rows[a:a + MAX_BLOCKS]]
            launches.append((a, (ctypes.c_void_p * (3 * len(rows)))(),
                             (ctypes.c_int * len(rows))(*rows),
                             words(a, kept, nc)))
        return _RowPlan(kept, nc, int(blocks[0][1].dtype == torch.complex64),
                        windows, geo.smem_bytes, tuple(launches))


#: The detect wrapper used by :class:`FusedDetector`; its ``launches``
#: count shows whether a run went through the kernel. A CUDA graph re-adds
#: what it holds on every replay.
detect = DetectKernel()
COUNTERS.append(detect)


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

    @staticmethod
    def kernel_input(z: torch.Tensor) -> torch.Tensor:
        """What the kernel takes of a complex map: complex64 as it is,
        which the kernel squares itself; complex128 reduced to float32
        power first, as the JAX detector does."""
        if z.dtype == torch.complex64:
            return z
        zr, zi = z.real, z.imag
        return (zr * zr + zi * zi).to(torch.float32)

    def forward(self, z: torch.Tensor):
        """z: complex (nr, nc) ambiguity map, or a (B, nr, nc) stack of
        them in one kernel call. Returns ``(db, noise, max_power,
        detections)``, each with the stack's leading dimension."""
        m = self.kernel_input(z).contiguous()
        db, keep, noise, rawmax = detect(
            m, self._scale, self._cell_ok, self.n_guard, self.n_train,
            self.win_rows, self.win_cols)
        return db, noise, rawmax - noise, self.detections(keep > 0.0, db,
                                                          noise)

    def rows(self, blocks, first_rows) -> DetectBlockOutputs:
        """The row-block mode on this detector's map: ``blocks`` (above,
        kept, below) row parts of :meth:`kernel_input`, ``first_rows`` the
        map row of each block's first kept row (see
        :meth:`DetectKernel.rows`); the blocks may lie on another card than
        the module, and its constants are taken there."""
        dev = blocks[0][1].device
        return detect.rows(blocks, first_rows, self.n_rows,
                           self._scale.to(dev), self._cell_ok.to(dev),
                           self.n_guard, self.n_train, self.win_rows,
                           self.win_cols)

    def detections(self, keep: torch.Tensor, db: torch.Tensor,
                   noise: torch.Tensor) -> CfarDetections:
        """The detection list of ([B,] nr, nc) bool ``keep``: the first
        ``max_detections`` kept cells in raster order, SNR db − noise."""
        lead = keep.shape[:-2]
        flat = keep.reshape(lead + (-1,))
        row, col, valid, count = extract_topk(flat, self.n_cols,
                                              self.max_detections)
        if lead:
            snr = db.reshape(lead + (-1,)).gather(-1, row * self.n_cols + col)
        else:
            snr = db[row, col]
        return CfarDetections(
            row=row,
            col=col,
            delay=self._delay_f32[col],
            doppler=self._doppler_f32[row],
            snr=snr - noise.unsqueeze(-1),
            valid=valid,
            count=count,
        )
