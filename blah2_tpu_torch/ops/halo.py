"""The neighbour permute of the halo exchange (counterpart of
``blah2_tpu/parallel/halo.py::_rdma_permute``).

Every rank of each ring on one mesh axis sends its buffer to its neighbour,
d → d − 1 (``to_left``) or d → d + 1, circularly. With ``mask_edge`` the
ring's edge rank (the last for ``to_left``, rank 0 otherwise) receives
zeros instead of the wrap-around: the open-chain shift of
``parallel/halo.py``. On the card this is the hand-written kernel
``csrc/halo.cu``: one call covers every rank of the mesh, with one launch
per device for that device's ranks. On the CPU it is
:func:`halo_permute_plain`, the same function by tensor copies. The wrapper
:data:`halo_permute` chooses by the device of the buffers it is given and
nothing else: CUDA tensors launch the kernel or raise.

A payload is float32, float64, complex64 or complex128, of any shape whose
leading dimensions step by one stride over runs of contiguous elements: a
(B, n) block sliced ``[..., :count]`` or ``[..., -count:]`` passes as it
lies. The kernel returns, per card, views into one contiguous
``(ranks on the card, *shape)`` tensor of the payload's type.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple

import torch

from blah2_tpu_torch.device import current_stream_handle
from blah2_tpu_torch.parallel.mesh import RadarMesh

#: Flag slots per rank: call sites with no data dependency on each other
#: take distinct ``collective_id``s below this.
MAX_COLLECTIVE_IDS = 8

DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)

#: The epoch argument of a launch on one card, which waits on no flag.
_EPOCH_ONE_CARD = ctypes.c_longlong(0)


def _source(mesh: RadarMesh, axis: str, to_left: bool) -> List[int]:
    """For each rank, the rank whose buffer it receives."""
    src = [0] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        for i, r in enumerate(group):
            src[r] = group[(i + 1) % n] if to_left else group[(i - 1) % n]
    return src


def _edge(mesh: RadarMesh, axis: str, rank: int, to_left: bool) -> bool:
    """Whether ``rank`` is the ring's edge, whose buffer the mask zeroes."""
    return mesh.axis_index(rank, axis) == (mesh.shape[axis] - 1 if to_left
                                           else 0)


def halo_permute_plain(bufs: List[torch.Tensor], mesh: RadarMesh,
                       axis: str = "pulse", to_left: bool = True,
                       mask_edge: bool = False) -> List[torch.Tensor]:
    """The permute by tensor copies, the kernel's twin: rank at axis index
    p receives a copy of the buffer of index p + 1 (``to_left``) or
    p − 1, modulo the axis size; with ``mask_edge`` the edge rank receives
    zeros."""
    src = _source(mesh, axis, to_left)
    return [torch.zeros_like(bufs[r], memory_format=torch.contiguous_format)
            if mask_edge and _edge(mesh, axis, r, to_left)
            else bufs[s].to(bufs[r].device, copy=True)
            for r, s in enumerate(src)]


class RowLayout(NamedTuple):
    """A payload as the kernel reads it: ``rows`` runs of ``words`` 32-bit
    words, run k at word k · ``stride``."""
    rows: int
    words: int
    stride: int


def row_layout(t: torch.Tensor) -> RowLayout:
    """The kernel's view of payload ``t``; raises where it has none."""
    if t.dtype not in DTYPES:
        raise TypeError(f"halo: payloads must be float32 or float64 (or "
                        f"complex64, complex128), got {t.dtype}")
    r = torch.view_as_real(t) if t.is_complex() else t
    if r.dim() == 0:
        r = r.reshape(1)
    per_word = r.element_size() // 4
    # The last dimension, with the real/imaginary pair, must be contiguous
    # elements; the leading dimensions must collapse to one stride.
    inner = r.shape[-1] * (r.shape[-2] if t.is_complex() and r.dim() > 1
                           else 1)
    lead = r.shape[:-2] if t.is_complex() and r.dim() > 1 else r.shape[:-1]
    rows = 1
    for s in lead:
        rows *= int(s)
    try:
        flat = r.view(rows, inner)
    except RuntimeError:
        flat = None
    if flat is None or (inner > 1 and flat.stride(1) != 1):
        raise ValueError(f"halo: a payload must be runs of contiguous "
                         f"elements at one stride, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    words = inner * per_word
    if rows * words >= 2 ** 31:
        raise ValueError("halo: payload too large for 32-bit indexing")
    stride = flat.stride(0) * per_word if rows > 1 else words
    return RowLayout(rows, words, stride)


class _Flags:
    """The flag words of one device list: per device one int64 tensor of
    (MAX_COLLECTIVE_IDS, n_ranks, 2) arrive/ready words and one error word,
    and the epoch reached per collective_id."""

    def __init__(self, mesh: RadarMesh):
        self.n_ranks = mesh.size
        self.devices = list(mesh.devices)
        self.words: Dict[torch.device, torch.Tensor] = {
            d: torch.zeros(MAX_COLLECTIVE_IDS * self.n_ranks * 2 + 1,
                           dtype=torch.int64, device=d)
            for d in mesh.distinct_devices()}
        self.epoch = [0] * MAX_COLLECTIVE_IDS

    def flag(self, rank: int, cid: int, ready: bool) -> int:
        base = self.words[self.devices[rank]].data_ptr()
        return base + ((cid * self.n_ranks + rank) * 2 + int(ready)) * 8

    def error_word(self, dev: torch.device) -> int:
        t = self.words[dev]
        return t.data_ptr() + (t.numel() - 1) * 8


class _Plan:
    """Everything of a call that does not change between calls with the
    same mesh, axis, direction, mask, collective_id, shape, dtype and
    strides: the cards and their ranks, and per card one launch: its
    sending ranks (one row of blocks each), the (card, slot) each writes
    into, and the launcher's arguments as ctypes values (the pointer table
    with the flag addresses filled in once, the layout, the edge mask, the
    error word), so that a call only fills in data pointers."""

    def __init__(self, mesh, axis, to_left, mask_edge, cid, t, flags,
                 max_ranks):
        lay = row_layout(t)
        self.slot_bytes = t.numel() * t.element_size()
        self.cards = mesh.distinct_devices()
        self.device_index = [d.index for d in mesh.devices]
        self.flags = flags
        self.sys_scope = int(flags is not None)
        card_of = [self.cards.index(d) for d in mesh.devices]
        self.ranks_on = [[r for r in range(mesh.size)
                          if mesh.devices[r] == d] for d in self.cards]
        slot = [0] * mesh.size
        for ranks in self.ranks_on:
            if len(ranks) > max_ranks:
                raise ValueError(f"halo: {len(ranks)} ranks on one device, "
                                 f"the kernel takes {max_ranks}")
            for i, r in enumerate(ranks):
                slot[r] = i
        dst_of = [0] * mesh.size
        for r, s in enumerate(_source(mesh, axis, to_left)):
            dst_of[s] = r
        self.alloc = [(len(ranks),) + tuple(t.shape)
                      for ranks in self.ranks_on]
        self.launches = []
        for dev, ranks in zip(self.cards, self.ranks_on):
            q = [dst_of[r] for r in ranks]
            mask = 0
            if mask_edge:
                for b, d in enumerate(q):
                    if _edge(mesh, axis, d, to_left):
                        mask |= 1 << b
            n = len(ranks)
            table = (ctypes.c_void_p * ((6 if flags else 2) * n))()
            err = 0
            if flags is not None:
                table[2 * n:] = ([flags.flag(r, cid, False) for r in ranks]
                                 + [flags.flag(d, cid, False) for d in q]
                                 + [flags.flag(d, cid, True) for d in q]
                                 + [flags.flag(r, cid, True) for r in ranks])
                err = flags.error_word(dev)
            head = (ctypes.c_int(n), table, ctypes.c_int(lay.rows),
                    ctypes.c_int(lay.words), ctypes.c_longlong(lay.stride),
                    ctypes.c_uint(mask))
            tail = (ctypes.c_int(self.sys_scope), ctypes.c_void_p(err),
                    ctypes.c_int(dev.index))
            self.launches.append((dev.index, ranks,
                                  [(card_of[d], slot[d]) for d in q],
                                  table, head, tail))


class HaloKernel:
    """Wrapper of the CUDA kernel ``csrc/halo.cu``: CPU buffers take
    :func:`halo_permute_plain`; CUDA buffers launch the kernel (one launch
    per device in use) or raise. ``launches`` counts the kernel launches."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._max_ranks = 0
        self._flags: Dict[tuple, _Flags] = {}
        # Plans per mesh, dropped with the mesh (a plan holds no reference
        # to it).
        self._plans: "weakref.WeakKeyDictionary[RadarMesh, dict]" = \
            weakref.WeakKeyDictionary()

    def _library(self):
        if self._lib is None:
            from blah2_tpu_torch.ops import _build

            lib = _build.load("halo")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            ll = ctypes.c_longlong
            lib.halo_max_ranks.argtypes = []
            lib.halo_max_ranks.restype = ci
            lib.halo_launch.argtypes = [ci, ctypes.POINTER(vp), ci, ci, ll,
                                        ctypes.c_uint, ll, ci, vp, ci, vp]
            lib.halo_launch.restype = ci
            lib.halo_enable_peer.argtypes = [ci]
            lib.halo_enable_peer.restype = ci
            self._max_ranks = lib.halo_max_ranks()
            self._lib = lib
        return self._lib

    def _cross_card_flags(self, mesh: RadarMesh) -> _Flags:
        """The flags of a mesh over several cards, with peer access on."""
        key = tuple(mesh.devices)
        state = self._flags.get(key)
        if state is None:
            lib = self._library()
            cards = mesh.distinct_devices()
            for d in cards:
                with torch.cuda.device(d):
                    for peer in cards:
                        if peer != d:
                            err = lib.halo_enable_peer(peer.index)
                            if err != 0:
                                raise RuntimeError(
                                    f"halo: peer access {d} -> {peer} "
                                    f"failed: CUDA error {err}")
            state = self._flags[key] = _Flags(mesh)
        return state

    def _new_plan(self, plans, key, b0, mesh, axis, to_left,
                  mask_edge) -> _Plan:
        cid = int(key[3])
        if not 0 <= cid < MAX_COLLECTIVE_IDS:
            raise ValueError(f"halo: collective_id must be in "
                             f"[0, {MAX_COLLECTIVE_IDS}), got {cid}")
        self._library()
        flags = (self._cross_card_flags(mesh)
                 if len(mesh.distinct_devices()) > 1 else None)
        plan = plans[key] = _Plan(mesh, axis, to_left, mask_edge, cid, b0,
                                  flags, self._max_ranks)
        return plan

    def __call__(self, bufs: List[torch.Tensor], mesh: RadarMesh,
                 axis: str = "pulse", to_left: bool = True,
                 collective_id: int = 0,
                 mask_edge: bool = False) -> List[torch.Tensor]:
        b0 = bufs[0]
        if not b0.is_cuda:
            if all(b.device.type == "cpu" for b in bufs):
                return halo_permute_plain(bufs, mesh, axis, to_left,
                                          mask_edge)
            raise ValueError(f"halo: unsupported device {b0.device}")
        if len(bufs) != mesh.size:
            raise ValueError(f"halo: {len(bufs)} buffers for {mesh.size} "
                             f"ranks")
        shape, dtype, stride = b0.shape, b0.dtype, b0.stride()
        plans = self._plans.get(mesh)
        if plans is None:
            plans = self._plans[mesh] = {}
        key = (axis, to_left, mask_edge, collective_id, shape, dtype, stride)
        plan = plans.get(key)
        if plan is None:
            plan = self._new_plan(plans, key, b0, mesh, axis, to_left,
                                  mask_edge)
        for r, (b, index) in enumerate(zip(bufs, plan.device_index)):
            if b.get_device() != index:
                raise ValueError(f"halo: rank {r}'s buffer is on {b.device}, "
                                 f"the rank on {mesh.devices[r]}")
            if b.shape != shape or b.stride() != stride or b.dtype != dtype:
                raise ValueError("halo: every rank's buffer must have one "
                                 "shape, dtype and stride")
        epoch = _EPOCH_ONE_CARD
        if plan.flags is not None:
            cid = int(collective_id)
            plan.flags.epoch[cid] += 1
            epoch = ctypes.c_longlong(plan.flags.epoch[cid])
        outs = [torch.empty(a, dtype=dtype, device=d)
                for a, d in zip(plan.alloc, plan.cards)]
        bases = [o.data_ptr() for o in outs]
        size = plan.slot_bytes
        launch = self._lib.halo_launch
        for index, ranks, dests, table, head, tail in plan.launches:
            n = len(ranks)
            table[:n] = [bufs[r].data_ptr() for r in ranks]
            table[n:2 * n] = [bases[c] + s * size for c, s in dests]
            code = launch(*head, epoch, *tail, current_stream_handle(index))
            if code != 0:
                raise RuntimeError(f"halo kernel launch failed: CUDA error "
                                   f"{code}")
            self.launches += 1
        out = [None] * mesh.size
        for o, ranks in zip(outs, plan.ranks_on):
            for r, v in zip(ranks, o.unbind(0)):
                out[r] = v
        return out

    def error(self) -> int:
        """The kernel's error word, or-ed over every device it ran on across
        cards (0: no wait timed out; 1: a neighbour barrier, 2: a payload).
        A launch on one card waits for nothing and leaves it 0. Reading it
        waits for the device."""
        word = 0
        for state in self._flags.values():
            for t in state.words.values():
                word |= int(t[-1])
        return word

    def check(self) -> None:
        """Raise if a wait of the kernel ever timed out."""
        word = self.error()
        if word:
            raise RuntimeError(f"halo kernel: a wait timed out (error word "
                               f"{word}); its outputs are not valid")


#: The halo wrapper used by ``parallel/halo.py``; its ``launches`` count
#: shows whether a run went through the kernel.
halo_permute = HaloKernel()
