"""The circular neighbour permute of the halo exchange (counterpart of
``blah2_tpu/parallel/halo.py::_rdma_permute``).

Every rank of each ring on one mesh axis sends its buffer to its neighbour,
d → d − 1 (``to_left``) or d → d + 1, circularly; the caller masks the
wrap-around edge. On the card this is the hand-written kernel
``csrc/halo.cu``: one call covers every rank of the mesh, with one launch
per device whose blocks are that device's ranks, a neighbour barrier on
flag words and the copy into the neighbour's buffer. On the CPU it is
:func:`halo_permute_plain`, the same function by tensor copies. The wrapper
:data:`halo_permute` chooses by the device of the buffers it is given and
nothing else: CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from blah2_tpu_torch.parallel.mesh import RadarMesh

#: Flag slots per rank: call sites with no data dependency on each other
#: take distinct ``collective_id``s below this.
MAX_COLLECTIVE_IDS = 8


def _source(mesh: RadarMesh, axis: str, to_left: bool) -> List[int]:
    """For each rank, the rank whose buffer it receives."""
    src = [0] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        for i, r in enumerate(group):
            src[r] = group[(i + 1) % n] if to_left else group[(i - 1) % n]
    return src


def halo_permute_plain(bufs: List[torch.Tensor], mesh: RadarMesh,
                       axis: str = "pulse",
                       to_left: bool = True) -> List[torch.Tensor]:
    """The permute by tensor copies, the kernel's twin: rank at axis index
    p receives a copy of the buffer of index p + 1 (``to_left``) or
    p − 1, modulo the axis size."""
    src = _source(mesh, axis, to_left)
    return [bufs[s].to(bufs[r].device, copy=True) for r, s in enumerate(src)]


def _check(bufs: List[torch.Tensor], mesh: RadarMesh, collective_id: int):
    if len(bufs) != mesh.size:
        raise ValueError(f"halo: {len(bufs)} buffers for {mesh.size} ranks")
    shape, dtype = bufs[0].shape, bufs[0].dtype
    for r, b in enumerate(bufs):
        if b.device != mesh.devices[r]:
            raise ValueError(f"halo: rank {r}'s buffer is on {b.device}, the "
                             f"rank on {mesh.devices[r]}")
        if b.shape != shape or b.dtype != dtype:
            raise ValueError("halo: every rank's buffer must have one shape "
                             "and dtype")
        if not b.is_contiguous():
            raise ValueError("halo: buffers must be contiguous")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"halo: buffers must be float32 or float64 planes, "
                        f"got {dtype}")
    if not 0 <= int(collective_id) < MAX_COLLECTIVE_IDS:
        raise ValueError(f"halo: collective_id must be in "
                         f"[0, {MAX_COLLECTIVE_IDS}), got {collective_id}")


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


class HaloKernel:
    """Wrapper of the CUDA kernel ``csrc/halo.cu``: CPU buffers take
    :func:`halo_permute_plain`; CUDA buffers launch the kernel (one launch
    per device in use) or raise. ``launches`` counts the kernel launches."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._flags: Dict[tuple, _Flags] = {}

    def _library(self):
        if self._lib is None:
            from blah2_tpu_torch.ops import _build

            lib = _build.load("halo")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.halo_max_ranks.argtypes = []
            lib.halo_max_ranks.restype = ci
            lib.halo_launch.argtypes = [ci, ctypes.POINTER(vp), ci,
                                        ctypes.c_longlong, ci, vp, vp]
            lib.halo_launch.restype = ci
            lib.halo_enable_peer.argtypes = [ci]
            lib.halo_enable_peer.restype = ci
            self._lib = lib
        return self._lib

    def _state(self, mesh: RadarMesh) -> _Flags:
        key = tuple(mesh.devices)
        state = self._flags.get(key)
        if state is None:
            lib = self._library()
            cards = mesh.distinct_devices()
            for d in cards:
                if len(cards) > 1:
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

    def __call__(self, bufs: List[torch.Tensor], mesh: RadarMesh,
                 axis: str = "pulse", to_left: bool = True,
                 collective_id: int = 0) -> List[torch.Tensor]:
        kinds = {b.device.type for b in bufs}
        if kinds == {"cpu"}:
            return halo_permute_plain(bufs, mesh, axis, to_left)
        if kinds != {"cuda"}:
            raise ValueError(f"halo: unsupported devices {sorted(kinds)}")
        _check(bufs, mesh, collective_id)
        lib = self._library()
        state = self._state(mesh)
        cid = int(collective_id)
        state.epoch[cid] += 1
        epoch = state.epoch[cid]
        src = _source(mesh, axis, to_left)
        dst_of = [0] * mesh.size
        for r, s in enumerate(src):
            dst_of[s] = r
        outs = [torch.empty_like(b) for b in bufs]
        n_words = bufs[0].numel() * bufs[0].element_size() // 4
        cards = mesh.distinct_devices()
        sys_scope = int(len(cards) > 1)
        for dev in cards:
            ranks = [r for r in range(mesh.size) if mesh.devices[r] == dev]
            if len(ranks) > lib.halo_max_ranks():
                raise ValueError(f"halo: {len(ranks)} ranks on {dev}, the "
                                 f"kernel takes {lib.halo_max_ranks()}")
            q = [dst_of[r] for r in ranks]
            ptrs = ([bufs[r].data_ptr() for r in ranks]
                    + [outs[d].data_ptr() for d in q]
                    + [state.flag(r, cid, False) for r in ranks]
                    + [state.flag(d, cid, False) for d in q]
                    + [state.flag(d, cid, True) for d in q]
                    + [state.flag(r, cid, True) for r in ranks])
            table = (ctypes.c_void_p * len(ptrs))(*ptrs)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream().cuda_stream
                err = lib.halo_launch(len(ranks), table, n_words, epoch,
                                      sys_scope, state.error_word(dev),
                                      stream)
            if err != 0:
                raise RuntimeError(f"halo kernel launch failed: CUDA error "
                                   f"{err}")
            self.launches += 1
        return outs

    def error(self) -> int:
        """The kernel's error word, or-ed over every device it ran on (0:
        no wait timed out; 1: a neighbour barrier, 2: a payload). Reading
        it waits for the device."""
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
