"""The neighbour permute of the halo exchange (counterpart of
``blah2_tpu/parallel/halo.py::_rdma_permute``).

Every rank of each ring on one mesh axis sends its buffer to its neighbour,
d → d − 1 (``to_left``) or d → d + 1, circularly. With ``mask_edge`` the
ring's edge rank (the last for ``to_left``, rank 0 otherwise) receives
zeros instead of the wrap-around: the open-chain shift of
``parallel/halo.py``. On the card this is the hand-written kernel
``csrc/halo.cu``: one call covers every rank of this process, with one
launch per device for that device's ranks. On the CPU it is
:func:`halo_permute_plain`, the same function by tensor copies. The wrapper
:data:`halo_permute` chooses by the device of the buffers it is given and
nothing else: CUDA tensors launch the kernel or raise.

A payload is float32, float64, complex64 or complex128, of any shape whose
leading dimensions step by one stride over runs of contiguous elements: a
(B, n) block sliced ``[..., :count]`` or ``[..., -count:]`` passes as it
lies. A call whose ranks all lie on one card returns views into a fresh
contiguous ``(ranks on the card, *shape)`` tensor of the payload's type.

Where the ranks' streams are not ordered with each other (several cards, or
a pair through CUDA IPC) the kernel takes its ``.sys`` flag protocol: the
TPU kernel's semaphores, each arrive and ready word signalled once and
consumed once a call (:func:`semaphores`), by stores alone (no atomic on a
peer card's memory), so a launch's parameters never change and a CUDA graph
replays it. The flag words, an error word and
the receive buffers live in the call's plan (one per axis, direction,
mask, collective_id, shape, dtype and strides): one cudaMalloc'ed window
per card, zeroed once. The receive buffers are reused from call to call:
the views returned live until the next call with the same plan, and the
kernel's arrive barrier keeps a sender from writing a buffer before its
readers of the last call have run. The sharded step reads every halo
inside the step. ``HaloKernel(flags_on_one_card=True)`` gives a one-card
plan the same protocol, one launch whose blocks wait on one another: a
check of the protocol on a machine with one card, not a route the step
takes.

Across processes (a mesh over a job, ``parallel/distributed.py``) each pair
(sender, receiver) takes one route, fixed by the mesh's layout alone:

  - ``kernel``: both ends in this process; the launch of the sender's card
    writes the receiver's buffer (no flags when the process has one card);
  - ``ipc``: the ends in two processes on one host, on cards of their own
    (the job's NCCL layout). The kernel does the pair with its flags; each
    process opens its peers' windows by CUDA IPC handles, exchanged once
    per plan;
  - ``group``: the ends in two processes that share a card (spin-waits
    between two processes' kernels on one card are not safe: without MPS
    their contexts time-slice, and a wait can run out) or on two hosts: the
    payload goes through the process group (``parallel/collectives.py``
    ``exchange``); a masked edge on this route is zero-filled by the
    receiver's own launch.

Across processes the semaphores stay in step because every process makes
the same calls in the same order. No route is chosen after a failure: a
failed IPC open or launch raises. A wait that times out sets the plan's
error word (:meth:`HaloKernel.error_words`); :meth:`HaloKernel.check`
raises on it in every process. ``pairs`` counts, per route, the pairs whose
receiver is in this process (a masked edge moves no payload and is not
counted).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch

from blah2_tpu_torch.device import current_stream_handle
from blah2_tpu_torch.dsp.graph import COUNTERS
from blah2_tpu_torch.parallel import distributed
from blah2_tpu_torch.parallel.collectives import exchange
from blah2_tpu_torch.parallel.mesh import RadarMesh

#: Call sites with no data dependency on each other take distinct
#: ``collective_id``s below this (the TPU kernel's rule), and so plans, and
#: flags, of their own.
MAX_COLLECTIVE_IDS = 8

DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


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


def _pairs(mesh: RadarMesh, axis: str, to_left: bool,
           mask_edge: bool) -> List[tuple]:
    """(sender, receiver) of every rank that receives a payload: all but
    the masked edges."""
    return [(s, r) for r, s in enumerate(_source(mesh, axis, to_left))
            if not (mask_edge and _edge(mesh, axis, r, to_left))]


def halo_permute_plain(bufs: List[torch.Tensor], mesh: RadarMesh,
                       axis: str = "pulse", to_left: bool = True,
                       mask_edge: bool = False) -> List[torch.Tensor]:
    """The permute by tensor copies, the kernel's twin: rank at axis index
    p receives a copy of the buffer of index p + 1 (``to_left``) or
    p − 1, modulo the axis size; with ``mask_edge`` the edge rank receives
    zeros. Pairs that cross a process go through the process group."""
    pairs = _pairs(mesh, axis, to_left, mask_edge)
    crossed = exchange(bufs, mesh, pairs)
    src = {r: s for s, r in pairs}
    out: List = [None] * len(bufs)
    for r in mesh.local_ranks:
        if r in crossed:
            out[r] = crossed[r]
        elif r in src:
            out[r] = bufs[src[r]].to(bufs[r].device, copy=True)
        else:
            out[r] = torch.zeros_like(bufs[r],
                                      memory_format=torch.contiguous_format)
    return out


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


class _CudaBytes:
    """Device memory as ``torch.as_tensor`` takes it (the CUDA array
    interface); the tensor does not own the memory."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


_ALIGN = 256


class _Windows:
    """The flags and receive buffers of a plan that takes flags or whose
    job sends a pair through CUDA IPC: per card of this process one
    cudaMalloc'ed window (per rank on the card an arrive and a ready word,
    then the error word, then per rank a receive buffer); with ``export``,
    the peers' windows opened in this process by IPC handles exchanged once
    (every process of the job builds the plan, so every one takes part).
    Released when the plan goes."""

    def __init__(self, lib, mesh: RadarMesh, ranks_on, cards, slot_bytes,
                 opens_on, export: bool):
        slot = -(-slot_bytes // _ALIGN) * _ALIGN
        hbytes = lib.halo_ipc_handle_bytes()
        self.owned, self.opened = [], []
        self.error_views: List[torch.Tensor] = []
        self.flag_views: List[torch.Tensor] = []
        self.error_addr: List[int] = []
        self.slot_views: Dict[int, torch.Tensor] = {}
        self.addr: Dict[int, tuple] = {}     # rank -> (arrive, ready, slot)
        handles, offsets = [], {}
        for w, (dev, ranks) in enumerate(zip(cards, ranks_on)):
            n = len(ranks)
            head = -(-(16 * n + 8) // _ALIGN) * _ALIGN
            nbytes = head + n * slot
            ptr = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(hbytes) if export else None
            _cuda_check(lib.halo_window_alloc(nbytes, dev.index,
                                              ctypes.byref(ptr), handle),
                        "allocating a window")
            self.owned.append((ptr.value, dev.index))
            handles.append(handle.raw if export else None)
            window = torch.as_tensor(_CudaBytes(ptr.value, nbytes),
                                     device=dev)
            self.error_views.append(window[16 * n:16 * n + 8]
                                    .view(torch.int64))
            self.flag_views.append(window[:16 * n].view(torch.int64))
            self.error_addr.append(ptr.value + 16 * n)
            for i, r in enumerate(ranks):
                offsets[r] = (w, 16 * i, 16 * i + 8, head + i * slot)
                self.slot_views[r] = window[head + i * slot:
                                            head + i * slot + slot_bytes]
                self.addr[r] = (ptr.value + 16 * i, ptr.value + 16 * i + 8,
                                ptr.value + head + i * slot)
        weakref.finalize(self, _release, lib, self.owned, self.opened)
        if not export:
            return
        peers = distributed.all_gather_object((handles, offsets))
        bases: Dict[tuple, int] = {}
        for r, dev_index in opens_on.items():
            p = mesh.process_of(r)
            their_handles, their_offsets = peers[p]
            w, a, b, c = their_offsets[r]
            if (p, w) not in bases:
                ptr = ctypes.c_void_p()
                _cuda_check(lib.halo_ipc_open(their_handles[w], dev_index,
                                              ctypes.byref(ptr)),
                            f"opening process {p}'s window")
                self.opened.append((ptr.value, dev_index))
                bases[p, w] = ptr.value
            base = bases[p, w]
            self.addr[r] = (base + a, base + b, base + c)


def _cuda_check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"halo: failed {what}: CUDA error {code}")


def _release(lib, owned, opened) -> None:
    for ptr, dev in opened:
        lib.halo_window_release(ctypes.c_void_p(ptr), dev, 1)
    for ptr, dev in owned:
        lib.halo_window_release(ctypes.c_void_p(ptr), dev, 0)


class Block(NamedTuple):
    """One block of a launch, by rank: it copies ``src``'s payload (zeros
    with ``zero``) into ``dst``'s receive buffer (``dst`` None: no copy);
    with flags, it first stores ``arrive``'s arrive word and, where it has
    a source and a destination, waits for ``dst``'s arrive word, copies and
    stores ``dst``'s ready word; last it waits for ``ready``'s ready word
    (each None: skipped). A block with no source only zero-fills ``dst``,
    with no flags."""
    src: Optional[int]
    dst: Optional[int]
    zero: bool
    arrive: Optional[int]
    ready: Optional[int]


class Semaphores(NamedTuple):
    """The flag words of a block that takes flags, by the rank whose word
    it is (None: none): it signals ``arrive``, consumes the receiver's
    arrive word, signals the receiver's ready word, consumes its own ready
    word (``csrc/halo.cu`` steps 1, 3 and 4)."""
    signal_arrive: Optional[int]
    consume_arrive: Optional[int]
    signal_ready: Optional[int]
    consume_ready: Optional[int]


def semaphores(block: Block) -> Semaphores:
    """What ``block`` signals and consumes in a launch that takes flags:
    a block with a source and a destination waits for the destination's
    arrival and signals its ready word."""
    peer = None if block.src is None else block.dst
    return Semaphores(block.arrive, peer, peer, block.ready)


class Routes(NamedTuple):
    """How this process serves one halo call: the pairs by route, the
    blocks of each of its cards' launches, whether they take flags, and
    whether any pair of the job goes through CUDA IPC."""
    counts: Dict[str, int]       # pairs by route, receivers here, no edge
    group_pairs: List[tuple]     # (sender, receiver) through the group
    blocks: List[List[Block]]    # per card of mesh.distinct_devices()
    flags: bool
    ipc: bool


def routes(mesh: RadarMesh, axis: str, to_left: bool, mask_edge: bool,
           ipc_ok: bool, flags_on_one_card: bool = False) -> Routes:
    """The routes of a call, from the mesh's layout alone: a pair whose
    ends are in one process is ``kernel``; across processes it is ``ipc``
    where ``ipc_ok`` (the job's NCCL layout) and the two processes share a
    host, else ``group``. Per rank x of this process the block of x's card
    sends x's payload to the rank it feeds where the route is the kernel's
    (zeros to a masked edge), and takes part in the flags as a receiver
    where its own sender writes by the kernel; a masked edge whose sender
    is reached through the group gets a block of its own that zero-fills
    its buffer. ``flags_on_one_card``: the flags wherever a pair goes by
    the kernel, one card or not."""
    size = mesh.size
    src = _source(mesh, axis, to_left)
    feeds = [0] * size
    for r, s in enumerate(src):
        feeds[s] = r
    masked = [mask_edge and _edge(mesh, axis, r, to_left)
              for r in range(size)]

    def route(s, r):
        ps, pr = mesh.process_of(s), mesh.process_of(r)
        if ps == pr:
            return "kernel"
        if ipc_ok and mesh.hosts[ps] == mesh.hosts[pr]:
            return "ipc"
        return "group"

    counts = {"kernel": 0, "ipc": 0, "group": 0}
    for r in mesh.local_ranks:
        if not masked[r]:
            counts[route(src[r], r)] += 1
    cards = mesh.distinct_devices()
    mine = set(mesh.local_ranks)
    flags = flags_on_one_card or len(cards) > 1 or any(
        route(s, r) == "ipc" and (s in mine or r in mine)
        for r, s in enumerate(src))
    blocks = []
    for dev in cards:
        ranks = [r for r in mesh.local_ranks if mesh.devices[r] == dev]
        card: List[Block] = []
        for x in ranks:
            y = feeds[x]
            send = route(x, y) != "group"
            fed = flags and route(src[x], x) != "group"
            if send or fed:
                card.append(Block(x, y if send else None, masked[y],
                                  x if fed else None, x if fed else None))
        card += [Block(None, r, True, None, None) for r in ranks
                 if masked[r] and route(src[r], r) == "group"]
        blocks.append(card)
    return Routes(counts,
                  [(s, r) for r, s in enumerate(src)
                   if not masked[r] and route(s, r) == "group"],
                  blocks, bool(flags),
                  any(route(s, r) == "ipc" for r, s in enumerate(src)))


class _Plan:
    """Everything of a call that does not change between calls with the
    same mesh, axis, direction, mask, collective_id, shape, dtype and
    strides: the routes, the cards and their ranks, and per card one
    launch: its blocks as addresses and the launcher's arguments as ctypes
    values, so that a call only fills in data pointers."""

    def __init__(self, lib, mesh, axis, to_left, mask_edge, t, max_ranks,
                 flags_on_one_card=False):
        lay = row_layout(t)
        self.slot_bytes = t.numel() * t.element_size()
        self.shape, self.dtype = tuple(t.shape), t.dtype
        self.cards = mesh.distinct_devices()
        self.device_index = {r: mesh.devices[r].index
                             for r in mesh.local_ranks}
        job = distributed.job()
        plan = routes(mesh, axis, to_left, mask_edge,
                      job is not None and job.backend == "nccl",
                      flags_on_one_card)
        self.counts, self.group_pairs = plan.counts, plan.group_pairs
        self.sys_scope = int(plan.flags)
        self.ranks_on = [[r for r in mesh.local_ranks
                          if mesh.devices[r] == d] for d in self.cards]
        for blocks in plan.blocks:
            if len(blocks) > max_ranks:
                raise ValueError(f"halo: {len(blocks)} ranks on one device, "
                                 f"the kernel takes {max_ranks}")
        card_of = {r: c for c, ranks in enumerate(self.ranks_on)
                   for r in ranks}
        slot = {r: ranks.index(r) for ranks in self.ranks_on for r in ranks}

        # The flag words and receive buffers live in the plan's windows
        # where it takes flags or its job sends a pair through IPC; else
        # each call writes a fresh (ranks on the card, *shape) tensor.
        self.windows = None
        if plan.flags or plan.ipc:
            opens_on = {}
            for blocks in plan.blocks:
                for b in blocks:
                    if b.dst is not None and not mesh.is_local(b.dst):
                        opens_on.setdefault(b.dst,
                                            mesh.devices[b.src].index)
            self.windows = _Windows(lib, mesh, self.ranks_on, self.cards,
                                    self.slot_bytes, opens_on, plan.ipc)

        def flag(rank, ready):
            return (None if rank is None
                    else self.windows.addr[rank][1 if ready else 0])

        def dest(rank):
            if rank is None:
                return None
            if self.windows is not None:
                return ("abs", self.windows.addr[rank][2])
            return ("out", card_of[rank], slot[rank])

        self.alloc = [(len(ranks),) + self.shape for ranks in self.ranks_on]
        self.launches = []
        for c, (dev, blocks) in enumerate(zip(self.cards, plan.blocks)):
            if not blocks:
                continue
            n = len(blocks)
            table = (ctypes.c_void_p * ((6 if self.sys_scope else 2) * n))()
            mask = sum(1 << i for i, b in enumerate(blocks) if b.zero)
            err = 0
            if self.sys_scope:
                sem = [semaphores(b) for b in blocks]
                table[2 * n:] = (
                    [flag(f.signal_arrive, False) for f in sem]
                    + [flag(f.consume_arrive, False) for f in sem]
                    + [flag(f.signal_ready, True) for f in sem]
                    + [flag(f.consume_ready, True) for f in sem])
                err = self.windows.error_addr[c]
            head = (ctypes.c_int(n), table, ctypes.c_int(lay.rows),
                    ctypes.c_int(lay.words), ctypes.c_longlong(lay.stride),
                    ctypes.c_uint(mask))
            tail = (ctypes.c_int(self.sys_scope), ctypes.c_void_p(err),
                    ctypes.c_int(dev.index))
            self.launches.append((dev.index, [b.src for b in blocks],
                                  [dest(b.dst) for b in blocks], table, head,
                                  tail))


class HaloKernel:
    """Wrapper of the CUDA kernel ``csrc/halo.cu``: CPU buffers take
    :func:`halo_permute_plain`; CUDA buffers launch the kernel (one launch
    per device of this process that has work) or raise. ``launches`` counts
    the kernel launches, ``pairs`` the pairs by route.

    ``flags_on_one_card``: plans on one card take the flag protocol too
    (checks of the protocol, not the step's route); its counts go under
    the name ``halo_flags``, apart from the step's ``halo``."""

    def __init__(self, flags_on_one_card: bool = False):
        self.flags_on_one_card = flags_on_one_card
        self.name = "halo_flags" if flags_on_one_card else "halo"
        self.launches = 0
        self.pairs = {"kernel": 0, "ipc": 0, "group": 0}
        self._lib = None
        self._max_ranks = 0
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
                                        ctypes.c_uint, ci, vp, ci, vp]
            lib.halo_launch.restype = ci
            lib.halo_enable_peer.argtypes = [ci]
            lib.halo_enable_peer.restype = ci
            lib.halo_ipc_handle_bytes.argtypes = []
            lib.halo_ipc_handle_bytes.restype = ci
            lib.halo_window_alloc.argtypes = [ll, ci, ctypes.POINTER(vp),
                                              ctypes.c_char_p]
            lib.halo_window_alloc.restype = ci
            lib.halo_ipc_open.argtypes = [ctypes.c_char_p, ci,
                                          ctypes.POINTER(vp)]
            lib.halo_ipc_open.restype = ci
            lib.halo_window_release.argtypes = [vp, ci, ci]
            lib.halo_window_release.restype = ci
            self._max_ranks = lib.halo_max_ranks()
            self._lib = lib
        return self._lib

    def _enable_peers(self, cards) -> None:
        lib = self._library()
        for d in cards:
            with torch.cuda.device(d):
                for peer in cards:
                    if peer != d:
                        err = lib.halo_enable_peer(peer.index)
                        if err != 0:
                            raise RuntimeError(
                                f"halo: peer access {d} -> {peer} "
                                f"failed: CUDA error {err}")

    def _new_plan(self, plans, key, b0, mesh, axis, to_left,
                  mask_edge) -> _Plan:
        cid = int(key[3])
        if not 0 <= cid < MAX_COLLECTIVE_IDS:
            raise ValueError(f"halo: collective_id must be in "
                             f"[0, {MAX_COLLECTIVE_IDS}), got {cid}")
        lib = self._library()
        if len(mesh.distinct_devices()) > 1:
            self._enable_peers(mesh.distinct_devices())
        plan = _Plan(lib, mesh, axis, to_left, mask_edge, b0,
                     self._max_ranks, self.flags_on_one_card)
        plans[key] = plan
        return plan

    def __call__(self, bufs: List[torch.Tensor], mesh: RadarMesh,
                 axis: str = "pulse", to_left: bool = True,
                 collective_id: int = 0,
                 mask_edge: bool = False) -> List[torch.Tensor]:
        local = mesh.local_ranks
        b0 = bufs[local[0]]
        if not b0.is_cuda:
            if all(bufs[r].device.type == "cpu" for r in local):
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
        for r, index in plan.device_index.items():
            b = bufs[r]
            if b.get_device() != index:
                raise ValueError(f"halo: rank {r}'s buffer is on {b.device}, "
                                 f"the rank on {mesh.devices[r]}")
            if b.shape != shape or b.stride() != stride or b.dtype != dtype:
                raise ValueError("halo: every rank's buffer must have one "
                                 "shape, dtype and stride")
        if plan.windows is None:
            outs = [torch.empty(a, dtype=dtype, device=d)
                    for a, d in zip(plan.alloc, plan.cards)]
            bases = [o.data_ptr() for o in outs]
        size = plan.slot_bytes
        launch = self._lib.halo_launch
        for index, srcs, dests, table, head, tail in plan.launches:
            n = len(srcs)
            table[:n] = [None if r is None else bufs[r].data_ptr()
                         for r in srcs]
            table[n:2 * n] = [None if d is None else
                              d[1] if d[0] == "abs" else bases[d[1]] +
                              d[2] * size for d in dests]
            code = launch(*head, *tail, current_stream_handle(index))
            if code != 0:
                raise RuntimeError(f"halo kernel launch failed: CUDA error "
                                   f"{code}")
            self.launches += 1
        out: List = [None] * mesh.size
        if plan.windows is None:
            for o, ranks in zip(outs, plan.ranks_on):
                for r, v in zip(ranks, o.unbind(0)):
                    out[r] = v
        else:
            for r in local:
                out[r] = plan.windows.slot_views[r].view(dtype).view(shape)
        if plan.group_pairs:
            for r, t in exchange(bufs, mesh, plan.group_pairs).items():
                out[r] = t
        for route, n in plan.counts.items():
            self.pairs[route] += n
        return out

    def add_launches(self, launches: int, pairs: Dict[str, int]) -> None:
        """Count launches and pairs made without a call of this wrapper: a
        CUDA graph's replay adds those it holds; its capture, which
        launches nothing, takes back what its calls counted."""
        self.launches += launches
        for route, n in pairs.items():
            self.pairs[route] += n

    def snapshot(self) -> dict:
        """The counts by name (:attr:`name`, and ``<name>_<route>`` per
        route), for ``dsp/graph.py`` ``COUNTERS``."""
        return {self.name: self.launches,
                **{f"{self.name}_{k}": v for k, v in self.pairs.items()}}

    def add(self, delta: dict, sign: int = 1) -> None:
        """Add ``sign`` times ``delta``'s entries of :meth:`snapshot`'s
        names."""
        self.add_launches(sign * delta.get(self.name, 0),
                          {k: sign * delta.get(f"{self.name}_{k}", 0)
                           for k in self.pairs})

    def error_words(self, mesh: Optional[RadarMesh] = None
                    ) -> List[torch.Tensor]:
        """The error words of the plans that take flags (of ``mesh``, or of
        every mesh), one int64 element each on its card: 0 while no wait
        has timed out; 1 a neighbour barrier's, 2 a payload's. A launch
        without flags waits for nothing. The words are views: they keep
        what later launches set."""
        meshes = (self._plans.values() if mesh is None
                  else [self._plans.get(mesh, {})])
        return [w for plans in meshes for plan in plans.values()
                if plan.windows is not None
                for w in plan.windows.error_views]

    def flag_words(self, mesh: RadarMesh) -> List[torch.Tensor]:
        """The arrive and ready words of ``mesh``'s plans that take flags,
        per card of each plan an int64 view (arrive, ready per rank on the
        card): all 0 once every launch has ended, each signal consumed."""
        return [w for plan in self._plans.get(mesh, {}).values()
                if plan.windows is not None
                for w in plan.windows.flag_views]

    def error(self) -> int:
        """This process's error words, or-ed. Reading them waits for the
        devices."""
        word = 0
        for w in self.error_words():
            word |= int(w[0])
        return word

    def check(self, word: Optional[int] = None) -> None:
        """Raise if a wait of the kernel ever timed out, in any process of
        the job (every process calls it, and every process raises).
        ``word``: this process's error words as already read, or-ed (None:
        read them now)."""
        word = distributed.any_error(self.error() if word is None else word)
        if word:
            raise RuntimeError(f"halo kernel: a wait timed out (error word "
                               f"{word}); its outputs are not valid")


#: The halo wrapper used by ``parallel/halo.py``; its ``launches`` count
#: shows whether a run went through the kernel. A CUDA graph re-adds what
#: it holds on every replay.
halo_permute = HaloKernel()
COUNTERS.append(halo_permute)
