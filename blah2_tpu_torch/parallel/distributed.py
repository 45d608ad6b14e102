"""Multi-process and multi-host runs over ``torch.distributed`` (counterpart of
``blah2_tpu/parallel/distributed.py``).

The multi-controller model of the JAX package: every process runs the same
program, calls :func:`maybe_initialize` once before anything touches a
card, and then builds the same meshes and makes the same calls in the same
order. A :class:`~blah2_tpu_torch.parallel.mesh.RadarMesh` built after it
spans every process: process k owns a contiguous run of the global ranks,
in process order (JAX's global device order), and computes only those. The
collectives of ``parallel/collectives.py`` and the halo wrapper
``ops/halo.py`` move what crosses a process through the helpers below.

Configuration comes from explicit arguments, then the ``BLAH2_COORDINATOR``
(host:port), ``BLAH2_NUM_PROCESSES`` and ``BLAH2_PROCESS_ID`` environment
variables; ``coordinator="auto"`` takes torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` instead (``env://``, the
counterpart of JAX's cloud-TPU detection).

The backend is chosen from the job's layout. The default group is always
gloo: it carries objects, host tensors and the halo kernel's error word.
After it is up, every process publishes its host and the cards it computes
on (by UUID); each process takes its share of the cards it sees, in the
order of the processes on its host (one each where every process sees all
of the host's cards, the one it sees where each sees one). Payloads then go
over NCCL when every process computes on cards and no card serves two
processes (a PyTorch without NCCL raises there), and over gloo otherwise:
on the CPU, and where processes share a card, which NCCL refuses
("Duplicate GPU detected"). Gloo takes host tensors
only, so CUDA payloads are staged through host memory on that path; that is
the one-shared-card case, not the deployment one.
"""

from __future__ import annotations

import datetime
import os
import socket
import types
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from blah2_tpu_torch.device import resolve_device


class Job(NamedTuple):
    """The layout of an initialised job, the same in every process but
    ``cards``."""
    backend: str                 # "nccl" or "gloo": the payloads' backend
    reason: str                  # why that backend
    hosts: tuple                 # the host of each process
    cards: tuple                 # this process's card indices (() on the CPU)
    group: object                # the payloads' process group


_job: Optional[Job] = None
#: What :func:`shutdown` calls before the groups go (weak references).
_at_shutdown: list = []


def maybe_initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Initialise ``torch.distributed`` when a multi-process run is
    configured; return True iff initialised.

    Sources, in priority order: explicit arguments; ``BLAH2_COORDINATOR``,
    ``BLAH2_NUM_PROCESSES``, ``BLAH2_PROCESS_ID``. With none this is a
    no-op (one process); ``coordinator="auto"`` hands everything to
    torchrun's environment. ``device`` is where this process computes
    (``None``: the card, which must exist; ``"cpu"``: the host). Prints one
    ``distributed:`` line with the process, its cards and the backend."""
    global _job
    if coordinator == "auto":
        init = {"init_method": "env://"}
    else:
        coordinator = coordinator or os.environ.get("BLAH2_COORDINATOR")
        if num_processes is None:
            env = os.environ.get("BLAH2_NUM_PROCESSES")
            num_processes = int(env) if env else None
        if process_id is None:
            env = os.environ.get("BLAH2_PROCESS_ID")
            process_id = int(env) if env else None
        if coordinator is None:
            return False
        if num_processes is None or process_id is None:
            raise ValueError(
                "multi-process init needs num_processes and process_id "
                "(flags or BLAH2_NUM_PROCESSES / BLAH2_PROCESS_ID) alongside "
                f"coordinator {coordinator!r}")
        init = {"init_method": f"tcp://{coordinator}",
                "world_size": int(num_processes), "rank": int(process_id)}
    dev = resolve_device(device)
    on_cards = dev.type == "cuda"
    dist = torch.distributed
    dist.init_process_group(backend="gloo",
                            timeout=datetime.timedelta(minutes=10), **init)
    index, count = dist.get_rank(), dist.get_world_size()
    seen = ([str(torch.cuda.get_device_properties(i).uuid)
             for i in range(torch.cuda.device_count())] if on_cards else [])
    layout: List = [None] * count
    dist.all_gather_object(layout, (socket.gethostname(), seen))
    hosts = tuple(h for h, _ in layout)
    try:
        backend, reason, mine = choose_backend(layout, index,
                                               dist.is_nccl_available())
    except RuntimeError:
        dist.destroy_process_group()
        raise
    group = None
    if backend == "nccl":
        torch.cuda.set_device(mine[0])
        group = dist.new_group(backend="nccl")
        # The communicator's first call must take every process.
        dist.all_reduce(torch.zeros(1, device=torch.device("cuda", mine[0])),
                        group=group)
    _job = Job(backend, reason, hosts, mine, group)
    print(f"distributed: process {index}/{count} on {hosts[index]}, "
          f"cards {list(mine)}, backend {backend} ({reason})", flush=True)
    return True


def choose_backend(layout: Sequence[tuple], index: int,
                   nccl: bool) -> tuple:
    """The payloads' backend of a job whose process k is on host
    ``layout[k][0]`` and sees the cards ``layout[k][1]`` (none: it computes
    on the host): (backend, why, the card indices of process ``index``).
    Each process takes its share of the cards it sees, in the order of the
    processes on its host. NCCL where every process has cards of its own
    (raises where this PyTorch has no NCCL), gloo where a process computes
    on the host or processes share a card."""
    hosts = [h for h, _ in layout]
    mine: tuple = ()
    owners: dict = {}
    for k, (host, cards) in enumerate(layout):
        if not cards:
            continue
        peers = [q for q in range(len(layout)) if hosts[q] == host]
        j, m, n = peers.index(k), len(peers), len(cards)
        share = (list(range(j * n // m, (j + 1) * n // m)) if n >= m
                 else [j % n])
        for c in share:
            owners.setdefault((host, cards[c]), []).append(k)
        if k == index:
            mine = tuple(share)
    if not all(cards for _, cards in layout):
        return "gloo", "a process computes on the host", mine
    if any(len(v) > 1 for v in owners.values()):
        return "gloo", "processes share a card", mine
    if not nccl:
        raise RuntimeError("distributed: every process computes on cards of "
                           "its own, which takes NCCL, and this PyTorch has "
                           "none")
    return "nccl", "every process on cards of its own", mine


def is_multiprocess() -> bool:
    return _job is not None and process_count() > 1


def process_index() -> int:
    return torch.distributed.get_rank() if _job is not None else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _job is not None else 1


def job() -> Optional[Job]:
    """The initialised job's layout, or None in one process."""
    return _job


def at_shutdown(fn: Callable[[], None]) -> None:
    """Have :func:`shutdown` call ``fn()`` before the groups go (a bound
    method held weakly). A CUDA graph that captured NCCL calls holds their
    communicator, whose destruction then waits for the graph: such graphs
    are freed here first."""
    _at_shutdown.append(weakref.WeakMethod(fn)
                        if isinstance(fn, types.MethodType) else lambda: fn)


def shutdown() -> None:
    """Leave the job: what :func:`at_shutdown` registered, then a
    barrier, so no process tears its groups down while another still uses
    them, then the groups go."""
    global _job
    if _job is None:
        return
    for ref in _at_shutdown:
        fn = ref()
        if fn is not None:
            fn()
    _at_shutdown.clear()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    _job = None


# -- payloads across processes ------------------------------------------------

def _home() -> torch.device:
    """The card NCCL payloads travel on: this process's first. PyTorch's
    NCCL backend takes one card a process, so a process with several cards
    stages the payloads of its other cards through this one."""
    return torch.device("cuda", _job.cards[0])


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the payload backend takes it: real, contiguous, and on the
    host for gloo, on this process's first card for NCCL."""
    if t.is_complex():
        t = torch.view_as_real(t)
    t = t.cpu() if _job.backend == "gloo" else t.to(_home())
    return t.contiguous()


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        t = torch.view_as_complex(t)
    return t.to(like.device)


def _empty_wire(like: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    dtype = like.real.dtype if like.is_complex() else like.dtype
    shape = tuple(shape) + ((2,) if like.is_complex() else ())
    dev = _home() if _job.backend == "nccl" else torch.device("cpu")
    return torch.empty(shape, dtype=dtype, device=dev)


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype in every process), in
    process order, on ``t``'s device."""
    wire = _wire(t)
    parts = [torch.empty_like(wire) for _ in range(process_count())]
    torch.distributed.all_gather(parts, wire, group=_job.group)
    return [_unwire(p, t) for p in parts]


def send_recv(sends, recvs) -> List[torch.Tensor]:
    """Point-to-point payloads in one batch: ``sends`` lists (process, tag,
    tensor), ``recvs`` (process, tag, like), where ``like`` is a tensor of
    the payload's shape and type on the device it should arrive on. Each
    side lists a pair's payloads in one order (by tag). Returns the
    received tensors, in ``recvs`` order."""
    dist = torch.distributed
    ops, got = [], []
    for proc, tag, t in sends:
        ops.append(dist.P2POp(dist.isend, _wire(t), proc, _job.group, tag))
    for proc, tag, like in recvs:
        buf = _empty_wire(like, like.shape)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, proc, _job.group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_unwire(b, like) for b, (_, _, like) in zip(got, recvs)]


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """Process ``src``'s ``t`` in every process; elsewhere ``t`` gives the
    shape, type and device."""
    wire = _wire(t) if process_index() == src else _empty_wire(t, t.shape)
    torch.distributed.broadcast(wire, src=src, group=_job.group)
    return _unwire(wire, t)


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s picklable ``obj`` in every process."""
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj) -> list:
    """Every process's picklable ``obj``, in process order."""
    out: List = [None] * process_count()
    torch.distributed.all_gather_object(out, obj)
    return out


def any_error(word: int) -> int:
    """The bitwise or of every process's ``word`` (in one process,
    ``word``)."""
    if not is_multiprocess():
        return word
    t = torch.tensor([word], dtype=torch.int64)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.BOR)
    return int(t[0])
