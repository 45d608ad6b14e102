"""Collectives over the logical ranks of a :class:`RadarMesh`.

The counterparts of the ``jax.lax`` collectives that the sharded step uses
(``blah2_tpu/parallel/sharded.py:358-359, 581-583, 617-619`` and
``blah2_tpu/parallel/halo.py:37-46``). A sharded value is a list with one
tensor per rank, each on its rank's device (None at the ranks of another
process). Where every group of the axis lies in one process, a collective
is plain tensor arithmetic across the list:

  - :func:`psum` sums a group in rank order, so the result is the same on
    every run and on every rank;
  - :func:`psum_scatter` is ``psum_scatter(..., tiled=True)``: the sum,
    split along one dimension, block ``p`` to the rank at axis index ``p``;
  - :func:`pmax` is ``lax.pmax`` and :func:`all_gather` is
    ``all_gather(..., tiled=True)`` of one or more sharded values (the
    group's blocks joined in rank order), both given where the sharded
    step reads them: at each group's first rank only, None at the others;
  - :func:`ppermute_from_next` and :func:`ppermute_from_prev` are the
    open-chain permutes of the halo exchange, with zeros where a rank has no
    source;
  - :func:`axis_index` is ``lax.axis_index``.

Ranks of one group that share a device share one result tensor: treat
results as read-only.

Where a group crosses a process (a mesh over several processes,
``parallel/distributed.py``), the payloads go through the process group: a
psum gathers every rank's partial and adds the group's partials in rank
order, as in one process (not ``all_reduce``), so the products are the
same bits as one process's on the same device type; a permute sends the
pairs that cross a process by ``batch_isend_irecv``.

Byte counts (the counterpart of ``blah2_tpu/parallel/commstats.py``, which
reads them from compiled HLO): inside ``with count_bytes(mesh) as ops:``
every collective call appends one :class:`CollectiveOp` with the bytes one
rank contributes, as the HLO counts them (a psum or a permute: the rank's
payload; a psum_scatter: the rank's block of the result; an all-gather:
the gathered result).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple

import torch

from blah2_tpu_torch.parallel import distributed
from blah2_tpu_torch.parallel.mesh import RadarMesh


class CollectiveOp(NamedTuple):
    kind: str              # "psum", "pmax", "psum_scatter", "all_gather"
    axis: str              # or "permute"
    shape: tuple           # one rank's payload (psum_scatter: its block;
    #                        all_gather: the gathered result)
    dtype: torch.dtype
    bytes_per_rank: int


@contextlib.contextmanager
def count_bytes(mesh: RadarMesh) -> Iterator[List[CollectiveOp]]:
    """Record every collective on ``mesh`` while the block runs."""
    saved = mesh.comm_log
    mesh.comm_log = ops = []
    try:
        yield ops
    finally:
        mesh.comm_log = saved


def summarize(ops) -> Dict[str, dict]:
    """Count and bytes per rank by kind."""
    out: Dict[str, dict] = {}
    for op in ops:
        d = out.setdefault(op.kind, {"count": 0, "bytes_per_rank": 0})
        d["count"] += 1
        d["bytes_per_rank"] += op.bytes_per_rank
    return out


def record(mesh: RadarMesh, kind: str, axis: str, shape, dtype) -> None:
    """Append one collective call to the mesh's log, if one is open."""
    if mesh.comm_log is None:
        return
    numel = 1
    for s in shape:
        numel *= int(s)
    itemsize = torch.empty((), dtype=dtype).element_size()
    mesh.comm_log.append(CollectiveOp(kind, axis, tuple(shape), dtype,
                                      numel * itemsize))


def axis_index(mesh: RadarMesh, rank: int, axis: str = "pulse") -> int:
    return mesh.axis_index(rank, axis)


def local(xs: List, mesh: RadarMesh):
    """The first of this process's tensors in a per-rank list."""
    return xs[mesh.local_ranks[0]]


def gather_ranks(xs: List[torch.Tensor], mesh: RadarMesh) -> List:
    """Every rank's tensor in this process, on its first rank's device
    (local ranks' as they are): an all-gather over the processes."""
    home = mesh.device
    mine = torch.stack([xs[r].to(home) for r in mesh.local_ranks])
    out = []
    for p, block in enumerate(distributed.all_gather(mine)):
        out.extend(block.unbind(0) if p != mesh.process_index
                   else [xs[r] for r in mesh.local_ranks])
    return out


def _group_sums(xs: List[torch.Tensor], mesh: RadarMesh, axis: str,
                op=torch.add, first_only: bool = False) -> List:
    """Each local rank's group reduction by ``op`` (a sum by default), in
    rank order, on the rank's device; with ``first_only``, at each group's
    first rank only (None elsewhere)."""
    if mesh.crosses(axis):
        xs = gather_ranks(xs, mesh)
    out: List = [None] * len(xs)
    for group in mesh.groups(axis):
        per_device: dict = {}
        for r in group[:1] if first_only else group:
            if not mesh.is_local(r):
                continue
            dev = xs[r].device
            if dev not in per_device:
                acc = xs[group[0]].to(dev)
                for q in group[1:]:
                    acc = op(acc, xs[q].to(dev))
                per_device[dev] = acc
            out[r] = per_device[dev]
    return out


def psum(xs: List[torch.Tensor], mesh: RadarMesh, axis: str = "pulse",
         first_only: bool = False) -> List[torch.Tensor]:
    """``lax.psum``: every rank gets the sum over its ``axis`` group (with
    ``first_only``, only each group's first rank, where only it is read:
    ranks on other devices are then spared their copies)."""
    x0 = local(xs, mesh)
    record(mesh, "psum", axis, x0.shape, x0.dtype)
    return _group_sums(xs, mesh, axis, first_only=first_only)


def pmax(xs: List[torch.Tensor], mesh: RadarMesh,
         axis: str = "pulse") -> List[torch.Tensor]:
    """``lax.pmax`` where the step reads it: the elementwise max over each
    ``axis`` group, at the group's first rank (None at the others)."""
    x0 = local(xs, mesh)
    record(mesh, "pmax", axis, x0.shape, x0.dtype)
    return _group_sums(xs, mesh, axis, torch.maximum, first_only=True)


def all_gather(fields: List[List[torch.Tensor]], mesh: RadarMesh,
               axis: str = "pulse", dim: int = 1) -> List:
    """``lax.all_gather(..., axis=dim, tiled=True)`` of each sharded value
    in ``fields``, where the step reads it: at the first rank of each
    ``axis`` group that lies in this process, the tuple of the fields'
    gathered tensors (the group's blocks joined along ``dim`` in rank
    order, on that rank's device); None at every other rank. Over
    several processes every local rank's fields travel as one byte buffer
    in one process-group all-gather. Records one op per field, its
    gathered shape."""
    n = mesh.shape[axis]
    for xs in fields:
        x0 = local(xs, mesh)
        shape = list(x0.shape)
        shape[dim] *= n
        record(mesh, "all_gather", axis, shape, x0.dtype)
    if mesh.crosses(axis):
        fields = _gather_fields(fields, mesh)
    out: List = [None] * mesh.size
    for group in mesh.groups(axis):
        first = group[0]
        if mesh.is_local(first):
            dev = fields[0][first].device
            out[first] = tuple(torch.cat([xs[r].to(dev) for r in group],
                                         dim=dim) for xs in fields)
    return out


def _gather_fields(fields: List[List[torch.Tensor]],
                   mesh: RadarMesh) -> List[List[torch.Tensor]]:
    """Every rank's fields in this process (other processes' on this
    process's first rank's device): each local rank's fields as bytes,
    each field's padded to 8, in one all-gather over the processes."""
    home = mesh.device
    specs = []
    for xs in fields:
        x0 = local(xs, mesh)
        nbytes = x0.numel() * x0.element_size()
        specs.append((x0.shape, x0.dtype, nbytes, -(-nbytes // 8) * 8))
    room = sum(spec[3] for spec in specs)
    mine = torch.zeros((mesh.per_process, room), dtype=torch.uint8,
                       device=home)
    for i, r in enumerate(mesh.local_ranks):
        off = 0
        for xs, (_, _, nbytes, pad) in zip(fields, specs):
            mine[i, off:off + nbytes] = xs[r].to(home).contiguous() \
                .reshape(-1).view(torch.uint8)
            off += pad
    out = [list(xs) for xs in fields]
    for p, block in enumerate(distributed.all_gather(mine)):
        if p == mesh.process_index:
            continue
        for i, raw in enumerate(block.unbind(0)):
            r = p * mesh.per_process + i
            off = 0
            for k, (shape, dtype, nbytes, pad) in enumerate(specs):
                out[k][r] = raw[off:off + nbytes].view(dtype).reshape(shape)
                off += pad
    return out


def psum_scatter(xs: List[torch.Tensor], mesh: RadarMesh,
                 axis: str = "pulse", dim: int = 0) -> List[torch.Tensor]:
    """``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``: the
    group sum split in equal blocks along ``dim``, block ``p`` to the rank
    at axis index ``p``."""
    n = mesh.shape[axis]
    x0 = local(xs, mesh)
    size = x0.shape[dim]
    if size % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size {size} does "
                         f"not split over {n} ranks")
    shape = list(x0.shape)
    shape[dim] = size // n
    record(mesh, "psum_scatter", axis, shape, x0.dtype)
    sums = _group_sums(xs, mesh, axis)
    return [None if s is None else
            s.narrow(dim, mesh.axis_index(r, axis) * (size // n), size // n)
            for r, s in enumerate(sums)]


def exchange(xs: List[torch.Tensor], mesh: RadarMesh, pairs) -> dict:
    """The payloads of ``pairs`` (sender rank, receiver rank) that cross a
    process: this process sends ``xs`` of its senders and returns
    {receiver: tensor} for its receivers, each on the receiver's device
    (every rank's payload has the receiver's own shape and type)."""
    sends, recvs = [], []
    for s, r in sorted(pairs, key=lambda sr: sr[1]):
        ps, pr = mesh.process_of(s), mesh.process_of(r)
        if ps == pr:
            continue
        if ps == mesh.process_index:
            sends.append((pr, r, xs[s]))
        elif pr == mesh.process_index:
            recvs.append((ps, r, xs[r]))
    got = distributed.send_recv(sends, recvs) if sends or recvs else []
    return {r: t for (_, r, _), t in zip(recvs, got)}


def _ppermute(xs: List[torch.Tensor], mesh: RadarMesh, axis: str,
              step: int) -> List[torch.Tensor]:
    """Rank at axis index p receives the tensor of index p + step; zeros
    where that index is off the open chain."""
    x0 = local(xs, mesh)
    record(mesh, "permute", axis, x0.shape, x0.dtype)
    pairs = [(group[i + step], r) for group in mesh.groups(axis)
             for i, r in enumerate(group) if 0 <= i + step < len(group)]
    crossed = exchange(xs, mesh, pairs) if mesh.crosses(axis) else {}
    src = {r: s for s, r in pairs}
    out: List = [None] * len(xs)
    for r in mesh.local_ranks:
        if r in crossed:
            out[r] = crossed[r]
        elif r in src:
            out[r] = xs[src[r]].to(xs[r].device, copy=True)
        else:
            out[r] = torch.zeros_like(xs[r])
    return out


def ppermute_from_next(xs: List[torch.Tensor], mesh: RadarMesh,
                       axis: str = "pulse") -> List[torch.Tensor]:
    """``lax.ppermute`` with pairs (d, d − 1): d ← d + 1, zeros on the
    last rank of each group."""
    return _ppermute(xs, mesh, axis, +1)


def ppermute_from_prev(xs: List[torch.Tensor], mesh: RadarMesh,
                       axis: str = "pulse") -> List[torch.Tensor]:
    """``lax.ppermute`` with pairs (d, d + 1): d ← d − 1, zeros on the
    first rank of each group."""
    return _ppermute(xs, mesh, axis, -1)
