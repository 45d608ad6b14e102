"""Collectives over the logical ranks of a :class:`RadarMesh`.

The counterparts of the ``jax.lax`` collectives that the sharded step uses
(``blah2_tpu/parallel/sharded.py:358-359, 581-583, 617-619`` and
``blah2_tpu/parallel/halo.py:37-46``). A sharded value is a list with one
tensor per rank, each on its rank's device. One process runs every rank, so
a collective is plain tensor arithmetic across the list:

  - :func:`psum` sums a group in rank order, so the result is the same on
    every run and on every rank;
  - :func:`psum_scatter` is ``psum_scatter(..., tiled=True)``: the sum,
    split along one dimension, block ``p`` to the rank at axis index ``p``;
  - :func:`ppermute_from_next` and :func:`ppermute_from_prev` are the
    open-chain permutes of the halo exchange, with zeros where a rank has no
    source;
  - :func:`axis_index` is ``lax.axis_index``.

Ranks of one group that share a device share one result tensor: treat
results as read-only.

Byte counts (the counterpart of ``blah2_tpu/parallel/commstats.py``, which
reads them from compiled HLO): inside ``with count_bytes(mesh) as ops:``
every collective call appends one :class:`CollectiveOp` with the bytes one
rank contributes, as the HLO counts them (a psum or a permute: the rank's
payload; a psum_scatter: the rank's block of the result).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple

import torch

from blah2_tpu_torch.parallel.mesh import RadarMesh


class CollectiveOp(NamedTuple):
    kind: str              # "psum", "psum_scatter" or "permute"
    axis: str
    shape: tuple           # one rank's payload (psum_scatter: its block)
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


def _group_sums(xs: List[torch.Tensor], mesh: RadarMesh,
                axis: str) -> List[torch.Tensor]:
    """Each rank's group sum, in rank order, on the rank's device."""
    out: List = [None] * len(xs)
    for group in mesh.groups(axis):
        per_device: dict = {}
        for r in group:
            dev = xs[r].device
            if dev not in per_device:
                acc = xs[group[0]].to(dev)
                for q in group[1:]:
                    acc = acc + xs[q].to(dev)
                per_device[dev] = acc
            out[r] = per_device[dev]
    return out


def psum(xs: List[torch.Tensor], mesh: RadarMesh,
         axis: str = "pulse") -> List[torch.Tensor]:
    """``lax.psum``: every rank gets the sum over its ``axis`` group."""
    record(mesh, "psum", axis, xs[0].shape, xs[0].dtype)
    return _group_sums(xs, mesh, axis)


def psum_scatter(xs: List[torch.Tensor], mesh: RadarMesh,
                 axis: str = "pulse", dim: int = 0) -> List[torch.Tensor]:
    """``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``: the
    group sum split in equal blocks along ``dim``, block ``p`` to the rank
    at axis index ``p``."""
    n = mesh.shape[axis]
    size = xs[0].shape[dim]
    if size % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size {size} does "
                         f"not split over {n} ranks")
    shape = list(xs[0].shape)
    shape[dim] = size // n
    record(mesh, "psum_scatter", axis, shape, xs[0].dtype)
    sums = _group_sums(xs, mesh, axis)
    return [s.narrow(dim, mesh.axis_index(r, axis) * (size // n), size // n)
            for r, s in enumerate(sums)]


def _ppermute(xs: List[torch.Tensor], mesh: RadarMesh, axis: str,
              step: int) -> List[torch.Tensor]:
    """Rank at axis index p receives the tensor of index p + step; zeros
    where that index is off the open chain."""
    record(mesh, "permute", axis, xs[0].shape, xs[0].dtype)
    out: List = [None] * len(xs)
    for group in mesh.groups(axis):
        for i, r in enumerate(group):
            j = i + step
            if 0 <= j < len(group):
                out[r] = xs[group[j]].to(xs[r].device, copy=True)
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
