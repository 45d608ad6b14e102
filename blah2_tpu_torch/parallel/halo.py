"""Neighbour halo exchange for the (cpi, pulse)-sharded pipeline
(counterpart of ``blah2_tpu/parallel/halo.py``).

Two interchangeable backends behind one interface, under the JAX package's
names so that a ``--halo-backend`` option passes through unchanged:

  - ``"ppermute"``: the open-chain permute of ``parallel/collectives.py``,
    zeros where a rank has no source: the linear (zero-extended) boundary
    the overlap-save decomposition needs.
  - ``"pallas"``: the hand-written CUDA kernel ``csrc/halo.cu`` on a card
    (``ops/halo.py``), and its plain twin on the CPU, with the edge mask:
    the kernel zero-fills the wrap-around edge that the JAX code masks, and
    reads each rank's slice where it lies, complex as it is. On one card
    a shift is one launch.

A sharded value is a list with one tensor per rank of the mesh (None at the
ranks of another process); the halo is taken along the last dimension, so a
leading CPI batch rides along, or, by :func:`rows_from_next` and
:func:`rows_from_prev`, as whole rows along dimension −2 (each CPI's rows
of a (B, R, n) block are one run, so the payload passes as it lies).
"""

from __future__ import annotations

from typing import List

import torch

from blah2_tpu_torch.ops.halo import halo_permute
from blah2_tpu_torch.parallel.collectives import (ppermute_from_next,
                                                  ppermute_from_prev, record)
from blah2_tpu_torch.parallel.mesh import RadarMesh

BACKENDS = ("ppermute", "pallas")


def _shift(parts: List[torch.Tensor], mesh: RadarMesh, axis: str,
           backend: str, collective_id: int, from_next: bool):
    if backend == "ppermute":
        fn = ppermute_from_next if from_next else ppermute_from_prev
        return fn(parts, mesh, axis)
    if backend != "pallas":
        raise ValueError(f"unknown halo backend {backend!r}")
    p0 = parts[mesh.local_ranks[0]]
    record(mesh, "permute", axis, p0.shape, p0.dtype)
    return halo_permute(parts, mesh, axis, to_left=from_next,
                        collective_id=collective_id, mask_edge=True)


def shift_from_next(vs: List[torch.Tensor], count: int, mesh: RadarMesh,
                    axis: str = "pulse", backend: str = "ppermute",
                    collective_id: int = 0) -> List[torch.Tensor]:
    """First ``count`` samples of the *next* rank's block (d ← d+1); zeros
    on the last rank of each ring (linear/zero-extended boundary)."""
    return _shift([None if v is None else v[..., :count] for v in vs], mesh,
                  axis, backend, collective_id, from_next=True)


def shift_from_prev(vs: List[torch.Tensor], count: int, mesh: RadarMesh,
                    axis: str = "pulse", backend: str = "ppermute",
                    collective_id: int = 0) -> List[torch.Tensor]:
    """Last ``count`` samples of the *previous* rank's block (d ← d−1);
    zeros on rank 0 of each ring."""
    return _shift([None if v is None else v[..., -count:] for v in vs], mesh,
                  axis, backend, collective_id, from_next=False)


def _rows(vs, count, mesh, axis, backend, collective_id, from_next):
    """``count`` ≥ 1 rows of dimension −2, the head or the tail of each
    block, shifted with the blocks' last two dimensions flattened; a
    (B, count, n) block per rank."""
    if count < 1:
        raise ValueError(f"halo: a row halo of {count} rows")
    n = next(v for v in vs if v is not None).shape[-1]
    parts = [None if v is None else v.flatten(-2)[..., :count * n]
             if from_next else v.flatten(-2)[..., -count * n:] for v in vs]
    out = _shift(parts, mesh, axis, backend, collective_id, from_next)
    return [None if o is None else o.unflatten(-1, (count, n)) for o in out]


def rows_from_next(vs: List[torch.Tensor], count: int, mesh: RadarMesh,
                   axis: str = "pulse", backend: str = "ppermute",
                   collective_id: int = 0) -> List[torch.Tensor]:
    """First ``count`` rows (dimension −2) of the *next* rank's block
    (d ← d+1); zeros on the last rank of each ring."""
    return _rows(vs, count, mesh, axis, backend, collective_id, True)


def rows_from_prev(vs: List[torch.Tensor], count: int, mesh: RadarMesh,
                   axis: str = "pulse", backend: str = "ppermute",
                   collective_id: int = 0) -> List[torch.Tensor]:
    """Last ``count`` rows (dimension −2) of the *previous* rank's block
    (d ← d−1); zeros on rank 0 of each ring."""
    return _rows(vs, count, mesh, axis, backend, collective_id, False)
