"""The halo kernel's flag protocol (``csrc/halo.cu``, ``ops/halo.py``):
semaphores that a launch signals and consumes by stores, so that a launch's
parameters never change and a CUDA graph replays it.

The protocol holds where every flag word that a call signals is consumed
exactly once in the same call, across every launch of every process of the
job. The blocks of each process's launches come from ``ops/halo.py``
``routes`` (the layout alone) and what each block signals and consumes
from ``semaphores``, the function the launch tables are built with; these
tests build every process's view of a mesh (as
``test_torch_multiprocess.py``'s ``as_process`` does: the process count,
index and job patched, no job started) over 1 × 2 to 2 × 4 meshes on 1, 2
and 4 cards and 1, 2 and 4 processes, both directions, with and without
the mask, and count. On the CPU the wrapper takes its plain twin, which is
held against JAX's Pallas kernel in interpret mode. The card's checks are
``tests/test_torch_cuda.py``'s ``halo_flags`` cases and ``chip_smoke.py``
``phase_halo_flags``.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from blah2_tpu_torch.ops.halo import (HaloKernel, halo_permute_plain, routes,
                                      semaphores)
from blah2_tpu_torch.parallel import distributed
from blah2_tpu_torch.parallel.mesh import make_radar_mesh

torch.set_num_threads(1)

MESHES = [(1, 2), (1, 4), (1, 8), (2, 2), (2, 4)]


def _layouts():
    """(cards, processes, hosts) of the job layouts: each process takes its
    share of the cards (one card shared by every process where there are
    fewer cards than processes, the gloo layout)."""
    out = []
    for procs in (1, 2, 4):
        for cards in (1, 2, 4):
            out.append((cards, procs, ("",) * procs))
        if procs == 4:
            out.append((4, 4, ("a", "a", "b", "b")))
    return out


def _process_view(monkeypatch, shape, cards, procs, hosts, k):
    """Process ``k``'s mesh of ``shape``: its ranks filled over its share of
    ``cards`` cards in rank order, and whether its job's payloads take NCCL
    (every process on cards of its own)."""
    size = shape[0] * shape[1]
    nccl = procs > 1 and cards >= procs
    monkeypatch.setattr(distributed, "process_count", lambda: procs)
    monkeypatch.setattr(distributed, "process_index", lambda: k)
    monkeypatch.setattr(distributed, "job", lambda: distributed.Job(
        "nccl" if nccl else "gloo", "", hosts, (), None))
    mine = ([c for c in range(cards) if c * procs // cards == k]
            if cards >= procs else [k * cards // procs])
    per = size // procs
    devices = [torch.device("cuda", mine[i * len(mine) // per])
               for i in range(per)]
    return make_radar_mesh(*shape, devices=devices), nccl


def _count(views):
    """Signals and consumptions of the arrive and the ready words, by rank,
    over every block of every launch that takes flags."""
    tally = {k: collections.Counter() for k in (
        "signal_arrive", "consume_arrive", "signal_ready", "consume_ready")}
    for plan in views:
        if not plan.flags:
            continue
        for card in plan.blocks:
            for b in card:
                for k, rank in semaphores(b)._asdict().items():
                    if rank is not None:
                        tally[k][rank] += 1
    return tally


@pytest.mark.parametrize("mask", [False, True], ids=["circular", "masked"])
@pytest.mark.parametrize("to_left", [True, False], ids=["left", "right"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{c}x{p}" for c, p in MESHES])
def test_every_flag_word_is_signalled_and_consumed_once(monkeypatch, shape,
                                                        to_left, mask):
    """Across all processes' plans of a call, each arrive and each ready
    word that is signalled is consumed exactly once, and none is consumed
    that nobody signals; every rank whose payload comes by the kernel
    consumes its ready word; a launch holds at most one block a rank of
    its card."""
    size = shape[0] * shape[1]
    checked = 0
    for cards, procs, hosts in _layouts():
        if size % procs or (size // procs) % max(1, cards // procs):
            continue
        views = []
        for k in range(procs):
            mesh, nccl = _process_view(monkeypatch, shape, cards, procs,
                                       hosts, k)
            plan = routes(mesh, "pulse", to_left, mask, nccl)
            views.append(plan)
            if plan.flags:
                assert all(len(c) <= 2 * len(mesh.local_ranks)
                           for c in plan.blocks)
                fed = {b.ready for card in plan.blocks for b in card
                       if b.ready is not None}
                assert all(mesh.is_local(r) for r in fed)
                assert len(fed) >= plan.counts["kernel"] + plan.counts["ipc"]
        tally = _count(views)
        where = (shape, cards, procs, hosts)
        for kind in ("arrive", "ready"):
            signalled = tally["signal_" + kind]
            consumed = tally["consume_" + kind]
            assert signalled == consumed, (kind, where)
            assert set(signalled.values()) <= {1}, (kind, where)
        checked += 1
    assert checked >= 4


@pytest.mark.parametrize("shape", MESHES, ids=[f"{c}x{p}" for c, p in MESHES])
def test_flags_on_one_card_wait_on_blocks_of_one_launch(monkeypatch, shape):
    """The one-card plan with flags: one launch of one block a rank, each
    block signalling its own arrive and consuming its receiver's, and every
    word signalled and consumed once."""
    monkeypatch.setattr(distributed, "job", lambda: None)
    size = shape[0] * shape[1]
    mesh = make_radar_mesh(*shape, devices=[torch.device("cuda", 0)] * size)
    for to_left in (True, False):
        for mask in (False, True):
            plain = routes(mesh, "pulse", to_left, mask, False)
            plan = routes(mesh, "pulse", to_left, mask, False,
                          flags_on_one_card=True)
            assert not plain.flags and plan.flags and not plan.ipc
            (blocks,) = plan.blocks
            assert [b.src for b in blocks] == list(range(size))
            assert all(b.arrive == b.ready == b.src for b in blocks)
            assert [b[:3] for b in blocks] == [b[:3] for b in plain.blocks[0]]
            tally = _count([plan])
            for kind in ("arrive", "ready"):
                assert tally["signal_" + kind] == tally["consume_" + kind] \
                    == collections.Counter(range(size))


def test_a_block_without_a_receiver_signals_only_its_own_words():
    """A block whose payload leaves by the group still arrives and consumes
    its own ready word; a zero-filling block without a source takes no
    flag."""
    from blah2_tpu_torch.ops.halo import Block

    assert semaphores(Block(1, None, False, 1, 1)) == (1, None, None, 1)
    assert semaphores(Block(None, 3, True, None, None)) == (None,) * 4
    assert semaphores(Block(2, 3, False, None, None)) == (None, 3, 3, None)


def test_flagged_wrapper_takes_the_plain_twin_on_cpu_and_counts_by_name():
    """On the CPU ``HaloKernel(flags_on_one_card=True)`` is the plain twin,
    which equals JAX's Pallas kernel in interpret mode on the same inputs
    (tests/test_torch_halo.py holds the twin to it); its counts carry its
    own name."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from blah2_tpu.parallel.halo import shift_from_next as jax_from_next
    from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
    from blah2_tpu_torch.parallel.halo import shift_from_next

    kernel = HaloKernel(flags_on_one_card=True)
    assert set(kernel.snapshot()) == {"halo_flags", "halo_flags_kernel",
                                      "halo_flags_ipc", "halo_flags_group"}
    kernel.add({"halo_flags": 3, "halo_flags_ipc": 2, "halo": 5})
    assert kernel.launches == 3 and kernel.pairs["ipc"] == 2
    mesh = make_radar_mesh(1, 4, devices=["cpu"] * 4)
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((1, 4 * 16))
         + 1j * rng.standard_normal((1, 4 * 16))).astype(np.complex64)
    parts = [torch.from_numpy(v[0, p * 16:(p + 1) * 16].copy())
             for p in range(4)]
    for mask in (False, True):
        got = kernel(parts, mesh, to_left=True, mask_edge=mask)
        want = halo_permute_plain(parts, mesh, to_left=True, mask_edge=mask)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    jmesh = jax_mesh(1, 4, devices=jax.devices()[:4])
    vs = jax.device_put(jnp.asarray(v), NamedSharding(jmesh,
                                                      P("cpi", "pulse")))
    body = lambda x: jax_from_next(x[0], 5, "pulse", backend="pallas",
                                   interpret=True, n_mesh_axes=2)[None]
    jgot = np.asarray(jax.jit(jax.shard_map(
        body, mesh=jmesh, in_specs=P("cpi", "pulse"),
        out_specs=P("cpi", "pulse"), check_vma=False))(vs)).reshape(4, 5)
    import blah2_tpu_torch.parallel.halo as phalo

    saved = phalo.halo_permute
    phalo.halo_permute = kernel
    try:
        mine = shift_from_next(parts, 5, mesh, backend="pallas")
    finally:
        phalo.halo_permute = saved
    for p in range(4):
        np.testing.assert_array_equal(mine[p].numpy(), jgot[p])
