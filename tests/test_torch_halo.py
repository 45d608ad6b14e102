"""The port's mesh, collectives and halo exchange (``blah2_tpu_torch/
parallel/`` and ``ops/halo.py``) against the JAX package's on the same
numpy inputs. The JAX side runs on the virtual 8-device CPU mesh, its
"pallas" backend in interpret mode, as tests/test_halo.py runs it; the
port's runs 8 logical ranks on ``cpu``, where "pallas" is the kernel's
plain twin."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from blah2_tpu.parallel.halo import shift_from_next as jax_from_next
from blah2_tpu.parallel.halo import shift_from_prev as jax_from_prev
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
from blah2_tpu_torch.ops import halo as thalo
from blah2_tpu_torch.parallel import collectives as coll
from blah2_tpu_torch.parallel.halo import shift_from_next, shift_from_prev
from blah2_tpu_torch.parallel.mesh import RadarMesh, make_radar_mesh

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _jax_shift(v, shape, count, direction, backend):
    """JAX's shift_from_next/prev of the (n_cpi, n_pulse * blk) array ``v``
    under shard_map on the (cpi, pulse) mesh."""
    mesh = jax_mesh(*shape)
    fn = jax_from_next if direction == "next" else jax_from_prev
    vs = jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("cpi", "pulse")))

    def body(x):
        kw = dict(backend=backend)
        if backend == "pallas":
            kw.update(interpret=True, n_mesh_axes=2)
        return fn(x[0], count, "pulse", **kw)[None]

    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("cpi", "pulse"),
        out_specs=P("cpi", "pulse"), check_vma=False))(vs))


@pytest.mark.parametrize("backend", ["ppermute", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64],
                         ids=["f32", "c64"])
@pytest.mark.parametrize("direction", ["next", "prev"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
def test_shift_matches_jax(shape, direction, dtype, backend):
    n_cpi, n_pulse = shape
    count, blk = 7, 32
    rng = np.random.default_rng(3)
    v = rng.standard_normal((n_cpi, n_pulse * blk))
    if dtype == np.complex64:
        v = v + 1j * rng.standard_normal((n_cpi, n_pulse * blk))
    v = v.astype(dtype)
    want = _jax_shift(v, shape, count, direction, backend)
    want = want.reshape(n_cpi, n_pulse, count)

    mesh = make_radar_mesh(*shape, devices=CPU8)
    parts = [torch.from_numpy(v[c, p * blk:(p + 1) * blk].copy())
             for c in range(n_cpi) for p in range(n_pulse)]
    fn = shift_from_next if direction == "next" else shift_from_prev
    got = fn(parts, count, mesh, backend=backend, collective_id=1)
    for r, g in enumerate(got):
        c, p = mesh.coords(r)
        assert g.dtype == parts[r].dtype and g.shape == (count,)
        np.testing.assert_array_equal(g.numpy(), want[c, p])


def test_overlap_save_fir_with_pallas_halo():
    """Distributed causal FIR over a 1 x 8 mesh with the left halo through
    the "pallas" backend: equal to a single-host convolution, as
    tests/test_halo.py holds the JAX kernel."""
    n_dev, blk, n_taps = 8, 128, 9
    rng = np.random.default_rng(11)
    x = rng.standard_normal(n_dev * blk).astype(np.float32)
    w = rng.standard_normal(n_taps).astype(np.float32)
    expected = np.convolve(x, w)[: x.size]

    mesh = make_radar_mesh(1, 8, devices=CPU8)
    parts = [torch.from_numpy(x[p * blk:(p + 1) * blk].copy())
             for p in range(n_dev)]
    halos = shift_from_prev(parts, n_taps - 1, mesh, backend="pallas")
    out = [np.convolve(np.concatenate([h.numpy(), xl.numpy()]), w)
           [n_taps - 1: n_taps - 1 + blk] for h, xl in zip(halos, parts)]
    np.testing.assert_allclose(np.concatenate(out), expected, atol=1e-4)


def test_batched_halo_carries_leading_dims():
    """A (B, block) payload per rank: each CPI row of the batch gets its
    own neighbour's head, complex re-formed from planes."""
    mesh = make_radar_mesh(2, 4, devices=CPU8)
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal((3, 20))
                              + 1j * rng.standard_normal((3, 20)))
             for _ in range(8)]
    for backend in ("ppermute", "pallas"):
        got = shift_from_next(parts, 4, mesh, backend=backend)
        for r, g in enumerate(got):
            c, p = mesh.coords(r)
            assert g.shape == (3, 4) and g.dtype == torch.complex128
            want = torch.zeros(3, 4, dtype=torch.complex128) if p == 3 \
                else parts[r + 1][:, :4]
            assert torch.equal(g, want)


# -- the kernel's plain twin and its wrapper ---------------------------------

@pytest.mark.parametrize("to_left", [True, False])
def test_halo_permute_plain_is_circular(to_left):
    mesh = make_radar_mesh(2, 4, devices=CPU8)
    bufs = [torch.full((5, 2), float(r)) for r in range(8)]
    got = thalo.halo_permute_plain(bufs, mesh, "pulse", to_left=to_left)
    for r, g in enumerate(got):
        c, p = mesh.coords(r)
        src = c * 4 + ((p + 1) % 4 if to_left else (p - 1) % 4)
        assert torch.equal(g, bufs[src]) and g is not bufs[src]
    # Along the cpi axis the rings are the columns.
    got = thalo.halo_permute_plain(bufs, mesh, "cpi", to_left=True)
    assert [int(g[0, 0]) for g in got] == [4, 5, 6, 7, 0, 1, 2, 3]


def test_halo_wrapper_takes_the_plain_twin_on_cpu():
    mesh = make_radar_mesh(1, 8, devices=CPU8)
    bufs = [torch.randn(409, 2) for _ in range(8)]
    before = thalo.halo_permute.launches
    got = thalo.halo_permute(bufs, mesh, to_left=False, collective_id=3)
    assert thalo.halo_permute.launches == before
    want = thalo.halo_permute_plain(bufs, mesh, to_left=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert thalo.halo_permute.error() == 0


def test_unknown_backend_raises():
    mesh = make_radar_mesh(1, 8, devices=CPU8)
    with pytest.raises(ValueError, match="backend"):
        shift_from_next([torch.zeros(4)] * 8, 2, mesh, backend="nccl")


# -- mesh and collectives ----------------------------------------------------

def test_mesh_shapes_and_defaults():
    m = make_radar_mesh(devices=CPU8)
    assert m.shape == {"cpi": 1, "pulse": 8} and m.axis_names == ("cpi",
                                                                   "pulse")
    assert make_radar_mesh(n_pulse=2, devices=CPU8).shape == {"cpi": 4,
                                                              "pulse": 2}
    m = make_radar_mesh(2, devices=CPU8)
    assert m.shape == {"cpi": 2, "pulse": 4}
    assert m.coords(6) == (1, 2) and m.axis_index(6, "pulse") == 2
    assert m.groups("pulse") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.groups("cpi") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_radar_mesh(3, 2, devices=CPU8)
    with pytest.raises(ValueError):
        RadarMesh(2, 2, CPU8)


def test_mesh_needs_a_card_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_radar_mesh(1, 4)


def test_collectives_match_numpy_and_count_bytes():
    mesh = make_radar_mesh(2, 4, devices=CPU8)
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal((3, 8))) for _ in range(8)]
    with coll.count_bytes(mesh) as ops:
        s = coll.psum(xs, mesh, "pulse")
        sc = coll.psum_scatter(xs, mesh, "pulse", dim=1)
        nxt = coll.ppermute_from_next(xs, mesh, "pulse")
        prv = coll.ppermute_from_prev(xs, mesh, "pulse")
        scpi = coll.psum(xs, mesh, "cpi")
    for r in range(8):
        c, p = mesh.coords(r)
        row = [xs[c * 4 + q].numpy() for q in range(4)]
        total = ((row[0] + row[1]) + row[2]) + row[3]  # rank order
        np.testing.assert_array_equal(s[r].numpy(), total)
        np.testing.assert_array_equal(sc[r].numpy(),
                                      total[:, 2 * p:2 * p + 2])
        np.testing.assert_array_equal(
            nxt[r].numpy(), row[p + 1] if p < 3 else np.zeros((3, 8)))
        np.testing.assert_array_equal(
            prv[r].numpy(), row[p - 1] if p > 0 else np.zeros((3, 8)))
        np.testing.assert_array_equal(scpi[r].numpy(),
                                      xs[p].numpy() + xs[4 + p].numpy())
        assert coll.axis_index(mesh, r, "cpi") == c
    assert [(op.kind, op.axis, op.shape, op.bytes_per_rank) for op in ops] == [
        ("psum", "pulse", (3, 8), 192), ("psum_scatter", "pulse", (3, 2), 48),
        ("permute", "pulse", (3, 8), 192), ("permute", "pulse", (3, 8), 192),
        ("psum", "cpi", (3, 8), 192)]
    assert coll.summarize(ops)["permute"] == {"count": 2,
                                              "bytes_per_rank": 384}
    assert mesh.comm_log is None  # closed with the block
    with pytest.raises(ValueError, match="split"):
        coll.psum_scatter(xs, mesh, "pulse", dim=0)


# -- the masked, strided form: slices as they lie, complex as it is -----------

def _jax_shift_batched(v, shape, count, direction):
    """JAX's shift on the (n_cpi, B, n_pulse * blk) array ``v``: each rank
    shifts its (B, blk) block, the CPI batch riding along."""
    mesh = jax_mesh(*shape)
    fn = jax_from_next if direction == "next" else jax_from_prev
    spec = P("cpi", None, "pulse")
    vs = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))

    def body(x):
        return fn(x[0], count, "pulse", backend="pallas", interpret=True,
                  n_mesh_axes=2)[None]

    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=spec, out_specs=spec,
        check_vma=False))(vs))


@pytest.mark.parametrize("batch", [1, 2], ids=["B1", "B2"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.complex128],
                         ids=["f32", "c64", "c128"])
@pytest.mark.parametrize("direction", ["next", "prev"])
def test_masked_strided_halo_matches_jax(direction, dtype, batch):
    """The halo wrapper with the edge mask, on (B, blk) blocks sliced where
    they lie, against JAX's shift_from_next/prev on the 2 x 4 mesh; the
    kernel's row layout of each slice: B runs at the block's row stride."""
    shape, count, blk = (2, 4), 5, 24
    rng = np.random.default_rng(17)
    v = rng.standard_normal((2, batch, 4 * blk))
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(v.shape)
    v = v.astype(dtype)
    want = _jax_shift_batched(v, shape, count, direction)
    want = want.reshape(2, batch, 4, count)

    mesh = make_radar_mesh(*shape, devices=CPU8)
    blocks = [torch.from_numpy(v[c, :, p * blk:(p + 1) * blk].copy())
              for c in range(2) for p in range(4)]
    head = direction == "next"
    parts = [b[..., :count] if head else b[..., -count:] for b in blocks]
    per_word = parts[0].element_size() // 4
    assert thalo.row_layout(parts[0]) == (batch, count * per_word,
                                          blk * per_word if batch > 1
                                          else count * per_word)
    got = thalo.halo_permute(parts, mesh, to_left=head, collective_id=2,
                             mask_edge=True)
    shifted = (shift_from_next if head else shift_from_prev)(
        blocks, count, mesh, backend="pallas", collective_id=2)
    for r in range(8):
        c, p = mesh.coords(r)
        assert got[r].dtype == parts[r].dtype
        assert got[r].shape == (batch, count)
        np.testing.assert_array_equal(got[r].numpy(), want[c, :, p])
        assert torch.equal(shifted[r], got[r])


@pytest.mark.parametrize("to_left", [True, False])
def test_halo_permute_plain_masks_the_edge(to_left):
    mesh = make_radar_mesh(2, 4, devices=CPU8)
    bufs = [torch.full((3, 2), float(r + 1)) for r in range(8)]
    got = thalo.halo_permute_plain(bufs, mesh, to_left=to_left,
                                   mask_edge=True)
    circ = thalo.halo_permute_plain(bufs, mesh, to_left=to_left)
    for r in range(8):
        _, p = mesh.coords(r)
        edge = p == (3 if to_left else 0)
        assert torch.equal(got[r], torch.zeros(3, 2) if edge else circ[r])


@pytest.mark.parametrize("case", ["c64-head", "c128-tail", "f32-1d",
                                  "f64-contiguous", "f32-3d"])
def test_row_layout(case):
    """How the kernel reads a payload: runs of 32-bit words at a stride."""
    blk = torch.zeros(3, 50, dtype=torch.complex128)
    t, want = {
        "c64-head": (blk.to(torch.complex64)[:, :7], (3, 14, 100)),
        "c128-tail": (blk[:, -7:], (3, 28, 200)),
        "f32-1d": (torch.zeros(50)[:9], (1, 9, 9)),
        "f64-contiguous": (torch.zeros(3, 7, dtype=torch.float64),
                           (3, 14, 14)),
        "f32-3d": (torch.zeros(2, 3, 50)[..., 10:20], (6, 10, 50)),
    }[case]
    assert thalo.row_layout(t) == want


def test_row_layout_rejects_what_the_kernel_cannot_read():
    with pytest.raises(ValueError, match="contiguous"):
        thalo.row_layout(torch.zeros(2, 8).t())
    with pytest.raises(ValueError, match="contiguous"):
        thalo.row_layout(torch.zeros(4, 6, 5)[:, :3, :2])
    with pytest.raises(TypeError, match="float32 or float64"):
        thalo.row_layout(torch.zeros(4, dtype=torch.float16))
