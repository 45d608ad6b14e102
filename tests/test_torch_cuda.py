"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a CUDA device they skip: a CUDA kernel has no CPU mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor
from blah2_tpu_torch.ops import detect as tdetect
from blah2_tpu_torch.ops.detect import FusedDetector, detect_plain

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _map(nr, nc, seed, targets=()):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((nr, nc))
         + 1j * rng.standard_normal((nr, nc))).astype(np.complex64)
    for r, c, a in targets:
        z[r, c] += a
    return z


def _tie_map():
    z = np.full((16, 40), 0.05 + 0j, dtype=np.complex64)
    z[8, 20] = z[8, 25] = 50.0
    return z


def _cases():
    amb = AmbiguityProcessor(-10, 400, -200, 200, 2_000_000, 1_500_000,
                             device="cpu")
    default = (1e-5, 2, 6, 5, 15.0, 6, 6, 1 / 0.75, amb.delay_axis,
               amb.doppler_axis)
    loose = (1e-2, 1, 3, 0, 0.0, 6, 6, 2.0)
    half = 8
    tie_axes = (np.arange(-10, 30, dtype=np.int32),
                2.0 * np.arange(-half, 16 - half, dtype=np.float64))
    ragged_axes = (np.arange(-10, 43, dtype=np.int32),
                   2.0 * np.arange(-18, 19, dtype=np.float64))
    wide_axes = (np.arange(-10, 190, dtype=np.int32),
                 2.0 * np.arange(-32, 32, dtype=np.float64))
    return {
        "default-targets": (_map(301, 411, 3, [(150, 200, 80.0),
                                               (40, 30, 60.0)]), default),
        "default-overflow": (_map(301, 411, 4), loose[:8] + (
            amb.delay_axis, amb.doppler_axis)),
        "tie": (_tie_map(), loose + tie_axes),
        # A map smaller than one tile row, targets on its edges.
        "ragged": (_map(37, 53, 5, [(0, 52, 30.0), (36, 3, 30.0),
                                    (18, 26, 40.0)]), loose + ragged_axes),
        # Centroid windows wider than a tile: 41 x 147 cells against
        # 24 x 48 (more than 48 KB of shared memory a block).
        "wide": (_map(64, 200, 6, [(30, 100, 40.0), (33, 150, 45.0)]),
                 (1e-2, 1, 3, 0, 0.0, 74, 21, 2.0) + wide_axes),
    }


def _input(zc, kind):
    """The detector's input: the complex64 map, or the float32 power the
    TPU kernel takes."""
    if kind == "c64":
        return zc.contiguous()
    return (zc.real * zc.real + zc.imag * zc.imag).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "c64"])
@pytest.mark.parametrize("name", ["default-targets", "default-overflow",
                                  "tie", "ragged", "wide"])
def test_kernel_matches_plain_on_card(card, name, kind):
    """csrc/detect.cu against detect_plain on the same card tensors, on
    float32 power and on the complex64 map: one launch a call."""
    z, args = _cases()[name]
    fd = FusedDetector(*args, device=card)
    zc = torch.from_numpy(z).to(card)
    pwr = _input(zc, kind)
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
          fd.win_cols)
    launches = tdetect.detect.launches
    got = tdetect.detect(pwr, *kw)
    torch.cuda.synchronize()
    assert tdetect.detect.launches == launches + 1
    want = detect_plain(pwr, *kw)
    assert torch.equal(got.keep, want.keep)
    assert int(got.keep.sum()) >= 1
    assert float((got.db - want.db).abs().max()) <= 1e-4
    assert abs(float(got.noise - want.noise)) <= 1e-4
    assert abs(float(got.rawmax - want.rawmax)) <= 1e-4
    # The same noise on every run: no float atomics.
    again = tdetect.detect(pwr, *kw)
    assert torch.equal(again.noise, got.noise)
    if name == "tie":
        _, _, _, det = fd(zc)
        assert sorted(det.col[det.valid].tolist()) == [20, 25]


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    pwr = torch.ones(4, 6, device=card)
    scale = torch.ones(1, 6, device=card)
    with pytest.raises(TypeError, match="float32"):
        tdetect.detect(pwr.double(), scale, pwr, 1, 2, 1, 1)
    with pytest.raises(TypeError, match="complex64"):
        tdetect.detect(pwr.to(torch.complex128), scale, pwr, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tdetect.detect(pwr, scale, pwr, 2, 6, 100, 300)
    with pytest.raises(ValueError, match="contiguous"):
        tdetect.detect(pwr, scale, torch.ones(6, 4, device=card).t(), 1, 2,
                       1, 1)
    with pytest.raises(ValueError, match="is on"):
        tdetect.detect(pwr, scale.cpu(), pwr, 1, 2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "c64"])
def test_batched_kernel_matches_plain_on_card(card, kind):
    """One call on a (B, nr, nc) stack: each map against detect_plain on
    the stack and against the kernel's own 2-D call."""
    z_t, args_t = _cases()["default-targets"]
    z_o, _ = _cases()["default-overflow"]
    fd = FusedDetector(*args_t, device=card)
    zc = torch.from_numpy(np.stack([z_t, z_o])).to(card)
    pwr = _input(zc, kind)
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
          fd.win_cols)
    got = tdetect.detect(pwr, *kw)
    want = detect_plain(pwr, *kw)
    torch.cuda.synchronize()
    assert got.noise.shape == (2,) and got.keep.shape == pwr.shape
    assert torch.equal(got.keep, want.keep)
    assert float((got.db - want.db).abs().max()) <= 1e-4
    assert float((got.noise - want.noise).abs().max()) <= 1e-4
    assert float((got.rawmax - want.rawmax).abs().max()) <= 1e-4
    for i in range(2):
        one = tdetect.detect(pwr[i].contiguous(), *kw)
        assert torch.equal(one.keep, got.keep[i])
        assert torch.equal(one.noise, got.noise[i])


@pytest.mark.cuda
def test_kernel_scratch_one_buffer_per_stream(card):
    """The ticket counters and partials: one buffer per (device, stream),
    laid out anew (its counters zeroed) when the stack's shape changes, so
    that calls alternating between shapes stay equal to detect_plain."""
    z_t, args_t = _cases()["default-targets"]
    z_r, args_r = _cases()["ragged"]
    big = FusedDetector(*args_t, device=card)
    small = FusedDetector(*args_r, device=card)
    stack = torch.from_numpy(np.stack([z_t, z_t[::-1].copy()])).to(card)
    calls = [(stack, big), (torch.from_numpy(z_r).to(card), small),
             (stack[1].contiguous(), big)]
    for zc, fd in calls * 2:
        kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
              fd.win_cols)
        got = tdetect.detect(zc, *kw)
        want = detect_plain(zc, *kw)
        assert torch.equal(got.keep, want.keep)
        assert float((got.noise - want.noise).abs().max()) <= 1e-4
    stream = torch.cuda.current_stream(card).cuda_stream
    held = [k for k in tdetect.detect._scratch if k[0] == card.index]
    assert (card.index, stream) in held
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        tdetect.detect(stack, *kw)
    side.synchronize()
    assert len([k for k in tdetect.detect._scratch
                if k[0] == card.index]) == len(held) + 1


def _halo_case(card, shape, count, seed):
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    mesh = make_radar_mesh(*shape, devices=[card] * (shape[0] * shape[1]))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    bufs = [torch.randn((count, 2), generator=gen).to(card)
            for _ in range(mesh.size)]
    return mesh, bufs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
@pytest.mark.parametrize("to_left", [True, False], ids=["left", "right"])
def test_halo_kernel_matches_plain_on_card(card, shape, to_left):
    """csrc/halo.cu against halo_permute_plain, all ranks on one card, over
    repeated calls with new payloads (a stale buffer or epoch shows)."""
    from blah2_tpu_torch.ops.halo import halo_permute, halo_permute_plain

    for i, count in enumerate([409, 10, 1] * 4):
        mesh, bufs = _halo_case(card, shape, count, seed=i)
        launches = halo_permute.launches
        got = halo_permute(bufs, mesh, "pulse", to_left=to_left,
                           collective_id=i % 4)
        want = halo_permute_plain(bufs, mesh, "pulse", to_left=to_left)
        torch.cuda.synchronize()
        assert halo_permute.launches == launches + 1  # one card, one launch
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert halo_permute.error() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.complex128],
                         ids=["f32", "c64", "c128"])
@pytest.mark.parametrize("batch", [1, 2], ids=["B1", "B2"])
def test_halo_kernel_strided_complex_edge_zero(card, shape, dtype, batch):
    """The masked form on slices as they lie: heads and tails of (B, n)
    blocks, complex as it is, the ring's edge zero-filled; bit-equal to the
    plain twin, one launch a call, no flag wait on one card."""
    from blah2_tpu_torch.ops.halo import halo_permute, halo_permute_plain
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    mesh = make_radar_mesh(*shape, devices=[card] * (shape[0] * shape[1]))
    gen = torch.Generator(device="cpu").manual_seed(batch)
    for i, (count, to_left) in enumerate([(409, True), (409, False),
                                          (10, True), (1, False)]):
        blocks = [torch.randn((batch, 1000), generator=gen, dtype=dtype)
                  .to(card) for _ in range(mesh.size)]
        parts = [b[..., :count] if to_left else b[..., -count:]
                 for b in blocks]
        launches = halo_permute.launches
        got = halo_permute(parts, mesh, to_left=to_left, collective_id=i,
                           mask_edge=True)
        want = halo_permute_plain(parts, mesh, to_left=to_left,
                                  mask_edge=True)
        torch.cuda.synchronize()
        assert halo_permute.launches == launches + 1
        for r, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == dtype and g.shape == (batch, count)
            bits = torch.view_as_real(g) if g.is_complex() else g
            wbits = torch.view_as_real(w) if w.is_complex() else w
            assert torch.equal(bits, wbits)
            if mesh.axis_index(r, "pulse") == (shape[1] - 1 if to_left
                                               else 0):
                assert not bool(bits.any())
    assert halo_permute.error() == 0


@pytest.mark.cuda
def test_halo_plans_go_with_the_mesh(card):
    """The wrapper's cached plans are dropped with their mesh."""
    import gc
    import weakref

    from blah2_tpu_torch.ops.halo import halo_permute

    mesh, bufs = _halo_case(card, (1, 4), 8, seed=0)
    halo_permute(bufs, mesh)
    halo_permute(bufs, mesh, to_left=False, mask_edge=True)
    assert len(halo_permute._plans[mesh]) == 2
    alive = weakref.ref(mesh)
    n = len(halo_permute._plans)
    del mesh
    gc.collect()
    assert alive() is None and len(halo_permute._plans) == n - 1


@pytest.mark.cuda
def test_halo_kernel_rejects_what_it_does_not_take(card):
    from blah2_tpu_torch.ops.halo import halo_permute

    mesh, bufs = _halo_case(card, (1, 4), 8, seed=0)
    with pytest.raises(TypeError, match="float32 or float64"):
        halo_permute([b.half() for b in bufs], mesh)
    with pytest.raises(ValueError, match="contiguous"):
        halo_permute([torch.ones(2, 8, device=card).t()] * 4, mesh)
    with pytest.raises(ValueError, match="collective_id"):
        halo_permute(bufs, mesh, collective_id=99)
    with pytest.raises(ValueError, match="one shape"):
        halo_permute(bufs[:3] + [bufs[3][:4]], mesh)


@pytest.mark.cuda
def test_halo_kernel_two_cards(card):
    """A 1 x 2 mesh over two cards: the kernel writes into the peer card's
    buffer (one launch per card) and matches the plain permute."""
    from blah2_tpu_torch.ops.halo import halo_permute, halo_permute_plain
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = make_radar_mesh(1, 2, devices=devs)
    for to_left in (True, False):
        bufs = [torch.randn(409, 2, device=d) for d in devs]
        launches = halo_permute.launches
        got = halo_permute(bufs, mesh, to_left=to_left)
        want = halo_permute_plain(bufs, mesh, to_left=to_left)
        for d in devs:
            torch.cuda.synchronize(d)
        assert halo_permute.launches == launches + 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert halo_permute.error() == 0


@pytest.mark.cuda
def test_sharded_pipeline_across_cards(card):
    """A 1 x n mesh over n >= 2 cards (up to 4): the halo kernel writes
    into the peer cards' buffers, and the products equal the ppermute
    backend's, and a one-card mesh's within float32 rounding. Over the
    cards, as on the one card, the step is captured and says so."""
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two CUDA devices")
    cfg = config_from_dict({
        "capture": {"fs": 80_000, "fc": 204_640_000},
        "process": {
            "data": {"cpi": 0.2},
            "ambiguity": {"delayMin": -5, "delayMax": 60,
                          "dopplerMin": -100, "dopplerMax": 100},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 30},
            "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                          "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                          "nCentroid": 6}}})
    x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                         [TargetSpec(20, -44.0, 0.1)],
                         clutter_amplitude=2.0, noise_amplitude=1e-3, seed=0)
    cards = make_radar_mesh(1, n, devices=[torch.device("cuda", i)
                                           for i in range(n)])
    outs = {}
    for name, mesh, backend in (("cards", cards, "pallas"),
                                ("cards-ppermute", cards, "ppermute"),
                                ("one", make_radar_mesh(
                                    1, n, devices=[card] * n), "pallas")):
        sp = ShardedCpiPipeline(cfg, mesh, halo_backend=backend,
                                use_fused_detect=True)
        assert sp.graph, sp.graph_reason
        if name != "one":
            assert sp.graph_reason == "every rank of this process on " + \
                ", ".join(f"cuda:{i}" for i in range(n)) + ", one process"
        launches = halo_permute.launches
        outs[name] = sp(*sp.shard_inputs(x, y))
        for i in range(n):
            torch.cuda.synchronize(i)
        # Row-sharded: the 4 clutter shifts and the fused detector's 2
        # row halos, one launch a card each.
        want = {"cards": 6 * n, "cards-ppermute": 0, "one": 6}[name]
        assert halo_permute.launches - launches == want
    a, b, c = outs["cards"], outs["cards-ppermute"], outs["one"]
    assert torch.equal(a.db_map, b.db_map)
    for k in a.detections._fields:
        assert torch.equal(getattr(a.detections, k), getattr(b.detections, k))
    assert float((a.db_map - c.db_map).abs().max()) <= 1e-4
    v = a.detections.valid[0]
    assert bool(torch.any((a.detections.delay[0][v] - 20).abs() < 1.0))
    assert halo_permute.error() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "c64"])
@pytest.mark.parametrize("name", ["default-targets", "default-overflow",
                                  "ragged", "wide"])
def test_row_block_mode_matches_plain_on_card(card, name, kind):
    """The kernel's row-block mode against detect_rows_plain and against
    its own map mode: the map cut in four row blocks (the last with
    phantom rows holding garbage), each with its halo rows from the map
    and zeros past its edges, one launch for the four; db and keep are the
    map mode's bits, the sums and maxima the map's rows'."""
    from blah2_tpu_torch.ops.detect import detect_rows_plain

    z, args = _cases()[name]
    fd = FusedDetector(*args, device=card)
    m = _input(torch.from_numpy(z).to(card), kind)
    nr, nc = m.shape
    g, t, wr, wc = fd.n_guard, fd.n_train, fd.win_rows, fd.win_cols
    n = 4
    r_len = -(-nr // n)
    padded = torch.cat([m.new_zeros((wr, nc)), m,
                        m.new_full((n * r_len - nr, nc), 7.0),
                        m.new_zeros((wr, nc))])
    blocks = [(padded[d * r_len:d * r_len + wr],
               padded[wr + d * r_len:wr + (d + 1) * r_len],
               padded[wr + (d + 1) * r_len:2 * wr + (d + 1) * r_len])
              for d in range(n)]
    first = [d * r_len for d in range(n)]
    kw = (fd._scale, fd._cell_ok, g, t, wr, wc)
    launches = tdetect.detect.launches
    got = tdetect.detect.rows(blocks, first, nr, *kw)
    torch.cuda.synchronize()
    assert tdetect.detect.launches == launches + 1
    want = detect_rows_plain(torch.stack([torch.cat(b) for b in blocks]),
                             first, nr, *kw)
    whole = tdetect.detect(m.contiguous(), *kw)
    assert torch.equal(got.keep, want.keep)
    assert torch.equal(got.keep.reshape(-1, nc)[:nr], whole.keep)
    assert torch.equal(got.db.reshape(-1, nc)[:nr], whole.db)
    assert bool(torch.isneginf(got.db.reshape(-1, nc)[nr:]).all())
    assert int(got.keep.sum()) >= 1
    torch.testing.assert_close(got.sums, want.sums, rtol=1e-6, atol=0)
    assert torch.equal(got.maxes, want.maxes)
    assert abs(float(got.sums.double().sum()) / (nr * nc)
               - float(whole.noise)) <= 1e-4
    again = tdetect.detect.rows(blocks, first, nr, *kw)
    assert torch.equal(again.sums, got.sums)


@pytest.mark.cuda
def test_row_block_mode_over_launch_capacity_on_card(card):
    """More row blocks than one launch takes (MAX_BLOCKS): the wrapper
    launches in turn, each launch's blocks as the plain twin gives them."""
    from blah2_tpu_torch.ops.detect import MAX_BLOCKS, detect_rows_plain

    z, args = _cases()["ragged"]
    fd = FusedDetector(*args, device=card)
    m = _input(torch.from_numpy(z).to(card), "c64")
    nr, nc = m.shape
    wr = fd.win_rows
    r_len = -(-nr // 3)
    padded = torch.cat([m.new_zeros((wr, nc)), m,
                        m.new_zeros((3 * r_len - nr + wr, nc))])
    one = [(padded[d * r_len:d * r_len + wr],
            padded[wr + d * r_len:wr + (d + 1) * r_len],
            padded[wr + (d + 1) * r_len:2 * wr + (d + 1) * r_len])
           for d in range(3)]
    copies = MAX_BLOCKS // 3 + 2
    blocks = one * copies
    first = [d * r_len for d in range(3)] * copies
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, wr, fd.win_cols)
    launches = tdetect.detect.launches
    got = tdetect.detect.rows(blocks, first, nr, *kw)
    torch.cuda.synchronize()
    assert len(blocks) > MAX_BLOCKS
    assert tdetect.detect.launches == launches + 2
    want = detect_rows_plain(torch.stack([torch.cat(b) for b in one]),
                             first[:3], nr, *kw)
    for k in range(copies):
        assert torch.equal(got.keep[3 * k:3 * k + 3], want.keep)
        assert torch.equal(got.maxes[3 * k:3 * k + 3], want.maxes)
    torch.testing.assert_close(got.sums, want.sums.repeat(copies),
                               rtol=1e-6, atol=0)
    # Each launch keeps its own counters: a second call reads the same.
    again = tdetect.detect.rows(blocks, first, nr, *kw)
    assert torch.equal(again.sums, got.sums)
    assert torch.equal(again.keep, got.keep)


@pytest.mark.cuda
def test_row_block_layouts_in_turn_on_card(card):
    """The wrapper keeps each checked layout with its pointer tables: two
    layouts in turn on one stream, and new tensors in a kept layout, give
    the plain twin's results (the pointers refilled, the scratch zeroed
    at each change of layout), and a part laid out otherwise is checked
    again and refused."""
    from blah2_tpu_torch.ops.detect import detect_rows_plain

    z, args = _cases()["ragged"]
    fd = FusedDetector(*args, device=card)
    nr, nc = z.shape
    wr = fd.win_rows
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, wr, fd.win_cols)

    def cut(m, n):
        r_len = -(-nr // n)
        padded = torch.cat([m.new_zeros((wr, nc)), m,
                            m.new_zeros((n * r_len - nr + wr, nc))])
        return ([(padded[d * r_len:d * r_len + wr].clone(),
                  padded[wr + d * r_len:wr + (d + 1) * r_len],
                  padded[wr + (d + 1) * r_len:2 * wr + (d + 1) * r_len]
                  .clone()) for d in range(n)],
                [d * r_len for d in range(n)])

    rng = np.random.default_rng(5)
    for k in range(3):
        m = _input(torch.from_numpy(
            z * (1.0 + 0.5 * k) + rng.standard_normal(z.shape)
            .astype(np.complex64)).to(card), "c64")
        for n in (4, 3):
            blocks, first = cut(m, n)
            got = tdetect.detect.rows(blocks, first, nr, *kw)
            want = detect_rows_plain(
                torch.stack([torch.cat(b) for b in blocks]), first, nr, *kw)
            assert torch.equal(got.keep, want.keep)
            assert torch.equal(got.maxes, want.maxes)
            torch.testing.assert_close(got.sums, want.sums, rtol=1e-6,
                                       atol=0)
    blocks, first = cut(m, 4)
    wide = torch.zeros((blocks[0][1].shape[0], 2 * nc), dtype=m.dtype,
                       device=card)
    wide[:, ::2] = blocks[0][1]
    blocks[0] = (blocks[0][0], wide[:, ::2], blocks[0][2])
    with pytest.raises(ValueError, match="contiguous rows"):
        tdetect.detect.rows(blocks, first, nr, *kw)


@pytest.mark.cuda
def test_current_stream_handle_is_the_current_stream(card):
    from blah2_tpu_torch.device import current_stream_handle

    assert current_stream_handle(card.index) == \
        torch.cuda.current_stream(card).cuda_stream
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        assert current_stream_handle(card.index) == side.cuda_stream


def _runtime_windows(n, count):
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi

    out = []
    for k in range(count):
        x, y = synthetic_cpi(n, 200_000, [TargetSpec(40, -77.0, 0.05),
                                          TargetSpec(85, 44.0, 0.03)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=30 + k)
        q = np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                      axis=1) * 300), -2047, 2047)
        out.append(((q[:, 0] + 1j * q[:, 1]).astype(np.complex64),
                    (q[:, 2] + 1j * q[:, 3]).astype(np.complex64)))
    return out


@pytest.mark.cuda
def test_pinned_chunked_ingest_equals_synchronous_ingest(card):
    """Chunks staged through the pinned ring on the copy stream give the
    same products bit for bit as the same chunks copied synchronously from
    pageable memory; six CPIs of 8 chunks a channel reuse every pinned
    buffer of the ring (depth 32) at least once."""
    import os

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "config-synthetic.yml"))
    cfg.capture.device_type = "RspDuo"  # int16 wire: packed-12 chunks
    payloads = {}
    for name in ("pinned", "sync"):
        rt = RadarRuntime(cfg, staged_sample_every=0, device=card)
        assert rt.ingest_chunks == 8 and rt._stager is not None
        if name == "sync":
            rt._stager = None  # chunks leave as host tensors
        seen = []
        orig = rt._emit

        def spy(product, payload, _seen=seen, _orig=orig, **kw):
            if product in ("map", "detection", "iqdata", "track"):
                _seen.append((product, payload))
            return _orig(product, payload, **kw)

        rt._emit = spy
        for k, (x, y) in enumerate(_runtime_windows(rt.n_samples, 6)):
            rt.buffer1.push(x)
            rt.buffer2.push(y)
            got = rt._extract_cpi_chunks(timeout=1.0)
            assert got is not None
            assert got[0][0].device.type == (
                "cuda" if name == "pinned" else "cpu")
            assert got[0][0].dtype == torch.uint8
            assert rt.process_one_cpi_chunks(*got,
                                             timestamp_ms=1000 + k) is None
        rt._flush_pending()
        if name == "pinned":
            assert rt._stager.copies == 6 * 16
        payloads[name] = seen
    assert len(payloads["pinned"]) == 6 * 4
    assert payloads["pinned"] == payloads["sync"]


@pytest.mark.cuda
def test_deferred_fetch_products_arrive_in_order_on_card(card):
    """A synthetic capture thread, 6 CPIs under deferred fetch on the card:
    6 product sets in timestamp order, fused CPIs one behind, the detect
    kernel launched once a CPI."""
    import json
    import os
    import threading

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "config-synthetic.yml"))
    rt = RadarRuntime(cfg, staged_sample_every=0, device=card)
    assert rt.defer_fetch and rt.pipeline.fused_detector is not None
    maps = []
    orig = rt._emit

    def spy(product, payload, **kw):
        if product == "map":
            maps.append((json.loads(payload)["timestamp"], rt.n_cpis_done))
        return orig(product, payload, **kw)

    rt._emit = spy
    rt.start_capture()
    launches = tdetect.detect.launches
    t = threading.Thread(target=rt.run, kwargs={"n_cpis": 6, "quiet": True},
                         daemon=True)
    t.start()
    t.join(120.0)
    rt.stop()
    assert not t.is_alive(), "the run did not end within 120 s"
    torch.cuda.synchronize(card)
    assert tdetect.detect.launches - launches == 6
    assert len(maps) == 6
    assert [s for s, _ in maps] == sorted(s for s, _ in maps)
    assert [done - j for j, (_, done) in enumerate(maps)] == [1] * 6


@pytest.mark.cuda
def test_stage_marks_time_the_replayed_cpi_on_card(card):
    """Six packed CPIs under deferred fetch on the card, five of them
    replays of the CUDA graph: the stage marks (event-record nodes inside
    the graph) time each of the four stages, and their sum lies inside the
    CPI's pair of events (``device``) with 5 % of room; ``wire_transfer``
    is the rest."""
    import os

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "config-synthetic.yml"))
    cfg.capture.device_type = "RspDuo"  # int16 wire: packed-12 chunks
    rt = RadarRuntime(cfg, staged_sample_every=0, device=card)
    docs = []
    orig = rt._emit

    def keep(product, payload, parsed=None):
        if product == "timing":
            docs.append(parsed)
        return orig(product, payload, parsed=parsed)

    rt._emit = keep
    for k, (x, y) in enumerate(_runtime_windows(rt.n_samples, 6)):
        rt.buffer1.push(x)
        rt.buffer2.push(y)
        got = rt._extract_cpi_chunks(timeout=1.0)
        assert rt.process_one_cpi_chunks(*got, timestamp_ms=10 + k) is None
    rt._flush_pending()
    (call,) = rt.pipeline.graphs.values()
    assert call.replays == 5 and len(docs) == 6
    for d in docs[1:]:
        stages = [d[k] for k in rt.DEVICE_STAGES]
        assert all(s > 0.0 for s in stages), stages
        assert 0.0 < sum(stages) <= 1.05 * d["device"], (stages, d)
        assert abs(d["wire_transfer"]
                   - max(0.0, d["device"] - sum(stages))) < 1e-3


@pytest.mark.cuda
def test_a_cpi_still_running_never_holds_the_next_dispatch(card):
    """Five packed CPIs under deferred fetch, the third held on the card
    behind a spin of about 200 ms: the fourth is dispatched while the
    third still runs (its dispatch span ends before the third's wait
    begins), the third's wait falls in its own ``fetch_wait``, its stage
    marks are lost and counted, and its ``device`` runs from its begin
    event, behind the spin, to its fetch's: its own work, under the spin's
    length, split by the second CPI's stage shares. The other CPIs' marks
    are read (the fifth is dispatched once the fourth has finished)."""
    import os

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "config-synthetic.yml"))
    cfg.capture.device_type = "RspDuo"
    rt = RadarRuntime(cfg, staged_sample_every=0, device=card)
    docs = []
    orig = rt._emit

    def keep(product, payload, parsed=None):
        if product == "timing":
            docs.append(parsed)
        return orig(product, payload, parsed=parsed)

    rt._emit = keep
    for k, (x, y) in enumerate(_runtime_windows(rt.n_samples, 5)):
        rt.buffer1.push(x)
        rt.buffer2.push(y)
        rt.n_cpis_done = k  # the CPI's index in its spans
        got = rt._extract_cpi_chunks(timeout=1.0)
        if k == 2:
            torch.cuda._sleep(400_000_000)  # ~200 ms at 1.98 GHz
        if k == 4:
            torch.cuda.synchronize(card)  # the fourth CPI has finished
        assert rt.process_one_cpi_chunks(*got, timestamp_ms=10 + k) is None
    rt._flush_pending()
    assert len(docs) == 5 and rt.marks_lost == 1
    logged = {(name, cpi): (t0, t1) for name, cpi, t0, t1 in rt.spans.spans()}
    assert logged["dispatch", 3][1] <= logged["fetch_wait", 2][0]
    assert docs[2]["fetch_wait"] > 50.0
    assert 0.0 < docs[2]["device"] < 50.0
    for k in rt.DEVICE_STAGES:  # split by the second CPI's shares
        assert docs[2][k] / docs[2]["device"] == pytest.approx(
            docs[1][k] / docs[1]["device"])
    for d in (docs[1], docs[3], docs[4]):
        assert d["fetch_wait"] < 50.0
        assert 0.0 < sum(d[k] for k in rt.DEVICE_STAGES) <= 1.05 * d["device"]


@pytest.mark.cuda
def test_paced_cpis_emit_in_the_next_fill_on_card(card):
    """Eight packed CPIs under deferred fetch on the card, each pushed
    50 ms after the runtime waits on dry rings (after the CPI before was
    dispatched), a capture slower than the card: every CPI is emitted in
    the next CPI's fill, its ``deferral`` under 5 ms (the first, with no
    ``device`` read before it, waited for at once in its ``fetch_wait``;
    the others once they have run as long as the CPI before), no stage
    marks are lost, and the products are the bits of a synchronous run of
    the same windows and timestamps."""
    import os
    import threading
    import time

    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "config-synthetic.yml"))
    cfg.capture.device_type = "RspDuo"  # int16 wire: packed-12 chunks
    rt = RadarRuntime(cfg, staged_sample_every=0, device=card)
    windows = _runtime_windows(rt.n_samples, 8)
    docs, cpis, cur = [], [], {}
    orig = rt._emit

    def keep(product, payload, parsed=None):
        nonlocal cur
        if product == "timing":
            docs.append(parsed)
        elif product == "timestamp":
            cpis.append((int(payload), cur))
            cur = {}
        else:
            cur[product] = payload
        return orig(product, payload, parsed=parsed)

    rt._emit = keep
    asked = [-1]  # CPIs done when the runtime last waited on a short ring
    wait_for = rt.buffer1.wait_for

    def paced_wait(n, timeout=None):
        if len(rt.buffer1) < n:
            asked[0] = rt.n_cpis_done
        return wait_for(n, timeout=timeout)

    rt.buffer1.wait_for = paced_wait

    def push():
        end = time.monotonic() + 60.0
        for k, (x, y) in enumerate(windows):
            while asked[0] < k:
                if time.monotonic() > end:
                    return
                time.sleep(0.001)
            time.sleep(0.05)
            rt.buffer1.push(x)
            rt.buffer2.push(y)

    pusher = threading.Thread(target=push, daemon=True)
    pusher.start()
    t = threading.Thread(target=rt.run, kwargs={"n_cpis": 8, "quiet": True},
                         daemon=True)
    t.start()
    t.join(120.0)
    rt.stop()
    pusher.join(10.0)
    assert not t.is_alive(), "the run did not end within 120 s"
    assert len(docs) == len(cpis) == 8
    assert (rt.flushed_in_fill, rt.flushed_behind, rt.marks_lost) == \
        (7, 0, 0)
    assert all(d["deferral"] < 5.0 for d in docs), \
        [d["deferral"] for d in docs]
    sync = RadarRuntime(cfg, staged_sample_every=0, defer_fetch=False,
                        device=card)
    for (x, y), (stamp, got) in zip(windows, cpis):
        sync.buffer1.push(x)
        sync.buffer2.push(y)
        assert got == sync.process_one_cpi_chunks(
            *sync._extract_cpi_chunks(timeout=1.0), timestamp_ms=stamp)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3])
def test_pinned_stager_never_refills_a_buffer_in_flight(card, depth):
    """200 distinct chunks through a ring of 1 or 3 pinned buffers, with
    no wait between puts: every copy lands as its own chunk (a buffer
    refilled before its copy had finished would hand the card a later
    chunk's bytes)."""
    from blah2_tpu_torch.runtime.staging import PinnedStager

    stager = PinnedStager(card, depth)
    rng = np.random.default_rng(4)
    chunks = [rng.integers(0, 256, 3 * 2**18, dtype=np.uint8)
              for _ in range(200)]
    on_card = [stager.put(c) for c in chunks]
    stager.ready_on()
    torch.cuda.synchronize(card)
    assert stager.copies == 200 and stager.bytes == sum(c.nbytes
                                                         for c in chunks)
    assert len(stager._rings) == 1
    for c, d in zip(chunks, on_card):
        assert d.device == card
        assert np.array_equal(d.cpu().numpy(), c)


@pytest.mark.cuda
def test_cli_on_the_card_with_async_warmup(card):
    """The CLI in a fresh process on the card, the staged warm-up on its
    own thread (the default) while the CPI loop runs: the two threads'
    first linear-algebra calls must not race (the runtime makes the first
    one in its constructor)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run(
        [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", "--config",
         os.path.join(repo, "config", "config-synthetic.yml"), "--cpis",
         "12", "--no-api", "--staged-sample-every", "4"], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("CPI time (ms)") == 12


# -- the alternative algorithms on the card --------------------------------------

# The scene of the verify recipe with each alternative.
_VERIFY = {
    "capture": {"fs": 200_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.1},
        "ambiguity": {"delayMin": -10, "delayMax": 100, "dopplerMin": -200,
                      "dopplerMax": 200},
        "clutter": {"enable": True, "delayMin": -10, "delayMax": 100},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2, "nTrain": 6,
                      "minDelay": 5, "minDoppler": 15, "nCentroid": 6},
    },
}
_ALTERNATIVES = {"eca-b": ("clutter", {"filter": "eca-b", "nBatches": 4}),
                 "nlms": ("clutter", {"filter": "nlms", "mu": 0.1}),
                 "os": ("detection", {"cfar": "os"})}


def _alternative_config(name):
    import copy

    from blah2_tpu_torch.config import config_from_dict

    d = copy.deepcopy(_VERIFY)
    stage, kv = _ALTERNATIVES[name]
    d["process"][stage].update(kv)
    return config_from_dict(d)


def _det_cells(det):
    v = det.valid.cpu()
    return set(zip(det.row.cpu()[v].tolist(), det.col.cpu()[v].tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_ALTERNATIVES))
def test_alternative_on_card_matches_cpu(card, name):
    """complex128 on the card against the CPU: the map within 1e-6 dB and
    the same detections; at complex64 on the card the detect kernel runs
    once a CPI under CA-CFAR and never under OS-CFAR."""
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    cfg = _alternative_config(name)
    x, y = synthetic_cpi(20_000, 200_000, [TargetSpec(40, -77.0, 0.05),
                                           TargetSpec(61, 112.0, 0.03)],
                         clutter_amplitude=3.0, noise_amplitude=1e-3, seed=7)
    outs = [CpiPipeline(cfg, dtype=torch.complex128, fused_detect=False,
                        device=dev)(x, y) for dev in (card, "cpu")]
    a, b = outs
    assert float((a.db_map.cpu() - b.db_map).abs().max()) <= 1e-6
    assert bool(a.clutter_ok) and bool(b.clutter_ok)
    assert _det_cells(a.detections) == _det_cells(b.detections)
    assert len(_det_cells(b.detections)) >= 1
    pipe = CpiPipeline(cfg, device=card)
    assert (pipe.fused_detector is None) == (name == "os")
    launches = tdetect.detect.launches
    pipe(x, y)
    torch.cuda.synchronize()
    assert tdetect.detect.launches - launches == (0 if name == "os" else 1)


@pytest.mark.cuda
def test_sharded_nlms_batched_scan_equals_ranks_in_turn(card):
    """On one card the 1 × 4 mesh's NLMS chains run as one scan over a
    leading rank dimension; the ranks run in turn give the same products."""
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    cfg = config_from_dict({
        "capture": {"fs": 80_000, "fc": 204_640_000},
        "process": {
            "data": {"cpi": 0.2},
            "ambiguity": {"delayMin": -5, "delayMax": 60,
                          "dopplerMin": -100, "dopplerMax": 100},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 30,
                        "filter": "nlms"},
            "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                          "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                          "nCentroid": 6}}})
    x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                         [TargetSpec(20, -44.0, 0.1)],
                         clutter_amplitude=2.0, noise_amplitude=1e-3, seed=0)
    sp = ShardedCpiPipeline(cfg, make_radar_mesh(1, 4, devices=[card] * 4),
                            dtype=torch.complex128, halo_backend="pallas")
    planes = sp.shard_inputs(x, y)
    a = sp(*planes)
    sp.nlms_batch_ranks = False
    b = sp(*planes)
    assert float((a.db_map - b.db_map).abs().max()) <= 1e-9
    assert _det_cells(a.detections) == _det_cells(b.detections)


@pytest.mark.cuda
def test_cli_mesh_on_one_card(card):
    """``--mesh 1x4`` puts four ranks on the one card, the halo kernel
    between them."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run(
        [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", "--config",
         os.path.join(repo, "config", "config-synthetic.yml"), "--cpis",
         "4", "--no-api", "--mesh", "1x4", "--halo-backend", "pallas"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("(batch of 1") == 4


def _two_card_workers(case, tmp_path):
    """tests/test_torch_multiprocess.py's ``case`` on two processes, one
    card each (NCCL); every process's report, in process order."""
    import json
    import os

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from test_torch_multiprocess import run_workers

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_torch_multiprocess.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0,1")
    run_workers(script, ["--case", case, "--out", str(tmp_path)], 2, 300,
                env=env)
    with open(tmp_path / f"{case}.json") as f:
        return json.load(f)


@pytest.mark.cuda
def test_halo_kernel_across_processes_on_two_cards(card, tmp_path):
    """Two processes on a card each: the halo kernel writes the peer
    process's receive buffers through CUDA IPC and equals
    halo_permute_plain (whose crossing pairs go by NCCL), on 1 x 2 and
    1 x 4 meshes, circular and masked, f32/c64/c128 strided slices, 50
    back-to-back calls; one launch a call in each process; per call the
    pairs by route."""
    every = _two_card_workers("halo", tmp_path)
    assert [e["backend"] for e in every] == ["nccl", "nccl"]
    assert [e["cards"] for e in every] == [[0], [1]]
    assert all(e["differing"] == 0 and e["cases"] > 0 for e in every)
    # Pairs whose receiver is in each process, summed over both.
    want = {(2, False): {"kernel": 0, "ipc": 2}, (2, True): {"kernel": 0,
                                                             "ipc": 1},
            (4, False): {"kernel": 2, "ipc": 2}, (4, True): {"kernel": 2,
                                                             "ipc": 1}}
    for i, case in enumerate(every[0]["routes"]):
        calls = 50 if case["dtype"] == "torch.complex64" else 1
        width, mask = case["mesh"][1], case["mask"]
        total = {k: sum(e["routes"][i]["pairs"][k] for e in every)
                 for k in ("kernel", "ipc", "group")}
        assert total == {**{k: v * calls for k, v in
                            want[width, mask].items()}, "group": 0}, case
        assert [e["routes"][i]["launches"] for e in every] == \
            [calls, calls], case


@pytest.mark.cuda
def test_sharded_step_across_processes_on_two_cards(card, tmp_path):
    """The sharded step on a 1 x 2 mesh over two processes (NCCL; the halo
    kernel through IPC, or NCCL's send/recv) gives the one-process step's
    products on the same two cards."""
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    every = _two_card_workers("step", tmp_path)
    from test_torch_multiprocess import BACKENDS, card_scene, products

    assert [e["backend"] for e in every] == ["nccl", "nccl"]
    assert [e["launches"] for e in every] == \
        [{"ppermute": 0, "pallas": 6}] * 2
    got = np.load(tmp_path / "step.npz")
    cfg, x, y = card_scene()
    mesh = make_radar_mesh(1, 2, devices=[torch.device("cuda", 0),
                                          torch.device("cuda", 1)])
    for backend in BACKENDS:
        sp = ShardedCpiPipeline(cfg, mesh, halo_backend=backend,
                                use_fused_detect=True)
        want = products(sp(*sp.shard_inputs(x, y)))
        for k, v in want.items():
            np.testing.assert_array_equal(got[f"{backend}/{k}"], v,
                                          err_msg=f"{backend} {k}")


@pytest.mark.cuda
def test_dryrun_across_processes_with_two_cards_each(card):
    """``python -m blah2_tpu_torch.entry dryrun2proc 2`` on four cards: two
    processes with two cards each (NCCL, the payloads of a process's second
    card staged through its first); process 0's maps on the 2 x 2 and 1 x 4
    meshes are the bits of one process on the same four cards."""
    from blah2_tpu_torch import entry

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    assert entry.dryrun_multihost(2, 2, seconds=240) == \
        {"2x2": 0.0, "1x4": 0.0}


def _graph_config(name):
    import copy

    from blah2_tpu_torch.config import config_from_dict

    if name in _ALTERNATIVES:
        return _alternative_config(name)
    d = copy.deepcopy(_VERIFY)
    if name == "nsub2":
        d["process"]["spectrum"] = {"nSub": 2}
    return config_from_dict(d)


def _scratch(call, rows=False, device=None):
    """The detect kernel's scratch on a StaticCall's capture stream of
    ``device`` (the home card by default; its row-block mode's, with
    ``rows``): what the graph's launches there use."""
    index = (device or call.device).index
    return tdetect.detect.scratch(index, call.streams[index].cuda_stream,
                                  rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "nsub2", *sorted(_ALTERNATIVES)])
def test_graph_replays_give_the_eager_bits_on_card(card, name):
    """``call_quad12`` and ``call_chunks`` captured at their first call
    (one graph each) and replayed on two different CPIs: each product the
    eager pipeline's bits, an earlier product unchanged by a later replay,
    the detect kernel counted once a replay (never under OS-CFAR) and its
    ticket counter zero after each."""
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops.pack12 import pack12_planes, pack12_quads

    cfg = _graph_config(name)
    cpis = []
    for seed in (7, 8):
        x, y = synthetic_cpi(20_000, 200_000, [TargetSpec(40, -77.0, 0.05)],
                             clutter_amplitude=3.0, noise_amplitude=1e-3,
                             seed=seed)
        q = np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                      axis=1) * 150), -2048, 2047
                    ).astype(np.int16)
        split = np.split(np.arange(q.shape[0]), 4)
        cpis.append((torch.from_numpy(pack12_quads(q)).to(card),
                     [torch.from_numpy(pack12_planes(q[i, :2])).to(card)
                      for i in split],
                     [torch.from_numpy(pack12_planes(q[i, 2:])).to(card)
                      for i in split]))
    eager = CpiPipeline(cfg, graph=False, device=card)
    pipe = CpiPipeline(cfg, device=card)
    assert pipe.graph
    per_replay = 0 if name == "os" else 1

    def equal(a, b):
        for u, v in zip(a, b):
            if isinstance(u, tuple):
                assert equal(u, v)
            elif u is None:
                assert v is None
            else:
                if u.is_complex():
                    u, v = torch.view_as_real(u), torch.view_as_real(v)
                assert torch.equal(u, v)
        return True

    for entry in ("quad12", "chunks"):
        def run(p, cpi):
            return p.call_quad12(cpi[0]) if entry == "quad12" \
                else p.call_chunks(cpi[1], cpi[2])

        assert equal(run(pipe, cpis[0]), run(eager, cpis[0]))  # capture
        launches = tdetect.detect.launches
        outs = [run(pipe, cpi) for cpi in (cpis[1], cpis[0])]
        torch.cuda.synchronize()
        assert tdetect.detect.launches - launches == 2 * per_replay
        assert equal(outs[0], run(eager, cpis[1]))
        assert equal(outs[1], run(eager, cpis[0]))
        assert not torch.equal(outs[0].db_map, outs[1].db_map)
    assert len(pipe.graphs) == 2
    for call in pipe.graphs.values():
        assert call.counts == ({"detect": 1} if per_replay else {})
        if per_replay:
            assert int(_scratch(call)[:1].abs().sum()) == 0


@pytest.mark.cuda
def test_detect_over_48kb_replays_in_a_graph(card):
    """The "wide" case (more than 48 KB of shared memory a block) through a
    StaticCall: its eager warm-up sets the kernel's shared-memory attribute,
    the capture holds one launch, and each replay on two maps gives the
    eager launch's bits with the ticket counter back at zero."""
    from blah2_tpu_torch.dsp.graph import StaticCall

    z, args = _cases()["wide"]
    fd = FusedDetector(*args, device=card)
    zc = torch.from_numpy(z).to(card)
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
          fd.win_cols)
    call = StaticCall(lambda m: tdetect.detect(m, *kw), [zc], card,
                      name="wide")
    call.capture(zc)
    assert call.counts == {"detect": 1}
    for m in (zc, zc * 1.5):
        launches = tdetect.detect.launches
        got = call(m)
        want = tdetect.detect(m.contiguous(), *kw)
        torch.cuda.synchronize()
        assert tdetect.detect.launches == launches + 2
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got.keep.sum()) >= 1
        assert int(_scratch(call)[:1].abs().sum()) == 0


#: The sharded path's algorithms on the card: (config changes, pipeline
#: settings), at the scene of tests/test_torch_sharded.py.
_SHARDED_GRAPH = {
    "wiener-fused": ({}, {"use_fused_detect": True}),
    "wiener-replicated": ({}, {"row_shard": False}),
    "eca-b": ({"clutter": {"filter": "eca-b"}}, {"use_fused_detect": True}),
    "nlms": ({"clutter": {"filter": "nlms"}}, {"use_fused_detect": True}),
    "nlms-ranks-in-turn": ({"clutter": {"filter": "nlms"}},
                           {"use_fused_detect": True,
                            "nlms_batch_ranks": False}),
    "nsub4": ({"spectrum": {"nSub": 4}}, {"use_fused_detect": True}),
    "os": ({"detection": {"cfar": "os"}}, {}),
}


def _sharded_graph_scene(name, shape):
    """The config and three different batches of the sharded graph tests
    (planes made by the pipeline ``shard_inputs`` is given)."""
    import copy

    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.config import config_from_dict

    d = {"capture": {"fs": 80_000, "fc": 204_640_000},
         "process": {
             "data": {"cpi": 0.2},
             "ambiguity": {"delayMin": -5, "delayMax": 60,
                           "dopplerMin": -100, "dopplerMax": 100},
             "clutter": {"enable": True, "delayMin": -5, "delayMax": 30},
             "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                           "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                           "nCentroid": 6}}}
    changes, _ = _SHARDED_GRAPH[name]
    d = copy.deepcopy(d)
    for stage, kv in changes.items():
        d["process"].setdefault(stage, {}).update(kv)
    cfg = config_from_dict(d)
    batches = []
    for seed in (7, 8, 9):
        xs, ys = [], []
        for k in range(shape[0]):
            x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                                 [TargetSpec(20, -44.0, 0.1)],
                                 clutter_amplitude=2.0,
                                 noise_amplitude=1e-3, seed=seed + 10 * k)
            xs.append(x)
            ys.append(y)
        batches.append((np.stack(xs), np.stack(ys)))
    return cfg, batches


def _equal_products(a, b):
    for u, v in zip(a, b, strict=True):
        if isinstance(u, tuple):
            _equal_products(u, v)
        elif u is None or v is None:
            assert u is None and v is None
        else:
            if u.is_complex():
                u, v = torch.view_as_real(u), torch.view_as_real(v)
            assert u.dtype == v.dtype and torch.equal(u, v)


def _sharded_graph_case(devices, name, shape, more_replays=0, churn=False):
    """The sharded step on ``devices`` (one a rank) captured at its first
    call and replayed on three different batches: each product the eager
    step's bits, an earlier product unchanged by a later replay, the halo
    kernel's launches and the detect kernel's counted once a replay, the
    row-block mode's ticket counters zero after each on every card, no
    output of the graph in its input buffers. ``more_replays`` replays
    more, each the eager bits, then the halo kernel's error word 0 and its
    semaphores all consumed; with ``churn``, between replays another
    workload allocates and fills memory on every card and keeps it, and
    the replays leave it as it was. Returns the graph's StaticCall."""
    from blah2_tpu_torch.dsp import graph as graph_mod
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    cfg, scene = _sharded_graph_scene(name, shape)
    kw = dict(_SHARDED_GRAPH[name][1])
    batch_ranks = kw.pop("nlms_batch_ranks", True)
    mesh = make_radar_mesh(*shape, devices=devices)
    cards = mesh.distinct_devices()
    pipes = {}
    for graph in (False, "auto"):
        sp = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas", graph=graph,
                                **kw)
        sp.nlms_batch_ranks = batch_ranks
        pipes[graph] = sp
    eager, pipe = pipes[False], pipes["auto"]
    assert pipe.graph and not eager.graph, pipe.graph_reason
    assert all(str(d) in pipe.graph_reason for d in cards)
    batches = [pipe.shard_inputs(x, y) for x, y in scene]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    want = []
    for planes in batches:
        before = graph_mod.counts()
        want.append(eager(*planes))
        sync()
        step = {k: v - before[k] for k, v in graph_mod.counts().items()}
    _equal_products(pipe(*batches[0]), want[0])  # the capture's warm-up
    (call,) = pipe.graphs.values()
    assert call.cards == cards
    assert call.counts == {k: v for k, v in step.items() if v}
    fused = pipe.fused_detector is not None and pipe._row_shard
    # The clutter filter's shifts (three for ECA-B and NLMS), the fused
    # detector's two row halos: one launch a card each.
    shifts = 3 if name.startswith(("eca-b", "nlms")) else 4
    assert step["halo"] == (shifts + 2 * fused) * len(cards)
    assert (step["detect"], step["detect_rows"]) == \
        (fused * len(cards), fused * len(cards))
    inputs = [(b.data_ptr(), b.data_ptr() + b.numel() * b.element_size())
              for b in call.inputs if b is not None]
    for t in _leaves_of(call.outputs):
        lo = t.data_ptr()
        assert all(lo >= hi or lo + t.numel() * t.element_size() <= a
                   for a, hi in inputs)
    blocks = {d: sum(1 for r in mesh.local_ranks if mesh.devices[r] == d)
              * (shape[0] // mesh.shape["cpi"]) for d in cards}
    kept_fill = []
    outs = []
    before = graph_mod.counts()
    order = [1, 2, 0] + [k % 3 for k in range(more_replays)]
    for j, k in enumerate(order):
        outs.append(pipe(*batches[k]))
        if churn:
            # Another workload on every card: memory taken and kept.
            kept_fill.append([torch.full((1 << 22,), float(j), device=d)
                              for d in cards])
        if fused and j < 3:
            sync()
            for d in cards:
                assert int(_scratch(call, rows=True, device=d)[:blocks[d]]
                           .abs().sum()) == 0
        if len(outs) == 1:
            kept = [t.clone() for t in _leaves_of(outs[0])]
        if j >= 3:
            _equal_products(outs[-1], want[k])
            outs[-1] = None
    sync()
    assert {k: v - before[k] for k, v in graph_mod.counts().items()} == \
        {k: len(order) * v for k, v in step.items()}
    for out, k in zip(outs[:3], (1, 2, 0)):
        _equal_products(out, want[k])
    for a, b in zip(_leaves_of(outs[0]), kept):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0].db_map, outs[1].db_map)
    for j, fills in enumerate(kept_fill):
        for t in fills:
            assert bool((t == float(j)).all()), "a replay wrote memory " \
                "that another workload took after the capture"
    assert halo_permute.error() == 0
    for w in halo_permute.flag_words(mesh):
        assert not bool(w.any())
    assert call.replays == len(order)
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("name", sorted(_SHARDED_GRAPH))
def test_sharded_graph_replays_give_the_eager_bits_on_card(card, name,
                                                           shape):
    """The sharded step captured at its first call on logical ranks of one
    card and replayed on three different batches: each product the eager
    step's bits, an earlier product unchanged by a later replay, the halo
    kernel's launches and the detect kernel's counted once a replay, the
    row-block mode's ticket counters zero after each, no output of the
    graph in its input buffers."""
    _sharded_graph_case([card] * 4, name, shape)


def _cards_or_skip(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, {torch.cuda.device_count()} "
                    f"visible")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cards", [2, 4], ids=["2cards", "4cards"])
@pytest.mark.parametrize("name", ["wiener-fused", "eca-b", "nlms", "os"])
def test_sharded_graph_over_cards_gives_the_eager_bits(card, name, n_cards):
    """The 1 × 4 step over two or four cards of one process captured as one
    graph (one capture stream a card, the halo kernel's flagged launches
    inside it) and replayed: three batches give the eager step's bits, a
    later replay leaves an earlier product unchanged, one halo launch a
    card and shift (6 a card in a fused step); the Wiener step then 50
    replays more, error word 0 and every semaphore consumed, with another
    workload allocating on every card between replays."""
    cards = _cards_or_skip(n_cards)
    devices = [cards[r * n_cards // 4] for r in range(4)]
    more = 50 if name == "wiener-fused" else 0
    call = _sharded_graph_case(devices, name, (1, 4), more_replays=more,
                               churn=name == "wiener-fused")
    if name == "wiener-fused":
        assert call.counts["halo"] == 6 * n_cards


@pytest.mark.cuda
def test_calibrate_row_shard_replays_over_cards(card):
    """calibrate_row_shard on a 1 × 4 mesh over four cards: both layouts
    captured (one graph each) and the trials replayed, with no code of its
    own; the winner replays on."""
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import calibrate_row_shard

    cards = _cards_or_skip(4)
    cfg, scene = _sharded_graph_scene("wiener-fused", (1, 4))
    cal = calibrate_row_shard(cfg, make_radar_mesh(1, 4, devices=cards),
                              n_trials=2, halo_backend="pallas",
                              use_fused_detect=True)
    pipe = cal["pipeline"]
    (call,) = pipe.graphs.values()
    assert pipe.graph and call.cards == cards and call.replays == 2
    planes = pipe.shard_inputs(*scene[0])
    out = pipe(*planes)
    assert call.replays == 3 and bool(torch.isfinite(out.db_map).all())


def _leaves_of(tree):
    """The tensors of a (nested) NamedTuple of tensors and Nones."""
    out = []
    for v in tree:
        if isinstance(v, tuple):
            out.extend(_leaves_of(v))
        elif v is not None:
            out.append(v)
    return out


def _mesh_runtime_case(devices):
    """The mesh runtime on 1 × 4 ranks of ``devices`` replays the sharded
    step by default, from its second batch on, and emits the eager loop's
    products bit for bit."""
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    cfg = config_from_dict({
        "capture": {"fs": 40_000, "fc": 100_000_000, "type": "Synthetic"},
        "process": {
            "data": {"cpi": 0.1, "buffer": 8},
            "ambiguity": {"delayMin": -5, "delayMax": 40,
                          "dopplerMin": -50, "dopplerMax": 50},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 40},
            "detection": {"enable": True, "pfa": 1e-4, "nGuard": 1,
                          "nTrain": 4, "minDelay": 3, "minDoppler": 10,
                          "nCentroid": 4}}})
    windows = []
    for k in range(5):
        x, y = synthetic_cpi(cfg.n_samples, 40_000,
                             [TargetSpec(12, 30.0, 0.3)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=30 + k)
        windows.append((x.astype(np.complex64), y.astype(np.complex64)))
    runs = {}
    for graph in ("auto", False):
        rt = RadarRuntime(cfg, mesh=make_radar_mesh(1, 4, devices=devices),
                          halo_backend="pallas", graph=graph)
        assert rt.sharded.graph is (graph == "auto")
        outs = []
        emit = rt._emit_products

        def keep(out, t0, _outs=outs, _emit=emit, **kw):
            _outs.append(out)
            return _emit(out, t0, **kw)

        rt._emit_products = keep
        for x, y in windows:
            rt.buffer1.push(x)
            rt.buffer2.push(y)
        rt.run(n_cpis=len(windows), quiet=True)
        runs[graph] = (outs, rt)
    outs, rt = runs["auto"]
    (call,) = rt.sharded.graphs.values()
    assert call.replays == len(windows) - 1
    assert len(outs) == len(runs[False][0]) == len(windows)
    for a, b in zip(outs, runs[False][0]):
        for u, v in zip(_leaves_of(a), _leaves_of(b), strict=True):
            assert np.array_equal(u, v)


@pytest.mark.cuda
def test_mesh_runtime_replays_the_step_on_card(card):
    """The mesh runtime on 1 × 4 ranks of the card replays the sharded
    step by default, from its second batch on, and emits the eager loop's
    products bit for bit."""
    _mesh_runtime_case([card] * 4)


@pytest.mark.cuda
def test_mesh_runtime_replays_the_step_over_four_cards(card):
    """The mesh runtime on 1 × 4 ranks, one a card, replays the step over
    the four cards from its second batch on with no code of its own, and
    emits the eager loop's products bit for bit."""
    _mesh_runtime_case(_cards_or_skip(4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
def test_halo_flags_on_one_card_replay_in_a_graph(card, shape):
    """The one-card plan that takes the flag protocol (one launch whose
    blocks wait on one another), masked to the left and circular to the
    right on strided complex64 slices, captured in a CUDA graph and
    replayed 100 times on new payloads: each replay the bits of
    halo_permute_plain, error word 0, every semaphore consumed."""
    from blah2_tpu_torch.ops.halo import HaloKernel, halo_permute_plain
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    kernel = HaloKernel(flags_on_one_card=True)
    n = shape[0] * shape[1]
    mesh = make_radar_mesh(*shape, devices=[card] * n)
    gen = torch.Generator(device=card).manual_seed(3)
    blocks = [torch.empty((2, 1000), dtype=torch.complex64, device=card)
              for _ in range(n)]

    def parts():
        return [b[..., :409] for b in blocks], [b[..., -409:] for b in blocks]

    def body():
        left, right = parts()
        return (kernel(left, mesh, to_left=True, collective_id=1,
                       mask_edge=True)
                + kernel(right, mesh, to_left=False, collective_id=2))

    def want():
        left, right = parts()
        return (halo_permute_plain(left, mesh, to_left=True, mask_edge=True)
                + halo_permute_plain(right, mesh, to_left=False))

    for b in blocks:
        b.copy_(torch.randn(b.shape, dtype=b.dtype, device=card,
                            generator=gen))
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        body()  # the plans and their windows, outside the capture
    torch.cuda.current_stream(card).wait_stream(side)
    launches = kernel.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = body()
    assert kernel.launches - launches == 2  # one a call: one card
    for _ in range(100):
        for b in blocks:
            b.copy_(torch.randn(b.shape, dtype=b.dtype, device=card,
                                generator=gen))
        graph.replay()
        for g, w in zip(outs, want()):
            assert torch.equal(torch.view_as_real(g), torch.view_as_real(w))
    torch.cuda.synchronize(card)
    assert kernel.error() == 0
    words = kernel.flag_words(mesh)
    assert len(words) == 2 and all(not bool(w.any()) for w in words)
