"""The fused detector of the port: its plain version and ``FusedDetector``
against the JAX ``FusedDetector`` running its Pallas kernel in interpret
mode, on the geometries of tests/test_pallas_detect.py. The CUDA kernel
against its plain version is in tests/test_torch_cuda.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.ops.pallas_detect import FusedDetector as JaxFused
from blah2_tpu_torch.dsp.cfar import cfar_threshold_scale
from blah2_tpu_torch.ops import detect as tdetect
from blah2_tpu_torch.ops.detect import FusedDetector, detect_plain

torch.set_num_threads(1)


def _axes(nr, nc, delay_min=-10, doppler_step=2.0):
    delay_axis = np.arange(delay_min, delay_min + nc, dtype=np.int32)
    half = nr // 2
    doppler_axis = doppler_step * np.arange(-half, nr - half, dtype=np.float64)
    return delay_axis, doppler_axis


def _mk_map(nr, nc, seed=0, targets=()):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((nr, nc)) + 1j * rng.standard_normal((nr, nc)))
    for (r, c, amp) in targets:
        z[r, c] += amp
    return z.astype(np.complex64)


CASES = [
    # (nr, nc, pfa, guard, train, min_delay, min_doppler, n_centroid, cpi_cfg)
    (31, 53, 1e-3, 2, 6, 5, 6.0, 6, 0.5),
    (16, 40, 1e-2, 1, 3, 0, 0.0, 3, 0.25),
    (9, 130, 1e-4, 0, 4, 2, 4.0, 1, 1.0),
    (64, 64, 1e-3, 3, 5, 5, 2.0, 4, 0.125),
]


def _case_map(case):
    nr, nc = case[:2]
    targets = [(nr // 2 + 2, nc // 2, 30.0), (nr // 2 + 2, nc // 2 + 1, 18.0),
               (3, 7, 25.0), (nr - 2, nc - 3, 22.0)]
    targets = [(r, c, a) for (r, c, a) in targets if r < nr and c < nc]
    return _mk_map(nr, nc, seed=nr * nc, targets=targets)


def _both(case, max_detections=128):
    nr, nc, pfa, g, t, min_delay, min_doppler, n_cent, cpi = case
    delay_axis, doppler_axis = _axes(nr, nc)
    args = (pfa, g, t, min_delay, min_doppler, n_cent, n_cent, 1.0 / cpi,
            delay_axis, doppler_axis)
    port = FusedDetector(*args, max_detections=max_detections, device="cpu")
    ref = JaxFused(*args, max_detections=max_detections, interpret=True)
    return port, ref


@pytest.mark.parametrize("case", CASES, ids=[str(c[:2]) for c in CASES])
def test_fused_detector_matches_jax_pallas(case):
    z = _case_map(case)
    port, ref = _both(case)
    assert (port.win_rows, port.win_cols) == (ref.win_rows, ref.win_cols)
    np.testing.assert_array_equal(port._scale.numpy(), ref._scale)
    np.testing.assert_array_equal(port._cell_ok.numpy(), ref._cell_ok)

    launches = tdetect.detect.launches
    db, noise, maxp, det = port(torch.from_numpy(z))
    assert tdetect.detect.launches == launches  # CPU: the plain version
    jdb, jnoise, jmaxp, jdet = ref(jnp.asarray(z))

    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=0, atol=2e-4)
    assert abs(float(noise) - float(jnoise)) <= 1e-4
    assert abs(float(maxp) - float(jmaxp)) <= 1e-4
    assert int(det.count) == int(jdet.count)
    kv, jv = det.valid.numpy(), np.asarray(jdet.valid)
    np.testing.assert_array_equal(kv, jv)
    np.testing.assert_array_equal(det.row.numpy()[kv], np.asarray(jdet.row)[jv])
    np.testing.assert_array_equal(det.col.numpy()[kv], np.asarray(jdet.col)[jv])
    np.testing.assert_allclose(det.snr.numpy()[kv], np.asarray(jdet.snr)[jv],
                               atol=2e-3)
    np.testing.assert_array_equal(det.delay.numpy()[kv],
                                  np.asarray(jdet.delay)[jv])
    np.testing.assert_allclose(det.doppler.numpy()[kv],
                               np.asarray(jdet.doppler)[jv], atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:2]) for c in CASES])
def test_detect_plain_matches_jax_kernel_outputs(case):
    """The plain version against the Pallas kernel's own four outputs."""
    z = _case_map(case)
    port, ref = _both(case)
    pwr = (z.real.astype(np.float32) ** 2 + z.imag.astype(np.float32) ** 2)
    db, keep, noise, rawmax = detect_plain(
        torch.from_numpy(pwr), port._scale, port._cell_ok, port.n_guard,
        port.n_train, port.win_rows, port.win_cols)
    jdb, jkeep, jnoise, jrawmax = ref._call(
        jnp.asarray(pwr), jnp.asarray(ref._scale), jnp.asarray(ref._cell_ok))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=2e-4)
    assert abs(float(noise) - float(jnoise[0, 0])) <= 1e-4
    assert abs(float(rawmax) - float(jrawmax[0, 0])) <= 1e-4


def _tie_map():
    z = np.full((16, 40), 0.05 + 0j, dtype=np.complex64)
    z[8, 20] = 50.0
    z[8, 25] = 50.0
    return z


def test_fused_tie_both_kept():
    """Two equal-power hits inside each other's centroid window but beyond
    CFAR train reach: the strict-inequality centroid keeps both."""
    delay_axis, doppler_axis = _axes(16, 40)
    args = (1e-2, 1, 3, 0, 0.0, 6, 6, 2.0, delay_axis, doppler_axis)
    _, _, _, det = FusedDetector(*args, device="cpu")(torch.from_numpy(
        _tie_map()))
    _, _, _, jdet = JaxFused(*args, interpret=True)(jnp.asarray(_tie_map()))
    keep = det.valid.numpy()
    assert sorted(det.col.numpy()[keep].tolist()) == [20, 25]
    jkeep = np.asarray(jdet.valid)
    assert sorted(np.asarray(jdet.col)[jkeep].tolist()) == [20, 25]


def test_capacity_overflow_count():
    """More hits than capacity: the first K in row-major order, count > K."""
    case = CASES[1]
    z = _case_map(case)
    port, ref = _both(case, max_detections=2)
    _, _, _, det = port(torch.from_numpy(z))
    _, _, _, jdet = ref(jnp.asarray(z))
    assert int(det.count) == int(jdet.count) > 2
    np.testing.assert_array_equal(det.row.numpy(), np.asarray(jdet.row))
    np.testing.assert_array_equal(det.col.numpy(), np.asarray(jdet.col))


def test_wrapper_checks_what_the_kernel_takes():
    pwr = torch.ones(4, 6)
    scale = torch.ones(1, 6)
    ok = torch.ones(4, 6)
    tdetect._check(pwr, scale, ok, 1, 2, 1, 1)
    with pytest.raises(TypeError, match="float32"):
        tdetect._check(pwr.double(), scale, ok, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        tdetect._check(pwr, torch.ones(6), ok, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tdetect._check(pwr, scale, torch.ones(6, 4).t(), 1, 2, 1, 1)
    with pytest.raises(ValueError, match=">= 0"):
        tdetect._check(pwr, scale, ok, -1, 2, 1, 1)
    with pytest.raises(ValueError, match="non-empty"):
        tdetect._check(torch.ones(0, 6), scale, ok, 1, 2, 1, 1)


@pytest.mark.parametrize("case", CASES[:2], ids=["31x53", "16x40"])
def test_batched_stack_matches_each_map(case):
    """A (B, nr, nc) stack through detect_plain and FusedDetector gives each
    map's own result, and the JAX detector's, map by map (the sharded
    pipeline detects its CPI batch in one call)."""
    port, ref = _both(case, max_detections=8)
    nr, nc = case[:2]
    zs = np.stack([_case_map(case), _mk_map(nr, nc, seed=5),
                   _mk_map(nr, nc, seed=6, targets=[(2, 3, 40.0)])])
    z = torch.from_numpy(zs)
    pwr = (z.real * z.real + z.imag * z.imag).contiguous()
    kw = (port._scale, port._cell_ok, port.n_guard, port.n_train,
          port.win_rows, port.win_cols)
    stack = detect_plain(pwr, *kw)
    assert stack.noise.shape == (3,) and stack.keep.shape == pwr.shape
    db, noise, max_power, det = port(z)
    assert det.row.shape == (3, 8) and det.count.shape == (3,)
    for i in range(3):
        one = detect_plain(pwr[i], *kw)
        assert torch.equal(stack.keep[i], one.keep)
        assert torch.equal(stack.db[i], one.db)
        assert abs(float(stack.noise[i] - one.noise)) <= 1e-5
        _, _, _, d1 = port(z[i])
        for k in d1._fields:
            got = getattr(det, k)[i]
            if k == "snr":
                torch.testing.assert_close(got, getattr(d1, k), atol=1e-5,
                                           rtol=0)
            else:
                assert torch.equal(got, getattr(d1, k)), k
        jdb, jnoise, jmax, jdet = ref(jnp.asarray(zs[i]))
        assert abs(float(noise[i]) - float(jnoise)) <= 1e-4
        assert abs(float(max_power[i]) - float(jmax)) <= 1e-3
        jv = np.asarray(jdet.valid)
        v = det.valid[i].numpy()
        np.testing.assert_array_equal(det.row[i].numpy()[v],
                                      np.asarray(jdet.row)[jv])
        np.testing.assert_array_equal(det.col[i].numpy()[v],
                                      np.asarray(jdet.col)[jv])


@pytest.mark.parametrize("case", CASES, ids=[str(c[:2]) for c in CASES])
def test_complex_input_matches_power_input_and_jax(case):
    """The complex64 map through detect_plain and FusedDetector (which now
    hands it to the detector as it is): the same outputs as the float32
    power the port formed before, and the JAX detector's, which forms the
    power itself."""
    z = _case_map(case)
    port, ref = _both(case)
    zt = torch.from_numpy(z)
    kw = (port._scale, port._cell_ok, port.n_guard, port.n_train,
          port.win_rows, port.win_cols)
    pwr = (zt.real * zt.real + zt.imag * zt.imag).contiguous()
    got, want = detect_plain(zt, *kw), detect_plain(pwr, *kw)
    for k in got._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    jdb, jnoise, jmaxp, jdet = ref(jnp.asarray(z))
    np.testing.assert_allclose(got.db.numpy(), np.asarray(jdb), atol=2e-4)
    assert abs(float(got.noise) - float(jnoise)) <= 1e-4
    assert abs(float(got.rawmax - got.noise) - float(jmaxp)) <= 1e-4
    _, _, _, det = port(zt)
    jv = np.asarray(jdet.valid)
    assert int(det.count) == int(jdet.count) == int(got.keep.sum())
    np.testing.assert_array_equal(det.row.numpy()[det.valid.numpy()],
                                  np.asarray(jdet.row)[jv])
    np.testing.assert_array_equal(det.col.numpy()[det.valid.numpy()],
                                  np.asarray(jdet.col)[jv])


# -- the kernel's tiling ----------------------------------------------------

# (nr, nc, pfa, guard, train, win_rows, win_cols): the default config's
# detector, a ragged map (37 x 53: partial tiles in both directions), and
# centroid windows wider than a tile (41 x 147 cells against 24 x 48).
TILE_CASES = {
    "default": (301, 411, 1e-5, 2, 6, 5, 5),
    "default-loose": (301, 411, 1e-2, 1, 3, 5, 5),
    "ragged": (37, 53, 1e-2, 2, 6, 5, 5),
    "wide": (64, 200, 1e-2, 1, 3, 20, 73),
}


def _tile_inputs(name, seed=7):
    nr, nc, pfa, g, t, wr, wc = TILE_CASES[name]
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((nr, nc)) + 1j * rng.standard_normal((nr, nc))
    # A tie inside one centroid window, a peak on the left edge (masked by
    # cell_ok), one in the corner, one beside a weaker neighbour.
    for r, c, a in [(nr // 2, nc // 2, 40.0), (nr // 2, nc // 2 + 9, 40.0),
                    (3, 1, 30.0), (nr - 1, nc - 1, 25.0),
                    (nr // 3, nc // 4, 30.0),
                    (nr // 3 + 1, nc // 4 + 1, 20.0)]:
        z[r, c] += a
    pwr = torch.from_numpy(np.abs(z).astype(np.float32)) ** 2
    scale = torch.from_numpy(
        cfar_threshold_scale(pfa, g, t, nc).astype(np.float32))[None, :]
    ok = torch.ones(nr, nc)
    ok[:, :2] = 0.0
    return pwr, scale, ok, g, t, wr, wc


def _tiled_detect(pwr, scale, cell_ok, g, t, wr, wc):
    """The kernel's blocking in plain torch: each tile from its own loaded
    region (tile_geometry's halos, zeros outside the map), CFAR edges by
    the map's column index, hit power over the window halo, the separable
    window max, and the partial dB sums in block order. A halo one short
    breaks a slice below."""
    nr, nc = pwr.shape
    geo = tdetect.tile_geometry(nr, nc, g, t, wr, wc)
    tr, tc, hr, hc, hm = (geo.tile_rows, geo.tile_cols, geo.halo_rows,
                          geo.halo_cols, geo.hit_halo_cols)
    hp = hc - hm
    gx, gy = geo.grid

    def canvas(a, r_pad):
        out = torch.zeros(a.shape[0] + 2 * r_pad + (gy * tr - nr if r_pad
                                                    else 0),
                          gx * tc + 2 * hc)
        out[r_pad:r_pad + a.shape[0], hc:hc + nc] = a
        return out

    big, ok, sc = canvas(pwr, hr), canvas(cell_ok, hr), canvas(scale, 0)
    db = torch.full((nr, nc), float("nan"))
    keep = torch.full((nr, nc), float("nan"))
    partial = []
    mw = tc + 2 * hm
    for ty in range(gy):
        for tx in range(gx):
            r0, c0 = ty * tr, tx * tc
            p_reg = big[r0:r0 + tr + 2 * hr, c0:c0 + tc + 2 * hc]
            gj = torch.arange(c0 - hm, c0 - hm + mw)
            gi = torch.arange(r0 - hr, r0 + tr + hr)
            inside = ((gi >= 0) & (gi < nr))[:, None] \
                & ((gj >= 0) & (gj < nc))[None, :]
            p = p_reg[:, hp:hp + mw]
            train = torch.zeros_like(p)
            for o in range(g + 1, g + t + 1):
                train = train + torch.where(gj - o >= 1,
                                            p_reg[:, hp - o:hp - o + mw], 0.0)
                train = train + torch.where(gj + o < nc,
                                            p_reg[:, hp + o:hp + o + mw], 0.0)
            s = sc[0, c0 + hc - hm:c0 + hc - hm + mw]
            o_reg = ok[r0:r0 + tr + 2 * hr, c0 + hp:c0 + hp + mw]
            hit = inside & (p > s * train) & (o_reg > 0.0)
            m = torch.where(hit, p, 0.0)
            rm = m[0:tr]
            for d in range(1, 2 * wr + 1):
                rm = torch.maximum(rm, m[d:d + tr])
            wmax = rm[:, 0:tc]
            for d in range(1, 2 * wc + 1):
                wmax = torch.maximum(wmax, rm[:, d:d + tc])
            p_in = p_reg[hr:hr + tr, hc:hc + tc]
            k = (m[hr:hr + tr, hm:hm + tc] > 0.0) & (p_in >= wmax)
            rows, cols = min(tr, nr - r0), min(tc, nc - c0)
            d_in = (5.0 * torch.log10(p_in))[:rows, :cols]
            db[r0:r0 + rows, c0:c0 + cols] = d_in
            keep[r0:r0 + rows, c0:c0 + cols] = k[:rows, :cols].float()
            partial.append(d_in.sum())
    return db, keep, torch.stack(partial).sum() / (nr * nc)


def test_tile_geometry_default_and_limits():
    geo = tdetect.tile_geometry(301, 411, 2, 6, 5, 5)
    assert geo.grid == (9, 13) and geo.grid[0] * geo.grid[1] <= 132
    assert (geo.tile_rows, geo.tile_cols) == (24, 48)
    assert (geo.halo_rows, geo.halo_cols, geo.hit_halo_cols) == (5, 13, 5)
    # 34 x 74 power and cell_ok (then hit power), 74 scale, 34 powers of
    # map column 0, 24 x 58 row maxima.
    assert geo.smem_bytes == 4 * (2 * 34 * 74 + 74 + 34 + 24 * 58)
    assert tdetect.tile_geometry(37, 53, 2, 6, 5, 5).grid == (2, 2)
    wide = tdetect.tile_geometry(64, 200, 1, 3, 20, 73)
    assert 48 * 1024 < wide.smem_bytes < tdetect.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tdetect.tile_geometry(301, 411, 2, 6, 100, 300)


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tiled_model_matches_whole_map(name):
    """detect_plain on the whole map against the kernel's tiling run tile
    by tile with tile_geometry's halos."""
    pwr, scale, ok, g, t, wr, wc = _tile_inputs(name)
    want = detect_plain(pwr, scale, ok, g, t, wr, wc)
    db, keep, noise = _tiled_detect(pwr, scale, ok, g, t, wr, wc)
    assert int(want.keep.sum()) >= 3
    assert torch.equal(keep, want.keep)
    assert torch.equal(db, want.db)
    assert abs(float(noise - want.noise)) <= 1e-4
