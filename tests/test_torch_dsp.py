"""The port's DSP stages (clutter filter, ambiguity, map metrics, CFAR,
centroid, interpolation) against the JAX package on the same NumPy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.capture.synthetic import TargetSpec as JaxTarget
from blah2_tpu.capture.synthetic import synthetic_cpi as jax_synthetic_cpi
from blah2_tpu.config import ClutterConfig
from blah2_tpu.dsp import ambiguity as jamb
from blah2_tpu.dsp import cfar as jcfar
from blah2_tpu.dsp.centroid import CentroidFilter as JaxCentroid
from blah2_tpu.dsp.clutter import WienerHopfFilter as JaxWiener
from blah2_tpu.dsp.interpolate import PeakInterpolator as JaxInterp
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.dsp import ambiguity as tamb
from blah2_tpu_torch.dsp import cfar as tcfar
from blah2_tpu_torch.dsp.centroid import CentroidFilter
from blah2_tpu_torch.dsp.clutter import WienerHopfFilter
from blah2_tpu_torch.dsp.clutter_eca import make_clutter_filter
from blah2_tpu_torch.dsp.interpolate import PeakInterpolator

torch.set_num_threads(1)

C128 = (torch.complex128, jnp.complex128)
C64 = (torch.complex64, jnp.complex64)


def test_synthetic_copy_matches_jax():
    tgts = [(40, -77.0, 0.05), (-3, 12.0, 0.2)]
    x, y = synthetic_cpi(5000, 20_000, [TargetSpec(*t) for t in tgts],
                         clutter_amplitude=3.0, noise_amplitude=1e-3, seed=4)
    jx, jy = jax_synthetic_cpi(5000, 20_000, [JaxTarget(*t) for t in tgts],
                               clutter_amplitude=3.0, noise_amplitude=1e-3,
                               seed=4)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


# -- Wiener-Hopf clutter filter ---------------------------------------------

FS = 10_000


def _channels(n, seed=11):
    return synthetic_cpi(n, FS, [TargetSpec(5, 17.0, 0.05),
                                 TargetSpec(30, 40.0, 0.5)],
                         clutter_amplitude=2.0, noise_amplitude=1e-3,
                         seed=seed)


# (n, delay_min, delay_max, round_hamming): 20_000 with round_hamming takes
# the segmented path (16 segments); round_hamming=False and a prime n take
# the monolithic one.
CLUTTER = [(20_000, -3, 10, True), (20_000, -3, 10, False),
           (2003, -3, 10, True), (20_000, 4, 40, True), (2000, 0, 12, False)]


@pytest.mark.parametrize("mode", ["circular", "linear"])
@pytest.mark.parametrize("case", CLUTTER, ids=[str(c) for c in CLUTTER])
def test_wiener_hopf_matches_jax(case, mode):
    n, dmin, dmax, rh = case
    x, y = _channels(n)
    port = WienerHopfFilter(dmin, dmax, n, round_hamming=rh, mode=mode,
                            dtype=torch.complex128, device="cpu")
    ref = JaxWiener(dmin, dmax, n, round_hamming=rh, mode=mode,
                    dtype=jnp.complex128)
    assert bool(port.n_seg) == bool(ref.n_seg)
    got, ok = port(torch.from_numpy(x), torch.from_numpy(y))
    want, jok = ref(jnp.asarray(x), jnp.asarray(y))
    assert bool(ok) and bool(jok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=1e-9)


def test_wiener_hopf_complex64_and_diag_load_match_jax():
    x, y = _channels(20_000, seed=3)
    for dt, jdt in (C64, C128):
        port = WienerHopfFilter(-3, 10, 20_000, diag_load=1e-3, dtype=dt,
                                device="cpu")
        ref = JaxWiener(-3, 10, 20_000, diag_load=1e-3, dtype=jdt)
        got, ok = port(torch.from_numpy(x), torch.from_numpy(y))
        want, _ = ref(jnp.asarray(x), jnp.asarray(y))
        assert bool(ok)
        tol = 1e-9 if dt == torch.complex128 else 1e-4
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("n,rh", [(20_000, True), (2000, False)])
def test_wiener_hopf_failed_solve_keeps_y(n, rh):
    """A reference channel of zeros gives an all-zero normal matrix, which is
    not positive definite: ok is False and y passes through unchanged, as
    in the JAX module."""
    _, y = _channels(n)
    x = np.zeros(n, dtype=np.complex128)
    port = WienerHopfFilter(-3, 10, n, round_hamming=rh,
                            dtype=torch.complex128, device="cpu")
    got, ok = port(torch.from_numpy(x), torch.from_numpy(y))
    _, jok = JaxWiener(-3, 10, n, round_hamming=rh,
                       dtype=jnp.complex128)(jnp.asarray(x), jnp.asarray(y))
    assert not bool(ok) and not bool(jok)
    np.testing.assert_array_equal(got.numpy(), y)


def test_make_clutter_filter():
    f = make_clutter_filter(ClutterConfig(delay_min=-3, delay_max=10), 2000,
                            dtype=torch.complex128, device="cpu")
    assert isinstance(f, WienerHopfFilter) and f.n_bins == 13
    from blah2_tpu_torch.dsp.clutter_eca import EcaBFilter, NlmsClutterFilter

    for kind, cls in (("eca-b", EcaBFilter), ("nlms", NlmsClutterFilter)):
        g = make_clutter_filter(ClutterConfig(filter=kind, delay_min=-3,
                                              delay_max=10), 2000,
                                device="cpu")
        assert isinstance(g, cls) and g.n_bins == 13
    with pytest.raises(ValueError):
        make_clutter_filter(ClutterConfig(filter="bogus"), 2000, device="cpu")


# -- ambiguity and map metrics ------------------------------------------------

GEOMS = [
    # (delay_min, delay_max, doppler_min, doppler_max, fs, n): the second
    # and third are off-centre Doppler windows, which engage the ramp.
    (-5, 20, -50, 50, 10_000, 1000),
    (-5, 20, -30, 50, 10_000, 1000),
    (-10, 100, -150, 250, 200_000, 20_000),
]


@pytest.mark.parametrize("matmul", [True, False])
@pytest.mark.parametrize("geom", GEOMS, ids=[str(g) for g in GEOMS])
def test_ambiguity_matches_jax(geom, matmul):
    rng = np.random.default_rng(5)
    n = geom[-1]
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    port = tamb.AmbiguityProcessor(*geom, dtype=torch.complex128,
                                   doppler_via_matmul=matmul, device="cpu")
    ref = jamb.AmbiguityProcessor(*geom, dtype=jnp.complex128,
                                  doppler_via_matmul=matmul)
    for k in ("n_delay_bins", "n_doppler_bins", "n_corr", "nfft", "cpi",
              "doppler_resolution", "doppler_middle"):
        assert getattr(port, k) == getattr(ref, k), k
    assert (port._ramp is None) == (ref._ramp is None)
    np.testing.assert_array_equal(port.delay_axis.numpy(), ref.delay_axis)
    np.testing.assert_array_equal(port.doppler_axis.numpy(), ref.doppler_axis)
    got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    db, noise, maxp = tamb.map_metrics(torch.from_numpy(got))
    jdb, jnoise, jmaxp = jamb.map_metrics(jnp.asarray(got))
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=1e-9)
    assert abs(float(noise) - float(jnoise)) < 1e-9
    assert abs(float(maxp) - float(jmaxp)) < 1e-9


def test_ambiguity_geometry_default_config():
    amb = tamb.AmbiguityProcessor(-10, 400, -200, 200, 2_000_000, 1_500_000,
                                  device="cpu")
    assert (amb.n_doppler_bins, amb.n_delay_bins, amb.n_corr, amb.nfft,
            amb.nfft_compute) == (301, 411, 4983, 10000, 10000)
    with pytest.raises(ValueError, match="delay window"):
        tamb.AmbiguityProcessor(-10, 400, -200, 200, 40_000, 4000,
                                device="cpu")


def test_map_metrics_values():
    z = torch.tensor([[1.0 + 0j, 10.0 + 0j], [100.0 + 0j, 1.0 + 0j]])
    db, noise, maxp = tamb.map_metrics(z)
    assert abs(float(noise) - 7.5) < 1e-6 and abs(float(maxp) - 12.5) < 1e-6
    assert abs(float(db[1, 0]) - 20.0) < 1e-6


# -- CFAR, centroid, interpolation --------------------------------------------

N_ROWS, N_COLS = 21, 40
DELAY_AXIS = np.arange(-5, N_COLS - 5)
DOPPLER_AXIS = np.linspace(-50, 50, N_ROWS)


def _map(peaks, seed):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((N_ROWS, N_COLS))
         + 1j * rng.standard_normal((N_ROWS, N_COLS))) / np.sqrt(2)
    for (r, c, amp) in peaks:
        z[r, c] += amp
    return z


CFAR_ARGS = [
    dict(pfa=1e-4, n_guard=2, n_train=4, min_delay=3, min_doppler=10,
         max_detections=64),
    dict(pfa=1e-2, n_guard=1, n_train=3, min_delay=0, min_doppler=0.0,
         max_detections=8),  # capacity below the hit count: count > K
]


@pytest.mark.parametrize("args", CFAR_ARGS, ids=["pfa1e-4", "overflow"])
@pytest.mark.parametrize("dtypes", [C128, C64], ids=["c128", "c64"])
def test_cfar_centroid_interp_chain_matches_jax(args, dtypes):
    dt, jdt = dtypes
    peaks = [(15, 20, 40.0), (15, 21, 20.0), (3, 7, 25.0), (10, 30, 30.0),
             (11, 30, 12.0)]
    z = _map(peaks, seed=1).astype(np.dtype(jdt))
    kw = dict(args, delay_axis=DELAY_AXIS, doppler_axis=DOPPLER_AXIS)
    port = tcfar.CfarDetector(**kw, device="cpu")
    ref = jcfar.CfarDetector(**kw)
    np.testing.assert_array_equal(port._thresh_scale.numpy(),
                                  ref._thresh_scale)

    zt = torch.from_numpy(z)
    db, noise, _ = tamb.map_metrics(zt)
    jdb, jnoise, _ = jamb.map_metrics(jnp.asarray(z))
    det = port(zt, noise)
    jdet = ref(jnp.asarray(z), jnoise)
    assert int(det.count) == int(jdet.count)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.row.numpy(), np.asarray(jdet.row))
    np.testing.assert_array_equal(det.col.numpy(), np.asarray(jdet.col))
    np.testing.assert_allclose(det.snr.numpy(), np.asarray(jdet.snr),
                               atol=2e-5)

    res = 100.0 / (N_ROWS - 1)
    det = CentroidFilter(3, 2, res)(det)
    jdet = JaxCentroid(3, 2, res)(jdet)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    assert int(det.count) == int(jdet.count)

    det = PeakInterpolator(True, True, res, N_ROWS, N_COLS)(det, db - noise)
    jdet = JaxInterp(True, True, res, N_ROWS, N_COLS)(jdet, jdb - jnoise)
    v = np.asarray(jdet.valid)
    np.testing.assert_array_equal(det.valid.numpy(), v)
    assert v.any()
    tol = 1e-9 if dt == torch.complex128 else 2e-3
    for k in ("delay", "doppler", "snr"):
        np.testing.assert_allclose(getattr(det, k).numpy()[v],
                                   np.asarray(getattr(jdet, k))[v],
                                   atol=tol if k != "snr" else 2e-3)


def test_extract_topk_first_k_in_row_major_order():
    rng = np.random.default_rng(9)
    mask = rng.random(500) < 0.2
    for k in (4, 50, 200):
        row, col, valid, count = tcfar.extract_topk(torch.from_numpy(mask),
                                                    25, k)
        jr, jc, jv, jn = jcfar.extract_topk(jnp.asarray(mask), 25, k)
        assert int(count) == int(jn) == int(mask.sum())
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(col.numpy(), np.asarray(jc))
        hits = np.flatnonzero(mask)[:k]
        np.testing.assert_array_equal((row * 25 + col).numpy()[:len(hits)],
                                      hits)


def test_make_cfar():
    from blah2_tpu_torch.config import DetectionConfig

    c = tcfar.make_cfar(DetectionConfig(), DELAY_AXIS, DOPPLER_AXIS,
                        device="cpu")
    assert isinstance(c, tcfar.CfarDetector)
    c = tcfar.make_cfar(DetectionConfig(cfar="os"), DELAY_AXIS, DOPPLER_AXIS,
                        device="cpu")
    assert isinstance(c, tcfar.OsCfarDetector) and c.rank == 0.75
    with pytest.raises(ValueError):
        tcfar.make_cfar(DetectionConfig(cfar="x"), DELAY_AXIS, DOPPLER_AXIS,
                        device="cpu")
    for args in [(1e-5, 2, 6, 411), (1e-3, 0, 4, 9), (0.5, 3, 1, 5)]:
        np.testing.assert_array_equal(tcfar.cfar_threshold_scale(*args),
                                      jcfar.cfar_threshold_scale(*args))
