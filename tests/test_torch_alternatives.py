"""The port's alternative algorithms (ECA-B, NLMS, OS-CFAR) on the single-device
and sharded paths, and mesh-mode sub-CPI spectra, against the JAX package on
the same seeded NumPy inputs.

Tolerances: the cancellers' complex128 outputs within 1e-9·max|y| and their
complex64 outputs within 1e-3·max|y| with the suppression within 0.1 dB;
``os_cfar_alpha`` to 1e-12 relative, OS-CFAR detection sets identical with
SNR within 1e-4 dB; complex128 pipelines (single-device at the verify
scene, sharded on the 2 × 4 mesh of ``tests/test_torch_sharded.py``) with
the map within 1e-6 dB and identical detections."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.dsp import cfar as jcfar
from blah2_tpu.dsp.ambiguity import map_metrics as jax_map_metrics
from blah2_tpu.dsp.clutter_eca import EcaBFilter as JaxEcaB
from blah2_tpu.dsp.clutter_eca import NlmsClutterFilter as JaxNlms
from blah2_tpu.dsp.pipeline import CpiPipeline as JaxPipeline
from blah2_tpu.parallel import commstats
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
from blah2_tpu.parallel.sharded import ShardedCpiPipeline as JaxSharded
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import ClutterConfig, DetectionConfig
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.convert import (pipeline_state_from_numpy,
                                     pipeline_state_to_numpy)
from blah2_tpu_torch.dsp import cfar as tcfar
from blah2_tpu_torch.dsp.ambiguity import map_metrics
from blah2_tpu_torch.dsp.clutter_eca import (EcaBFilter, NlmsClutterFilter,
                                             make_clutter_filter)
from blah2_tpu_torch.dsp.pipeline import CpiPipeline
from blah2_tpu_torch.ops import toeplitz
from blah2_tpu_torch.parallel import collectives as coll
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline
from tests.test_clutter_eca import (_exact_ls_oracle, _ramp_clutter_scene,
                                    _residual_db)
from tests.test_torch_sharded import _batch, _det_set, _jax_attr, _run, _scene

torch.set_num_threads(1)

C128 = (torch.complex128, jnp.complex128)
C64 = (torch.complex64, jnp.complex64)
N = 4_000


@pytest.fixture(scope="module")
def drifting():
    """The drifting-clutter scene of tests/test_clutter_eca.py:16-29."""
    return _ramp_clutter_scene(N, 10_000)


def _filter_pair(port, ref, x, y, dtypes):
    got, ok = port(torch.from_numpy(x), torch.from_numpy(y))
    want, jok = ref(jnp.asarray(x), jnp.asarray(y))
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    if dtypes[0] == torch.complex128:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * scale)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-3 * scale)
        assert abs(_residual_db(y, got.numpy())
                   - _residual_db(y, want)) <= 0.1
    assert bool(ok) == bool(jok)


# -- ops/toeplitz ---------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 5, 33])
def test_toeplitz_builders_match_jax(nb):
    from blah2_tpu.ops import toeplitz as jt

    rng = np.random.default_rng(nb)
    c = rng.standard_normal((3, 2, 2 * nb - 1)) \
        + 1j * rng.standard_normal((3, 2, 2 * nb - 1))
    for name in ("toeplitz_kj", "toeplitz_ij"):
        got = getattr(toeplitz, name)(torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            getattr(jt, name)(jnp.asarray(c))), err_msg=name)


# -- ECA-B and NLMS against JAX -------------------------------------------------

@pytest.mark.parametrize("dtypes", [C128, C64], ids=["c128", "c64"])
@pytest.mark.parametrize("delay_min", [-3, 0, 5])
@pytest.mark.parametrize("n_batches", [1, 4])
def test_ecab_matches_jax(drifting, n_batches, delay_min, dtypes):
    x, y = drifting
    port = EcaBFilter(delay_min, delay_min + 15, N, n_batches=n_batches,
                      dtype=dtypes[0], device="cpu")
    ref = JaxEcaB(delay_min, delay_min + 15, N, n_batches=n_batches,
                  dtype=dtypes[1])
    assert (port.n_seg, port.n_ext) == (ref.n_seg, ref.n_ext)
    assert port.nfft >= port.n_ext + port.n_bins
    np.testing.assert_array_equal(port._edge_mask.numpy(), ref._edge_mask)
    _filter_pair(port, ref, x, y, dtypes)


@pytest.mark.parametrize("dtypes", [C128, C64], ids=["c128", "c64"])
@pytest.mark.parametrize("delay_min", [-3, 0, 5])
@pytest.mark.parametrize("constrain", [True, False],
                         ids=["constrained", "free"])
def test_nlms_matches_jax(drifting, constrain, delay_min, dtypes):
    x, y = drifting
    port = NlmsClutterFilter(delay_min, delay_min + 15, N,
                             constrain=constrain, dtype=dtypes[0],
                             device="cpu")
    ref = JaxNlms(delay_min, delay_min + 15, N, constrain=constrain,
                  dtype=dtypes[1])
    assert (port.block, port.nfft, port.n_blocks) == \
        (ref.block, ref.nfft, ref.n_blocks)
    _filter_pair(port, ref, x, y, dtypes)


@pytest.mark.parametrize("n_batches", [1, 4])
def test_ecab_matches_exact_ls_oracle(n_batches):
    """The NumPy exact-LS oracle of tests/test_clutter_eca.py:38-59."""
    x, y = synthetic_cpi(N, 10_000, [], clutter_amplitude=3.0,
                         noise_amplitude=1e-3, seed=9)
    port = EcaBFilter(-3, 12, N, n_batches=n_batches, diag_load=0.0,
                      dtype=torch.complex128, device="cpu")
    got, ok = port(torch.from_numpy(x), torch.from_numpy(y))
    assert bool(ok)
    np.testing.assert_allclose(got.numpy(),
                               _exact_ls_oracle(x, y, -3, 12, n_batches),
                               rtol=0, atol=1e-8)


def test_ecab_failing_segment_flags_ok_as_jax(drifting):
    """A NaN in the reference channel's third segment fails that segment's
    solve in both packages; the other segments are filtered as before."""
    x, y = drifting
    x = x.copy()
    x[2 * (N // 4) + 500] = np.nan
    port = EcaBFilter(-3, 12, N, n_batches=4, dtype=torch.complex128,
                      device="cpu")
    ref = JaxEcaB(-3, 12, N, n_batches=4, dtype=jnp.complex128)
    got, ok = port(torch.from_numpy(x), torch.from_numpy(y))
    want, jok = ref(jnp.asarray(x), jnp.asarray(y))
    assert not bool(ok) and not bool(jok)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin[: N // 2].all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-9 * float(np.abs(want[fin]).max()))


def test_alternative_filters_batch_leading_dims(drifting):
    """A stack of CPIs gives each CPI's own output and flag."""
    x, y = drifting
    xb = torch.from_numpy(np.stack([x, 0.5 * x, -x]))
    yb = torch.from_numpy(np.stack([y, y, 2 * y]))
    for f in (EcaBFilter(-3, 12, N, n_batches=4, dtype=torch.complex128,
                         device="cpu"),
              NlmsClutterFilter(-3, 12, N, dtype=torch.complex128,
                                device="cpu")):
        got, ok = f(xb, yb)
        assert got.shape == (3, N) and ok.shape == (3,)
        for i in range(3):
            one, ok1 = f(xb[i], yb[i])
            np.testing.assert_allclose(got[i].numpy(), one.numpy(),
                                       rtol=0, atol=1e-12)
            assert bool(ok[i]) == bool(ok1)


@pytest.mark.parametrize("kind,cls", [("eca-b", EcaBFilter),
                                      ("ecab", EcaBFilter),
                                      ("nlms", NlmsClutterFilter)])
def test_factory_builds_the_alternatives(kind, cls):
    f = make_clutter_filter(ClutterConfig(filter=kind, delay_min=-2,
                                          delay_max=14, n_batches=4, mu=0.2),
                            4000, device="cpu")
    assert isinstance(f, cls)
    if cls is EcaBFilter:
        assert f.n_batches == 4 and f.diag_load == 1e-4
        g = make_clutter_filter(ClutterConfig(filter=kind, delay_min=-2,
                                              delay_max=14), 4000,
                                diag_load=1e-3, device="cpu")
        assert g.diag_load == 1e-3
    else:
        assert f.mu == 0.2 and f.block == 16


# -- OS-CFAR against JAX ----------------------------------------------------------

@pytest.mark.parametrize("pfa,n,k", [(1e-4, 8, 6), (1e-5, 12, 9),
                                     (0.05, 8, 6), (1e-3, 1, 1),
                                     (1e-6, 5, 9), (0.5, 3, 0),
                                     (1e-4, 0, 1), (1e-300, 4, 3)])
def test_os_cfar_alpha_matches_jax(pfa, n, k):
    got, want = tcfar.os_cfar_alpha(pfa, n, k), jcfar.os_cfar_alpha(pfa, n, k)
    if np.isinf(want):
        assert np.isinf(got)
    else:
        assert abs(got - want) <= 1e-12 * abs(want)


def _os_map(peaks, seed):
    """The maps of tests/test_cfar.py:17-23."""
    from tests.test_cfar import _map_with_peaks

    return _map_with_peaks(peaks, seed=seed)


OS_SCENES = {
    "reference": ([(15, 20, 30.0), (4, 10, 25.0), (18, 35, 20.0)], 2, {}),
    "masking": ([(15, 20, 6.0), (15, 24, 60.0)], 4, {}),
    "rank-half": ([(15, 20, 30.0), (16, 22, 18.0)], 5, {"rank": 0.5}),
    "overflow": ([], 6, {"pfa": 0.2, "n_guard": 1, "n_train": 3,
                         "max_detections": 8}),
}


@pytest.mark.parametrize("dtypes", [C128, C64], ids=["c128", "c64"])
@pytest.mark.parametrize("name", sorted(OS_SCENES))
def test_os_cfar_matches_jax(name, dtypes):
    """The scenes of tests/test_cfar.py:166-211, plus a rank of 1/2 and a
    map with more hits than capacity."""
    from tests.test_cfar import DELAY_AXIS, DOPPLER_AXIS

    peaks, seed, kw = OS_SCENES[name]
    args = dict(pfa=1e-4, n_guard=2, n_train=4, min_delay=3, min_doppler=10,
                delay_axis=DELAY_AXIS, doppler_axis=DOPPLER_AXIS,
                max_detections=64)
    args.update(kw)
    port = tcfar.OsCfarDetector(**args, device="cpu")
    ref = jcfar.OsCfarDetector(**args)
    np.testing.assert_array_equal(port._k_idx.numpy(), ref._k_idx)
    np.testing.assert_array_equal(port._alpha.numpy(), ref._alpha)
    assert port._alpha.dtype == torch.float32
    z = _os_map(peaks, seed).astype(np.dtype(dtypes[1]))
    _, noise, _ = map_metrics(torch.from_numpy(z))
    _, jnoise, _ = jax_map_metrics(jnp.asarray(z))
    det = port(torch.from_numpy(z), noise)
    jdet = ref(jnp.asarray(z), jnoise)
    assert int(det.count) == int(jdet.count)
    if name == "overflow":
        assert int(det.count) > 8
    v = np.asarray(jdet.valid)
    np.testing.assert_array_equal(det.valid.numpy(), v)
    np.testing.assert_array_equal(det.row.numpy()[v], np.asarray(jdet.row)[v])
    np.testing.assert_array_equal(det.col.numpy()[v], np.asarray(jdet.col)[v])
    np.testing.assert_allclose(det.snr.numpy()[v], np.asarray(jdet.snr)[v],
                               rtol=0, atol=1e-4)
    if name == "masking":
        assert (15, 20) in set(zip(det.row[det.valid].tolist(),
                                   det.col[det.valid].tolist()))


def test_make_cfar_builds_os():
    from tests.test_cfar import DELAY_AXIS, DOPPLER_AXIS

    c = tcfar.make_cfar(DetectionConfig(cfar="os", os_rank=0.5), DELAY_AXIS,
                        DOPPLER_AXIS, device="cpu")
    assert isinstance(c, tcfar.OsCfarDetector) and c.rank == 0.5
    assert not isinstance(c, tcfar.CfarDetector)
    with pytest.raises(ValueError, match="rank"):
        tcfar.OsCfarDetector(1e-4, 2, 4, 3, 10, DELAY_AXIS, DOPPLER_AXIS,
                             rank=1.5, device="cpu")


# -- the single-device pipeline -------------------------------------------------

# The scene of the verify recipe (tests/test_torch_pipeline.py).
VERIFY = {
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
ALTERNATIVES = {
    "eca-b": {"clutter": {"filter": "eca-b", "nBatches": 4}},
    "nlms": {"clutter": {"filter": "nlms", "mu": 0.1}},
    "os": {"detection": {"cfar": "os", "osRank": 0.75}},
    "eca-b+os": {"clutter": {"filter": "eca-b", "nBatches": 8},
                 "detection": {"cfar": "os"}},
}


def _config(base, changes):
    d = {k: dict(v) if isinstance(v, dict) else v for k, v in base.items()}
    d["process"] = {k: dict(v) for k, v in base["process"].items()}
    for stage, kv in changes.items():
        d["process"][stage].update(kv)
    return d


@pytest.fixture(scope="module")
def verify_scene():
    return synthetic_cpi(20_000, 200_000, [TargetSpec(40, -77.0, 0.05),
                                           TargetSpec(61, 112.0, 0.03)],
                         clutter_amplitude=3.0, noise_amplitude=1e-3, seed=7)


def _dets(det):
    v = np.asarray(det.valid)
    return set(zip(np.asarray(det.row)[v].tolist(),
                   np.asarray(det.col)[v].tolist()))


@pytest.mark.parametrize("name", sorted(ALTERNATIVES))
def test_pipeline_alternative_matches_jax(verify_scene, name):
    x, y = verify_scene
    d = _config(VERIFY, ALTERNATIVES[name])
    port = CpiPipeline(config_from_dict(d), dtype=torch.complex128,
                       device="cpu")
    ref = JaxPipeline(jax_config(d), dtype=jnp.complex128, use_pallas=False)
    out, jout = port(x, y), ref(x, y)
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               rtol=0, atol=1e-6)
    assert abs(float(out.noise_power) - float(jout.noise_power)) < 1e-6
    assert bool(out.clutter_ok) == bool(jout.clutter_ok) is True
    assert _dets(out.detections) == _dets(jout.detections)
    assert len(_dets(jout.detections)) >= 1
    v = np.asarray(jout.detections.valid)
    np.testing.assert_allclose(out.detections.snr.numpy()[v],
                               np.asarray(jout.detections.snr)[v], atol=1e-6)


@pytest.mark.parametrize("fused", [True, "auto"])
def test_os_cfar_never_takes_the_fused_detector(verify_scene, fused):
    """The fused kernel computes CA-CFAR, so with ``cfar: os`` the pipeline
    runs the unfused chain, as JAX's does (`blah2_tpu/dsp/pipeline.py:154`),
    and finds JAX's detections."""
    from blah2_tpu_torch.ops import detect as tdetect

    x, y = verify_scene
    d = _config(VERIFY, ALTERNATIVES["os"])
    port = CpiPipeline(config_from_dict(d), fused_detect=fused,
                       device="cpu")
    assert port.fused_detector is None
    ref = JaxPipeline(jax_config(d), use_pallas=True)
    assert ref.fused_detector is None
    before = tdetect.detect.launches
    out, jout = port(x, y), ref(x, y)
    staged = port.call_staged(x, y)
    assert tdetect.detect.launches == before
    assert _dets(out.detections) == _dets(jout.detections) \
        == _dets(staged.detections)


def test_fused_detector_with_an_alternative_canceller(verify_scene):
    """ECA-B and NLMS with CA-CFAR keep the fused detector; its detections
    equal the unfused chain's."""
    x, y = verify_scene
    for name in ("eca-b", "nlms"):
        cfg = config_from_dict(_config(VERIFY, ALTERNATIVES[name]))
        fused = CpiPipeline(cfg, fused_detect=True, device="cpu")
        assert fused.fused_detector is not None
        plain = CpiPipeline(cfg, fused_detect=False, device="cpu")
        a, b = fused(x, y), plain(x, y)
        assert _dets(a.detections) == _dets(b.detections)
        np.testing.assert_allclose(a.db_map.numpy(), b.db_map.numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("dtypes", [C64, C128], ids=["c64", "c128"])
def test_alternative_state_matches_jax_and_round_trips(dtypes):
    """convert.py hands OS-CFAR's and ECA-B's constants across under the
    JAX attribute paths."""
    dt, jdt = dtypes
    d = _config(VERIFY, ALTERNATIVES["eca-b+os"])
    port = CpiPipeline(config_from_dict(d), dtype=dt, device="cpu")
    ref = JaxPipeline(jax_config(d), dtype=jdt, use_pallas=False)
    state = pipeline_state_to_numpy(port)
    assert {"cfar._alpha", "cfar._k_idx", "clutter._edge_mask"} <= set(state)
    exported = {k: _jax_attr(ref, k) for k in state}
    for k, v in state.items():
        np.testing.assert_array_equal(v, exported[k], err_msg=k)
    fresh = CpiPipeline(config_from_dict(d), dtype=dt, device="cpu")
    fresh.load_state_dict(pipeline_state_from_numpy(exported, "cpu"))
    for k, v in fresh.state_dict().items():
        assert v.dtype == port.state_dict()[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


# -- the sharded pipeline on the 2 x 4 mesh ----------------------------------------

SHARDED_CASES = {
    "eca-b": {"process__clutter__filter": "eca-b"},
    "eca-b-delay0": {"process__clutter__filter": "eca-b",
                     "process__clutter__delayMin": 0},
    "nlms": {"process__clutter__filter": "nlms"},
    "os": {"process__detection__cfar": "os"},
    "nsub2": {"process__spectrum": {"nSub": 2}},
    "nsub4-nlms": {"process__spectrum": {"nSub": 4},
                   "process__clutter__filter": "nlms"},
}


def _mesh24():
    return make_radar_mesh(2, 4, devices=["cpu"] * 8)


@pytest.mark.parametrize("backend", ["ppermute", "pallas"])
@pytest.mark.parametrize("name", sorted(SHARDED_CASES))
def test_sharded_alternative_matches_jax(name, backend):
    d = _scene(**SHARDED_CASES[name])
    xb, yb = _batch(d, b=2, seed=2)
    port = ShardedCpiPipeline(config_from_dict(d), _mesh24(),
                              dtype=torch.complex128, halo_backend=backend)
    # JAX's side runs its ppermute backend for both of the port's:
    # tests/test_halo.py holds JAX's two backends equal, and its
    # interpret-mode Pallas halo has aborted a test worker here.
    ref = JaxSharded(jax_config(d), jax_mesh(2, 4), dtype=jnp.complex128,
                     halo_backend="ppermute")
    if port.clutter_kind == "eca-b":
        assert (port.n_seg_eca, port.seg_len_eca, port.n_batches_eca) == \
            (ref.n_seg_eca, ref.seg_len_eca, ref.n_batches_eca)
    if port.clutter_kind == "nlms":
        assert (port.nlms_L, port.nlms_K, port.nlms_W) == \
            (ref.nlms_L, ref.nlms_K, ref.nlms_W)
        assert port.nlms_W > 0
    out, jout = _run(port, xb, yb), _run(ref, xb, yb)
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.noise_power.numpy(),
                               np.asarray(jout.noise_power), atol=1e-6)
    np.testing.assert_allclose(out.spectrum_db.numpy(),
                               np.asarray(jout.spectrum_db), atol=1e-6)
    if jout.sub_spectra_db is None:
        assert out.sub_spectra_db is None
    else:
        assert out.sub_spectra_db.shape == jout.sub_spectra_db.shape
        np.testing.assert_allclose(out.sub_spectra_db.numpy(),
                                   np.asarray(jout.sub_spectra_db),
                                   atol=1e-6)
    np.testing.assert_array_equal(out.clutter_ok.numpy(),
                                  np.asarray(jout.clutter_ok))
    for i in range(2):
        assert _det_set(out.detections, i) == _det_set(jout.detections, i)


def test_sharded_sub_spectra_match_single_device():
    """Mesh-mode sub spectra equal the single-device pipeline's, per CPI."""
    d = _scene(process__spectrum={"nSub": 4})
    xb, yb = _batch(d, b=2, seed=4)
    sp = ShardedCpiPipeline(config_from_dict(d), _mesh24(),
                            dtype=torch.complex128)
    out = _run(sp, xb, yb)
    single = CpiPipeline(config_from_dict(d), dtype=torch.complex128,
                         clutter_mode="linear", device="cpu")
    for i in range(2):
        np.testing.assert_allclose(out.sub_spectra_db[i].numpy(),
                                   single(xb[i], yb[i]).sub_spectra_db.numpy(),
                                   atol=1e-6)


def test_sharded_ecab_failure_is_the_rows_psum():
    """A NaN in one rank's block of CPI 1 fails that CPI's ok on every
    rank of its row, and leaves CPI 0 good, as JAX's psum does."""
    d = _scene(process__clutter__filter="eca-b")
    xb, yb = _batch(d, b=2, seed=6)
    xb = xb.copy()
    xb[1, 5_000] = np.nan
    port = ShardedCpiPipeline(config_from_dict(d), _mesh24(),
                              dtype=torch.complex128)
    ref = JaxSharded(jax_config(d), jax_mesh(2, 4), dtype=jnp.complex128)
    out, jout = _run(port, xb, yb), _run(ref, xb, yb)
    assert out.clutter_ok.tolist() == np.asarray(jout.clutter_ok).tolist() \
        == [True, False]


def test_sharded_nlms_ranks_in_turn_equal_the_batched_scan():
    d = _scene(process__clutter__filter="nlms")
    xb, yb = _batch(d, b=2, seed=8)
    sp = ShardedCpiPipeline(config_from_dict(d), _mesh24(),
                            dtype=torch.complex128)
    planes = sp.shard_inputs(xb, yb)
    a = sp(*planes)
    sp.nlms_batch_ranks = False
    b = sp(*planes)
    np.testing.assert_allclose(a.db_map.numpy(), b.db_map.numpy(), rtol=0,
                               atol=1e-9)
    for i in range(2):
        assert _det_set(a.detections, i) == _det_set(b.detections, i)


@pytest.mark.parametrize("kind", ["eca-b", "nlms"])
def test_sharded_alternative_collectives_match_jax(kind):
    """One step's collectives: three halo shifts (ECA-B: the delay shift and
    the (nb−1) lookahead and history; NLMS: the delay shift and the (W+1)·L
    and W·L replay windows) with JAX's payloads, on both backends."""
    d = _scene(process__clutter__filter=kind)
    mesh = _mesh24()
    sp = ShardedCpiPipeline(config_from_dict(d), mesh)
    x = np.zeros((2, sp.n_samples), np.complex64)
    xp, yp = sp.shard_inputs(x, x)
    with coll.count_bytes(mesh) as ops:
        sp(xp, yp)
    permutes = sorted(op.bytes_per_rank for op in ops if op.kind == "permute")
    c64, s = 8, abs(sp.clutter_delay_min)
    if kind == "eca-b":
        want = [s * c64] + [(sp.nb - 1) * c64] * 2
        # The fold, the failures, and (row-sharded) the detection's dB sum.
        assert sum(op.kind == "psum" for op in ops) == 2 + sp._row_shard
    else:
        L, W = sp.nlms_L, sp.nlms_W
        want = [s * c64, (W + 1) * L * c64, W * L * c64]
    assert permutes == sorted(want)
    ref = JaxSharded(jax_config(d), jax_mesh(2, 4))
    jops = commstats.collect(ref._fn, *ref.shard_inputs(x, x))
    assert sorted(op.bytes_per_rank for op in jops
                  if op.kind == "collective-permute") == permutes
    sp.halo_backend = "pallas"
    with coll.count_bytes(mesh) as ops2:
        sp(xp, yp)
    assert sorted(op.bytes_per_rank for op in ops2
                  if op.kind == "permute") == permutes


@pytest.mark.parametrize("dtypes", [C64, C128], ids=["c64", "c128"])
def test_sharded_alternative_state_matches_jax(dtypes):
    dt, jdt = dtypes
    d = _scene(process__clutter__filter="eca-b",
               process__spectrum={"nSub": 4})
    port = ShardedCpiPipeline(config_from_dict(d), _mesh24(), dtype=dt)
    ref = JaxSharded(jax_config(d), jax_mesh(2, 4), dtype=jdt)
    state = pipeline_state_to_numpy(port)
    assert {"_sub_tw_pad", "_eca_edge_mask", "spectrum_sub._twiddle"} \
        <= set(state)
    exported = {k: _jax_attr(ref, k) for k in state}
    for k, v in state.items():
        np.testing.assert_array_equal(v, exported[k], err_msg=k)
    fresh = ShardedCpiPipeline(config_from_dict(d), _mesh24(), dtype=dt)
    fresh.load_state_dict(pipeline_state_from_numpy(exported, "cpu"))
    xb, yb = _batch(d, b=2, seed=1)
    assert torch.equal(_run(port, xb, yb).db_map, _run(fresh, xb, yb).db_map)


def test_sharded_geometry_default_config():
    """The default config's ECA-B and NLMS geometry on 1 × 4 ranks."""
    from blah2_tpu_torch.config import Config

    cfg = Config()
    mesh = make_radar_mesh(1, 4, devices=["cpu"] * 4)
    cfg.process.clutter.filter = "eca-b"
    sp = ShardedCpiPipeline(cfg, mesh)
    assert (sp.block_len, sp.n_seg_eca, sp.seg_len_eca) == \
        (378_708, 2, 189_354)
    assert sp.nfft_eca >= 189_354 + 3 * 409 + 1
    cfg.process.clutter.filter = "nlms"
    sp = ShardedCpiPipeline(cfg, mesh)
    assert (sp.nlms_L, sp.nlms_K, sp.nlms_W) == (512, 740, 20)
