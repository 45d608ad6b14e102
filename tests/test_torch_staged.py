"""The port's staged CPI (``CpiPipeline.call_staged``) and sub-CPI spectra
(``process.spectrum.nSub``) against the JAX package's, and the staged CPI
against the port's own fused call, on the verify scene (fs 200 kHz, CPI
0.1 s). Bars as in tests/test_torch_pipeline.py: complex128 within 1e-6 dB,
complex64 within the golden and fused-detector bounds."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.dsp.pipeline import CpiPipeline as JaxPipeline
from blah2_tpu.dsp.spectrum import SpectrumAnalyser as JaxSpectrum
from blah2_tpu.ops.pack12 import unpack_planes as jax_unpack_planes
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.convert import (pipeline_state_from_numpy,
                                     pipeline_state_to_numpy)
from blah2_tpu_torch.data.timing import StageTimer
from blah2_tpu_torch.dsp.pipeline import CpiPipeline
from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser
from blah2_tpu_torch.ops.pack12 import pack12_planes, unpack_planes

torch.set_num_threads(1)

SCENE = {
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
STAGES = ["spectrum", "clutter_filter", "ambiguity_processing", "detector"]


def _scene_dict(n_sub=1):
    d = json.loads(json.dumps(SCENE))
    d["process"]["spectrum"] = {"nSub": n_sub}
    return d


@pytest.fixture(scope="module")
def scene():
    return synthetic_cpi(20_000, 200_000,
                         [TargetSpec(40, -77.0, 0.05),
                          TargetSpec(61, 112.0, 0.03)],
                         clutter_amplitude=3.0, noise_amplitude=1e-3, seed=7)


def _valid(det, k):
    v = np.asarray(det.valid)
    return np.asarray(getattr(det, k))[v]


def _timed_staged(pipe, x, y):
    st = StageTimer()
    st.start()
    out = pipe.call_staged(x, y, timer=st)
    assert st.names == STAGES
    assert all(t >= 0.0 for t in st.times_ms)
    return out


def test_staged_complex128_matches_jax_and_fused(scene):
    x, y = scene
    port = CpiPipeline(config_from_dict(SCENE), dtype=torch.complex128,
                       device="cpu")
    ref = JaxPipeline(jax_config(SCENE), dtype=jnp.complex128,
                      use_pallas=False)
    out = _timed_staged(port, x, y)
    jout = ref.call_staged(x, y)
    fused = port(x, y)
    for other in (np.asarray(jout.db_map), fused.db_map.numpy()):
        np.testing.assert_allclose(out.db_map.numpy(), other, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(out.spectrum_db.numpy(),
                               np.asarray(jout.spectrum_db), atol=1e-6)
    assert abs(float(out.noise_power) - float(jout.noise_power)) < 1e-6
    assert abs(float(out.max_power) - float(jout.max_power)) < 1e-6
    assert bool(out.clutter_ok) and out.sub_spectra_db is None
    d, jd = out.detections, jout.detections
    assert _valid(jd, "row").size == 2
    for k in ("row", "col"):
        np.testing.assert_array_equal(_valid(d, k), _valid(jd, k))
        np.testing.assert_array_equal(_valid(d, k), _valid(fused.detections,
                                                           k))
    for k in ("delay", "doppler", "snr"):
        np.testing.assert_allclose(_valid(d, k), _valid(jd, k), atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_staged_complex64_matches_jax_and_fused(scene, fused):
    """fused_detect on and off against use_pallas on (interpret) and off;
    against the port's fused call the staged products are the same
    function on the same device."""
    x, y = (a.astype(np.complex64) for a in scene)
    port = CpiPipeline(config_from_dict(SCENE), fused_detect=fused,
                       device="cpu")
    ref = JaxPipeline(jax_config(SCENE), use_pallas=fused)
    out = _timed_staged(port, x, y)
    jout = ref.call_staged(x, y)
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               atol=0.05)
    np.testing.assert_allclose(out.spectrum_db.numpy(),
                               np.asarray(jout.spectrum_db), atol=2e-3)
    assert abs(float(out.noise_power) - float(jout.noise_power)) <= 1e-4
    assert abs(float(out.max_power) - float(jout.max_power)) <= 1e-3
    d, jd = out.detections, jout.detections
    assert _valid(jd, "row").size == 2
    for k in ("row", "col"):
        np.testing.assert_array_equal(_valid(d, k), _valid(jd, k))
    np.testing.assert_allclose(_valid(d, "snr"), _valid(jd, "snr"),
                               atol=2e-3)
    own = port(x, y)
    assert float((own.db_map - out.db_map).abs().max()) <= 2e-4
    assert abs(float(own.noise_power) - float(out.noise_power)) <= 1e-4
    for k in ("row", "col", "valid"):
        assert torch.equal(getattr(own.detections, k),
                           getattr(out.detections, k)), k


def test_staged_takes_wire_planes(scene):
    """Int16 planes (the wire) and the int32 planes of a packed chunk's
    decode give the same staged products as the complex samples they
    hold."""
    x, y = scene
    q = np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                  axis=1) * 150), -2048, 2047
                ).astype(np.int16)
    xp, yp = q[:, :2], q[:, 2:]
    pipe = CpiPipeline(config_from_dict(SCENE), device="cpu")
    base = pipe.call_staged(xp, yp)
    from32 = pipe.call_staged(
        unpack_planes(torch.from_numpy(pack12_planes(xp))),
        unpack_planes(torch.from_numpy(pack12_planes(yp))))
    complex_in = pipe.call_staged(xp[:, 0] + 1j * xp[:, 1].astype(np.float32),
                                  yp[:, 0] + 1j * yp[:, 1].astype(np.float32))
    for other in (from32, complex_in):
        assert torch.equal(base.db_map, other.db_map)
        assert torch.equal(base.detections.valid, other.detections.valid)


@pytest.mark.parametrize("kind", ["packed", "int16", "float32"])
def test_unpack_planes_matches_jax(kind):
    rng = np.random.default_rng(2)
    planes = rng.integers(-2048, 2048, size=(600, 2)).astype(np.int16)
    chunk = {"packed": pack12_planes(planes), "int16": planes,
             "float32": planes.astype(np.float32)}[kind]
    got = unpack_planes(torch.from_numpy(chunk))
    want = np.asarray(jax_unpack_planes(jnp.asarray(chunk)))
    assert got.dtype == {"packed": torch.int32, "int16": torch.int16,
                         "float32": torch.float32}[kind]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), planes)


# -- sub-CPI spectra ----------------------------------------------------------

@pytest.mark.parametrize("n_sub", [2, 4])
@pytest.mark.parametrize("dtypes", [(torch.complex128, jnp.complex128, 1e-6),
                                    (torch.complex64, jnp.complex64, 2e-3)],
                         ids=["c128", "c64"])
def test_sub_spectra_match_jax(scene, n_sub, dtypes):
    """The fused CPI's sub spectra and the staged path's ``sub_spectra_fn``
    against JAX's ``_sub_spectra_db`` on the same samples."""
    dt, jdt, tol = dtypes
    x, y = scene
    if dt == torch.complex64:
        x, y = x.astype(np.complex64), y.astype(np.complex64)
    d = _scene_dict(n_sub)
    port = CpiPipeline(config_from_dict(d), dtype=dt, device="cpu")
    ref = JaxPipeline(jax_config(d), dtype=jdt, use_pallas=False)
    assert port.spectrum_sub.n_spectrum == ref.spectrum_sub.n_spectrum
    assert port.spectrum_sub.decimation == ref.spectrum_sub.decimation
    want = np.asarray(ref._sub_spectra_db(jnp.asarray(x, jdt)))
    assert want.shape == (n_sub, port.spectrum.n_spectrum)
    out = port(x, y)
    np.testing.assert_allclose(out.sub_spectra_db.numpy(), want, atol=tol)
    np.testing.assert_allclose(np.asarray(ref(x, y).sub_spectra_db), want,
                               atol=tol)
    xp = port.to_planes(x, port._plane_dtype)
    np.testing.assert_allclose(port.sub_spectra_fn(xp).numpy(), want,
                               atol=tol)
    np.testing.assert_allclose(
        np.asarray(ref.sub_spectra_fn(ref.to_planes(x, ref._plane_dtype))),
        want, atol=tol)
    # The staged CPI leaves them out, as JAX's does.
    assert port.call_staged(x, y).sub_spectra_db is None


def test_sub_spectra_off_by_default(scene):
    pipe = CpiPipeline(config_from_dict(SCENE), device="cpu")
    assert pipe.spectrum_sub is None and pipe.sub_spectra_fn is None
    assert pipe(*scene).sub_spectra_db is None


@pytest.mark.parametrize("cfg", [(64, 40_000, 0.1), (64, 200_000, 0.1)],
                         ids=["fs40k", "fs200k"])
def test_too_short_sub_segment_rejected(cfg):
    n_sub, fs, cpi = cfg
    d = _scene_dict(n_sub)
    d["capture"]["fs"] = fs
    d["process"]["data"]["cpi"] = cpi
    d["process"]["ambiguity"].update(delayMax=40, dopplerMin=-100,
                                     dopplerMax=100)
    d["process"]["clutter"]["delayMax"] = 40
    with pytest.raises(ValueError, match="nSub") as port_err:
        CpiPipeline(config_from_dict(d), device="cpu")
    with pytest.raises(ValueError, match="nSub") as jax_err:
        JaxPipeline(jax_config(d), use_pallas=False)
    assert str(port_err.value) == str(jax_err.value)


def test_sub_geometry_pinned_at_production_scale():
    """At the default config's 1.5 Msample CPI a free-running sub analyser
    would give 2005 bins against 2000: the pinned one keeps the bin count,
    offset parity and frequency axis of the full analyser, as JAX's."""
    full = SpectrumAnalyser(1_500_000, 2000.0, device="cpu")
    assert (full.n_spectrum, full.decimation) == (2000, 750)
    assert SpectrumAnalyser(375_000, 2000.0, device="cpu").n_spectrum == 2005
    sub = SpectrumAnalyser(375_000, 2000.0, n_spectrum=2000,
                           offset_even=True, device="cpu")
    jsub = JaxSpectrum(375_000, 2000.0, n_spectrum=2000, offset_even=True)
    assert (sub.n_spectrum, sub.decimation, sub.nfft) == \
        (jsub.n_spectrum, jsub.decimation, jsub.nfft) == (2000, 186, 372_000)
    np.testing.assert_array_equal(sub.frequency_khz, full.frequency_khz)
    np.testing.assert_array_equal(sub._perm.numpy(), jsub._perm)
    np.testing.assert_array_equal(sub._twiddle.numpy(), jsub._twiddle)
    with pytest.raises(ValueError, match="too short"):
        SpectrumAnalyser(100, 2000.0, n_spectrum=2000, device="cpu")


def test_spectrum_batch_axis_equals_rows():
    """``forward`` on a (k, n) batch equals k calls on its rows (the
    counterpart of JAX's ``jax.vmap`` over the analyser)."""
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((3, 9000)) + 1j * rng.standard_normal((3, 9000))
    an = SpectrumAnalyser(9000, 2000.0, n_spectrum=8, offset_even=False,
                          dtype=torch.complex128, device="cpu")
    t = torch.from_numpy(xs)
    batch = an(t)
    assert batch.shape == (3, 8)
    for i in range(3):
        np.testing.assert_allclose(batch[i].numpy(), an(t[i]).numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_sub_analyser_state_carried_across(scene):
    """The sub analyser's constants are part of the pipeline's state under
    JAX's attribute paths (``spectrum_sub.*``): JAX's arrays load into a
    fresh port pipeline and give the same sub spectra."""
    d = _scene_dict(4)
    port = CpiPipeline(config_from_dict(d), dtype=torch.complex128,
                       device="cpu")
    ref = JaxPipeline(jax_config(d), dtype=jnp.complex128, use_pallas=False)
    state = pipeline_state_to_numpy(port)
    assert {"spectrum_sub._twiddle", "spectrum_sub._perm"} <= set(state)
    exported = {}
    for k in state:
        obj = ref
        for part in k.split("."):
            obj = getattr(obj, part)
        exported[k] = np.asarray(obj)
        np.testing.assert_array_equal(state[k], exported[k], err_msg=k)
    fresh = CpiPipeline(config_from_dict(d), dtype=torch.complex128,
                        device="cpu")
    fresh.load_state_dict(pipeline_state_from_numpy(exported, "cpu"))
    x, y = scene
    assert torch.equal(fresh(x, y).sub_spectra_db, port(x, y).sub_spectra_db)
