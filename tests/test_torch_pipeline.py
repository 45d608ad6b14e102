"""The port's whole ``CpiPipeline`` against the JAX ``CpiPipeline`` and the
frozen golden oracle (tests/golden/), its entries against each other, and
its state constants against the JAX pipeline's."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.dsp.pipeline import CpiPipeline as JaxPipeline
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.convert import (pipeline_state_from_numpy,
                                     pipeline_state_to_numpy)
from blah2_tpu_torch.dsp.pipeline import CpiPipeline, entry
from blah2_tpu_torch.ops import detect as tdetect
from blah2_tpu_torch.ops.pack12 import pack12_planes, pack12_quads

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")

# The scene of the verify recipe: fs 200 kHz, CPI 0.1 s, delay −10..100.
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


@pytest.fixture(scope="module")
def scene():
    x, y = synthetic_cpi(20_000, 200_000,
                         [TargetSpec(40, -77.0, 0.05),
                          TargetSpec(61, 112.0, 0.03)],
                         clutter_amplitude=3.0, noise_amplitude=1e-3, seed=7)
    return x, y


def _valid(det, k):
    v = np.asarray(det.valid)
    return np.asarray(getattr(det, k))[v]


def test_pipeline_complex128_matches_jax(scene):
    x, y = scene
    port = CpiPipeline(config_from_dict(SCENE), dtype=torch.complex128,
                       device="cpu")
    assert port.fused_detector is None  # "auto" on the CPU: unfused chain
    ref = JaxPipeline(jax_config(SCENE), dtype=jnp.complex128,
                      use_pallas=False)
    out, jout = port(x, y), ref(x, y)
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.spectrum_db.numpy(),
                               np.asarray(jout.spectrum_db), atol=1e-6)
    assert abs(float(out.noise_power) - float(jout.noise_power)) < 1e-6
    assert abs(float(out.max_power) - float(jout.max_power)) < 1e-6
    assert bool(out.clutter_ok) and bool(jout.clutter_ok)
    d, jd = out.detections, jout.detections
    assert _valid(jd, "row").size == 2
    for k in ("row", "col"):
        np.testing.assert_array_equal(_valid(d, k), _valid(jd, k))
    for k in ("delay", "doppler", "snr"):
        np.testing.assert_allclose(_valid(d, k), _valid(jd, k), atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_complex64_matches_jax(scene, fused):
    """fused_detect on and off against use_pallas on (interpret) and off.
    The maps come from two FFT libraries in float32, which differ most in
    the deep cells the clutter filter leaves: the map is held to the golden
    complex64 bound; noise, detections and SNR to the fused-detector
    bounds."""
    x, y = scene
    port = CpiPipeline(config_from_dict(SCENE), fused_detect=fused,
                       device="cpu")
    assert (port.fused_detector is not None) == fused
    ref = JaxPipeline(jax_config(SCENE), use_pallas=fused)
    out = port(x.astype(np.complex64), y.astype(np.complex64))
    jout = ref(x.astype(np.complex64), y.astype(np.complex64))
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


# -- the frozen golden recording ---------------------------------------------

@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(GOLDEN_DIR, "golden.json")) as f:
        doc = json.load(f)
    doc["cmap"] = np.load(os.path.join(GOLDEN_DIR, "oracle_map.npy"))
    raw = np.fromfile(os.path.join(GOLDEN_DIR, "golden_scene.rspduo.iq"),
                      dtype=np.int16)
    doc["quads"] = raw[: raw.size // 4 * 4].reshape(-1, 4)
    return doc


def _golden_config(g):
    amb, clu, det = g["ambiguity"], g["clutter"], g["detection"]
    return config_from_dict({
        "capture": {"fs": g["scene"]["fs"], "fc": 204_640_000},
        "process": {
            "data": {"cpi": g["scene"]["cpi_s"], "buffer": 2},
            "ambiguity": {"delayMin": amb["delay_min"],
                          "delayMax": amb["delay_max"],
                          "dopplerMin": amb["doppler_min"],
                          "dopplerMax": amb["doppler_max"]},
            "clutter": {"enable": True, "delayMin": clu["delay_min"],
                        "delayMax": clu["delay_max"]},
            "detection": {"enable": True, "pfa": det["pfa"],
                          "nGuard": det["n_guard"], "nTrain": det["n_train"],
                          "minDelay": det["min_delay"],
                          "minDoppler": det["min_doppler"],
                          "nCentroid": det["n_centroid"]},
        },
    })


def test_golden_complex128_parity(golden):
    """The bounds of tests/test_golden_parity.py:94-151, through the port."""
    cfg = _golden_config(golden)
    n = cfg.n_samples
    out = CpiPipeline(cfg, dtype=torch.complex128, device="cpu").call_quad(
        golden["quads"][:n])
    ref_db = 10 * np.log10(np.abs(golden["cmap"]))
    db = out.db_map.numpy()
    assert db.shape == (golden["rows"], golden["cols"])
    np.testing.assert_allclose(db, ref_db, rtol=0, atol=1e-6)
    assert golden["clutter_ok"] == 1 and bool(out.clutter_ok)
    assert abs(float(out.noise_power) - golden["noise_power_db"]) < 1e-6
    assert abs(float(out.max_power) - golden["max_power_db"]) < 1e-6
    d = out.detections
    got = np.array(sorted(zip(_valid(d, "delay"), _valid(d, "doppler"),
                              _valid(d, "snr"))))
    want = np.array(sorted(map(tuple, golden["interpolated"])))
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=1e-4)
    assert (got[:, 2] >= want[:, 2] - 1e-4).all()


@pytest.mark.parametrize("fused", [False, True])
def test_golden_complex64_bounds(golden, fused):
    """The bounds of tests/test_golden_parity.py:154-170."""
    cfg = _golden_config(golden)
    out = CpiPipeline(cfg, fused_detect=fused, device="cpu").call_quad(
        golden["quads"][:cfg.n_samples])
    ref_db = 10 * np.log10(np.abs(golden["cmap"]))
    assert float(np.abs(out.db_map.numpy() - ref_db).max()) < 0.05
    assert abs(float(out.noise_power) - golden["noise_power_db"]) < 1e-3
    assert abs(float(out.max_power) - golden["max_power_db"]) < 1e-3


# -- entries ---------------------------------------------------------------

def _assert_same(a, b):
    for k in ("db_map", "noise_power", "max_power", "spectrum_db",
              "clutter_ok"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in a.detections._fields:
        assert torch.equal(getattr(a.detections, k),
                           getattr(b.detections, k)), k


@pytest.mark.parametrize("fused", [False, True])
def test_entries_agree(scene, fused):
    """call_quad, call_quad12, call_chunks and __call__ on the same int16
    samples give identical products."""
    x, y = scene
    quads = np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                      axis=1) * 150), -2048, 2047
                    ).astype(np.int16)
    xp, yp = quads[:, :2], quads[:, 2:]
    pipe = CpiPipeline(config_from_dict(SCENE), fused_detect=fused,
                       device="cpu")
    base = pipe(xp, yp)
    _assert_same(base, pipe(torch.from_numpy(xp), torch.from_numpy(yp)))
    _assert_same(base, pipe(xp[:, 0] + 1j * xp[:, 1].astype(np.float32),
                            yp[:, 0] + 1j * yp[:, 1].astype(np.float32)))
    _assert_same(base, pipe.call_quad(quads))
    _assert_same(base, pipe.call_quad(torch.from_numpy(quads)))
    _assert_same(base, pipe.call_quad12(pack12_quads(quads)))
    c = 4
    split = np.split(np.arange(quads.shape[0]), c)
    _assert_same(base, pipe.call_chunks([xp[i] for i in split],
                                        [yp[i] for i in split]))
    _assert_same(base, pipe.call_chunks([pack12_planes(xp[i]) for i in split],
                                        [pack12_planes(yp[i]) for i in split]))
    assert int(base.detections.count) >= 1


def test_cross_map_is_the_pipelines_map(scene):
    """decode_quad12 and cross_map are the stages call_quad12 runs: their
    map gives call_quad12's dB map and clutter flag exactly."""
    from blah2_tpu_torch.dsp.ambiguity import map_metrics

    x, y = scene
    quads = np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                      axis=1) * 150), -2048, 2047
                    ).astype(np.int16)
    pipe = CpiPipeline(config_from_dict(SCENE), fused_detect=False,
                       device="cpu")
    packed = pack12_quads(quads)
    z, ok = pipe.cross_map(*pipe.decode_quad12(packed))
    out = pipe.call_quad12(packed)
    assert z.shape == out.db_map.shape and z.dtype == torch.complex64
    assert torch.equal(map_metrics(z)[0], out.db_map)
    assert torch.equal(ok, out.clutter_ok)


def test_pipeline_switches(scene):
    x, y = scene
    d = json.loads(json.dumps(SCENE))
    d["process"]["detection"]["enable"] = False
    d["process"]["clutter"]["enable"] = False
    out = CpiPipeline(config_from_dict(d), device="cpu")(x, y)
    assert out.detections.valid.numel() == 0 and bool(out.clutter_ok)
    jout = JaxPipeline(jax_config(d), use_pallas=False)(
        x.astype(np.complex64), y.astype(np.complex64))
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               atol=2e-3)
    assert out.sub_spectra_db is None
    d["process"]["spectrum"] = {"nSub": 2}
    out = CpiPipeline(config_from_dict(d), device="cpu")(x, y)
    jout = JaxPipeline(jax_config(d), use_pallas=False)(
        x.astype(np.complex64), y.astype(np.complex64))
    assert out.sub_spectra_db.shape == (2, out.spectrum_db.shape[0])
    np.testing.assert_allclose(out.sub_spectra_db.numpy(),
                               np.asarray(jout.sub_spectra_db), atol=2e-3)


def test_cpu_pipeline_never_launches_the_kernel(scene):
    x, y = scene
    before = tdetect.detect.launches
    CpiPipeline(config_from_dict(SCENE), fused_detect=True, device="cpu")(x, y)
    assert tdetect.detect.launches == before


# -- state carried across -----------------------------------------------------

def _jax_attr(pipe, path):
    obj = pipe
    for part in path.split("."):
        obj = getattr(obj, part)
    return np.asarray(obj)


@pytest.mark.parametrize("dtypes", [(torch.complex64, jnp.complex64),
                                    (torch.complex128, jnp.complex128)],
                         ids=["c64", "c128"])
def test_state_matches_jax_and_round_trips(dtypes):
    dt, jdt = dtypes
    d = json.loads(json.dumps(SCENE))
    d["process"]["ambiguity"]["dopplerMin"] = -150  # off-centre: a ramp
    port = CpiPipeline(config_from_dict(d), dtype=dt, fused_detect=True,
                       device="cpu")
    ref = JaxPipeline(jax_config(d), dtype=jdt, use_pallas=True)
    state = pipeline_state_to_numpy(port)
    assert {"ambiguity._doppler_dft", "ambiguity._ramp",
            "ambiguity.delay_axis", "ambiguity.doppler_axis",
            "spectrum._twiddle", "spectrum._perm", "cfar._thresh_scale",
            "cfar._row_ok", "cfar._col_ok", "fused_detector._scale",
            "fused_detector._cell_ok", "fused_detector._delay_f32",
            "fused_detector._doppler_f32"} <= set(state)
    exported = {k: _jax_attr(ref, k) for k in state}
    for k, v in state.items():
        np.testing.assert_array_equal(v, exported[k], err_msg=k)

    # JAX's constants loaded into a fresh port pipeline give the same
    # buffers, dtypes and products.
    fresh = CpiPipeline(config_from_dict(d), dtype=dt, fused_detect=True,
                        device="cpu")
    fresh.load_state_dict(pipeline_state_from_numpy(exported, "cpu"))
    for k, v in fresh.state_dict().items():
        assert v.dtype == port.state_dict()[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    x, y = synthetic_cpi(20_000, 200_000, [TargetSpec(30, 50.0, 0.1)],
                         noise_amplitude=1e-3, seed=1)
    _assert_same(port(x, y), fresh(x, y))


def test_entry_default_config():
    pipe, (x, y) = entry(device="cpu")
    assert pipe.n_samples == 1_500_000 and x.shape == (1_500_000, 2)
    amb = pipe.ambiguity
    assert (amb.n_doppler_bins, amb.n_delay_bins, amb.n_corr) == (301, 411,
                                                                   4983)
    assert pipe.clutter.n_seg == 96 and pipe.clutter.nfft_seg == 16200
    assert (pipe.spectrum.n_spectrum, pipe.spectrum.decimation) == (2000, 750)
    assert (pipe.fused_detector, pipe.cfar is not None) == (None, True)
