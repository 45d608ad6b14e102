"""The port's sharded CPI pipeline (``blah2_tpu_torch/parallel/sharded.py``)
against the JAX ``ShardedCpiPipeline`` on the virtual 8-device CPU mesh,
against its own single-device linear mode, its constants against JAX's,
and its collective byte counts against the analytic model that
tests/test_collective_bytes.py pins for JAX. The port runs 8 logical ranks
on ``cpu``."""

from __future__ import annotations

import copy
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.parallel import commstats
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
from blah2_tpu.parallel.sharded import ShardedCpiPipeline as JaxSharded
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.convert import (pipeline_state_from_numpy,
                                     pipeline_state_to_numpy)
from blah2_tpu_torch.dsp.pipeline import CpiPipeline
from blah2_tpu_torch.ops import detect as tdetect
from blah2_tpu_torch.parallel import collectives as coll
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import (ShardedCpiPipeline,
                                              calibrate_row_shard,
                                              pick_local_segments)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8

# The config of tests/test_sharded.py:15-27.
SCENE = {
    "capture": {"fs": 80_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.2, "buffer": 2},
        "ambiguity": {"delayMin": -5, "delayMax": 60,
                      "dopplerMin": -100, "dopplerMax": 100},
        "clutter": {"enable": True, "delayMin": -5, "delayMax": 30},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                      "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                      "nCentroid": 6},
    },
}


def _scene(**changes):
    d = copy.deepcopy(SCENE)
    for path, value in changes.items():
        node = d
        keys = path.split("__")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = value
    return d


def _batch(d, b=2, seed=0):
    cfg = config_from_dict(d)
    xs, ys = [], []
    for k in range(b):
        x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                             [TargetSpec(20, -44.0, 0.1)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=seed + k)
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


def _mesh(shape):
    return make_radar_mesh(*shape, devices=CPU8)


def _det_set(det, i):
    v = np.asarray(det.valid)[i]
    return set(zip(np.asarray(det.row)[i][v].tolist(),
                   np.asarray(det.col)[i][v].tolist()))


def _run(pipe, xb, yb):
    return pipe(*pipe.shard_inputs(xb, yb))


@pytest.mark.parametrize("dtype", ["c128", "c64"])
@pytest.mark.parametrize("row_shard", [True, False])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1)],
                         ids=["1x8", "2x4", "8x1"])
def test_sharded_matches_jax(shape, row_shard, dtype):
    tdt, jdt = {"c128": (torch.complex128, jnp.complex128),
                "c64": (torch.complex64, jnp.complex64)}[dtype]
    xb, yb = _batch(SCENE, b=max(2, shape[0]))
    port = ShardedCpiPipeline(config_from_dict(SCENE), _mesh(shape),
                              dtype=tdt, row_shard=row_shard)
    ref = JaxSharded(jax_config(SCENE), jax_mesh(*shape), dtype=jdt,
                     row_shard=row_shard)
    assert port._row_shard is row_shard
    assert (port.n_pad, port.block_len, port.nd_pad, port.nd_rows_pad,
            port.n_seg_local, port.seg_len) == \
        (ref.n_pad, ref.block_len, ref.nd_pad, ref.nd_rows_pad,
         ref.n_seg_local, ref.seg_len)
    out, jout = _run(port, xb, yb), _run(ref, xb, yb)
    db, jdb = out.db_map.numpy(), np.asarray(jout.db_map)
    assert db.shape == jdb.shape == (xb.shape[0], 41, 66)
    noise, jnoise = out.noise_power.numpy(), np.asarray(jout.noise_power)
    maxp, jmaxp = out.max_power.numpy(), np.asarray(jout.max_power)
    if dtype == "c128":
        np.testing.assert_allclose(db, jdb, rtol=0, atol=1e-6)
        np.testing.assert_allclose(noise, jnoise, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out.spectrum_db.numpy(),
                                   np.asarray(jout.spectrum_db), atol=1e-6)
        for i in range(xb.shape[0]):
            assert _det_set(out.detections, i) == \
                _det_set(jout.detections, i)
    else:
        np.testing.assert_allclose(db, jdb, rtol=0, atol=0.05)
        np.testing.assert_allclose(noise, jnoise, rtol=0, atol=1e-3)
        np.testing.assert_allclose(maxp, jmaxp, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out.clutter_ok.numpy(),
                                  np.asarray(jout.clutter_ok))


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1), (1, 2)],
                         ids=["1x8", "2x4", "8x1", "1x2-segments"])
def test_sharded_matches_single_device_linear(shape):
    """At complex128 the sharded pipeline is the single-device pipeline in
    linear clutter mode. The 1 x 2 case runs a 0.5 s CPI at 200 kHz, whose
    rank blocks split into several overlap-save segments."""
    d = SCENE if shape != (1, 2) else _scene(
        capture__fs=200_000, process__data__cpi=0.5)
    mesh = make_radar_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    xb, yb = _batch(d, b=max(2, shape[0]), seed=3)
    sp = ShardedCpiPipeline(config_from_dict(d), mesh,
                            dtype=torch.complex128)
    if shape == (1, 2):
        assert sp.n_seg_local > 1
    out = _run(sp, xb, yb)
    single = CpiPipeline(config_from_dict(d), dtype=torch.complex128,
                         clutter_mode="linear", device="cpu")
    for i in range(xb.shape[0]):
        ref = single(xb[i], yb[i])
        np.testing.assert_allclose(out.db_map[i].numpy(),
                                   ref.db_map.numpy(), rtol=0, atol=1e-6)
        assert abs(float(out.noise_power[i]) - float(ref.noise_power)) < 1e-8
        np.testing.assert_allclose(out.spectrum_db[i].numpy(),
                                   ref.spectrum_db.numpy(), atol=1e-6)
        v, rv = out.detections.valid[i], ref.detections.valid
        assert set(zip(out.detections.row[i][v].tolist(),
                       out.detections.col[i][v].tolist())) == \
            set(zip(ref.detections.row[rv].tolist(),
                    ref.detections.col[rv].tolist()))
        assert bool(out.clutter_ok[i]) == bool(ref.clutter_ok)


def test_pallas_backend_equals_ppermute_and_fused_detect():
    """The halo payloads are the same on both backends, so the products
    are equal; the fused detector on the batch gives the unfused chain's
    detections."""
    mesh = _mesh((2, 4))
    xb, yb = _batch(SCENE, b=2, seed=9)
    outs = {}
    for backend in ("ppermute", "pallas"):
        for fused in (False, True):
            sp = ShardedCpiPipeline(config_from_dict(SCENE), mesh,
                                    halo_backend=backend,
                                    use_fused_detect=fused)
            outs[backend, fused] = _run(sp, xb, yb)
    for fused in (False, True):
        a, b = outs["ppermute", fused], outs["pallas", fused]
        assert torch.equal(a.db_map, b.db_map)
        for k in a.detections._fields:
            assert torch.equal(getattr(a.detections, k),
                               getattr(b.detections, k)), k
    a, b = outs["ppermute", False], outs["ppermute", True]
    np.testing.assert_allclose(a.db_map.numpy(), b.db_map.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.noise_power.numpy(), b.noise_power.numpy(),
                               atol=1e-4)
    for i in range(2):
        assert _det_set(a.detections, i) == _det_set(b.detections, i)
        va, vb = a.detections.valid[i], b.detections.valid[i]
        np.testing.assert_allclose(a.detections.snr[i][va].numpy(),
                                   b.detections.snr[i][vb].numpy(), atol=1e-3)
    assert b.detections.row.shape == (2, 128)


def test_sharded_target_found_and_cpu_never_launches():
    mesh = _mesh((1, 8))
    xb, yb = _batch(SCENE, b=2, seed=5)
    before = tdetect.detect.launches
    sp = ShardedCpiPipeline(config_from_dict(SCENE), mesh,
                            halo_backend="pallas", use_fused_detect=True)
    out = _run(sp, xb, yb)
    assert tdetect.detect.launches == before
    for i in range(2):
        v = out.detections.valid[i]
        assert bool(torch.any((out.detections.delay[i][v] - 20).abs() < 1.0))


def test_sharded_switches_and_unported_filters():
    mesh = _mesh((2, 4))
    xb, yb = _batch(SCENE, b=2)
    out = _run(ShardedCpiPipeline(
        config_from_dict(_scene(process__detection__enable=False)), mesh),
        xb, yb)
    assert out.detections.delay.shape == (2, 0)
    assert out.detections.count.shape == (2,)
    out = _run(ShardedCpiPipeline(
        config_from_dict(_scene(process__clutter__enable=False)), mesh),
        xb, yb)
    assert bool(out.clutter_ok.all())
    for filt in ("eca-b", "nlms"):
        sp = ShardedCpiPipeline(config_from_dict(
            _scene(process__clutter__filter=filt)), mesh)
        assert sp.clutter_kind == filt
    sp = ShardedCpiPipeline(config_from_dict(
        _scene(process__spectrum={"nSub": 2})), mesh)
    assert sp.spectrum_sub is not None
    assert _run(sp, xb, yb).sub_spectra_db.shape == \
        (2, 2, sp.spectrum.n_spectrum)
    with pytest.raises(ValueError, match="nSub"):
        ShardedCpiPipeline(config_from_dict(
            _scene(process__spectrum={"nSub": 20})), mesh)
    with pytest.warns(UserWarning, match="falling back"):
        sp = ShardedCpiPipeline(config_from_dict(
            _scene(process__clutter__filter="lms")), mesh)
    assert sp.clutter_kind == "wiener"
    with pytest.raises(ValueError, match="backend"):
        ShardedCpiPipeline(config_from_dict(SCENE), mesh, halo_backend="x")
    sp = ShardedCpiPipeline(config_from_dict(SCENE), mesh)
    with pytest.raises(ValueError, match="divisible"):
        sp.shard_inputs(xb[:1], yb[:1])


def test_pick_local_segments_matches_jax():
    from blah2_tpu.parallel.sharded import pick_local_segments as jax_pick

    for block_len, n_lags in [(378_708, 410), (752_433, 410), (2340, 35),
                              (50_000, 35), (1_514_832, 410)]:
        assert pick_local_segments(block_len, n_lags) == \
            jax_pick(block_len, n_lags)
    assert pick_local_segments(378_708, 410) == 22


def test_default_config_geometry():
    """The default config's mesh geometry (1 x 4 and 2 x 2), as the JAX
    pipeline derives it; the segment FFT size is the port's own pick."""
    from blah2_tpu_torch.config import Config

    for shape, want in [((1, 4), (304, 1_514_832, 378_708, 22, 17_214,
                                  18_000)),
                        ((2, 2), (302, 1_504_866, 752_433, 33, 22_801,
                                  23_328))]:
        sp = ShardedCpiPipeline(Config(), make_radar_mesh(
            *shape, devices=["cpu"] * 4))
        assert (sp.nd_pad, sp.n_pad, sp.block_len, sp.n_seg_local,
                sp.seg_len, sp.nfft_seg) == want
        assert sp._row_shard


def test_fold_partial_sums_to_the_spectrum():
    """The per-rank folds of a CPI, summed, give the full-CPI spectrum."""
    from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser

    rng = np.random.default_rng(4)
    n, pad_to, ranks = 16_000, 16_400, 4
    x = torch.from_numpy(rng.standard_normal(pad_to)
                         + 1j * rng.standard_normal(pad_to))
    x[n:] = 0
    sa = SpectrumAnalyser(n, 2000.0, 204.64e6, dtype=torch.complex128,
                          device="cpu")
    tw = sa.twiddle_padded(pad_to)
    blk = pad_to // ranks
    folded = sum(sa.fold_partial(x[None, r * blk:(r + 1) * blk], r * blk, tw)
                 for r in range(ranks))
    np.testing.assert_allclose(sa.finish(folded)[0].numpy(), sa(x).numpy(),
                               atol=1e-9)


def _jax_attr(pipe, path):
    obj = pipe
    for part in path.split("."):
        obj = getattr(obj, part)
    return np.asarray(obj)


@pytest.mark.parametrize("dtypes", [(torch.complex64, jnp.complex64),
                                    (torch.complex128, jnp.complex128)],
                         ids=["c64", "c128"])
def test_sharded_state_matches_jax_and_round_trips(dtypes):
    """convert.py hands the sharded pipeline's derived constants across
    under the JAX attribute paths."""
    dt, jdt = dtypes
    d = _scene(process__ambiguity__dopplerMin=-60)  # off-centre: a ramp
    mesh = _mesh((2, 4))
    port = ShardedCpiPipeline(config_from_dict(d), mesh, dtype=dt,
                              use_fused_detect=True)
    ref = JaxSharded(jax_config(d), jax_mesh(2, 4), dtype=jdt,
                     use_pallas_detect=True)
    state = pipeline_state_to_numpy(port)
    assert {"_w_pad", "_ramp_pad", "_spec_tw_pad", "ambiguity._doppler_dft",
            "spectrum._twiddle", "fused_detector._scale",
            "cfar._thresh_scale"} <= set(state)
    exported = {k: _jax_attr(ref, k) for k in state}
    for k, v in state.items():
        np.testing.assert_array_equal(v, exported[k], err_msg=k)
    fresh = ShardedCpiPipeline(config_from_dict(d), mesh, dtype=dt,
                               use_fused_detect=True)
    fresh.load_state_dict(pipeline_state_from_numpy(exported, "cpu"))
    for k, v in fresh.state_dict().items():
        assert v.dtype == port.state_dict()[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    xb, yb = _batch(d, b=2, seed=1)
    a, b = _run(port, xb, yb), _run(fresh, xb, yb)
    assert torch.equal(a.db_map, b.db_map)


# -- collective bytes against the analytic model ------------------------------

def _tiny_scene(**changes):
    """The config of tests/test_collective_bytes.py:34-47."""
    d = json.loads(json.dumps({
        "capture": {"fs": 40_000, "fc": 204_640_000},
        "process": {
            "data": {"cpi": 0.1, "buffer": 2},
            "ambiguity": {"delayMin": -5, "delayMax": 40,
                          "dopplerMin": -200, "dopplerMax": 200},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 20,
                        "filter": "wiener", "nBatches": 8},
            "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                          "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                          "nCentroid": 6},
        },
    }))
    d["process"]["clutter"].update(changes)
    return d


@pytest.mark.parametrize("row_shard", [True, False])
def test_collective_bytes_match_model(row_shard):
    """One step on a 2 x 4 mesh, two CPIs: three (nb−1) halos and one
    |delayMin| shift per rank, 2·nfft_seg complex64 of clutter-spectrum
    psum, the Doppler psum_scatter (or psum) and an n_spectrum fold psum,
    all per local CPI; row-sharded, the detection's float32 dB-sum psum and
    dB-max pmax and the all-gathers of the float32 dB rows and the one-byte
    mask (no gather of the complex map); nothing else."""
    d = _tiny_scene()
    mesh = _mesh((2, 4))
    sp = ShardedCpiPipeline(config_from_dict(d), mesh, row_shard=row_shard)
    x = np.zeros((2, sp.n_samples), np.complex64)
    xp, yp = sp.shard_inputs(x, x)
    with coll.count_bytes(mesh) as ops:
        sp(xp, yp)
    b_local, c64, f32 = 2 // mesh.shape["cpi"], 8, 4
    h, s = sp.nb - 1, abs(sp.clutter_delay_min)
    n_p = mesh.shape["pulse"]
    nd, n_delay = sp.ambiguity.n_doppler_bins, sp.ambiguity.n_delay_bins
    permutes = sorted(op.bytes_per_rank for op in ops if op.kind == "permute")
    assert permutes == sorted([b_local * s * c64] + [b_local * h * c64] * 3)
    psums = sorted(op.bytes_per_rank for op in ops if op.kind == "psum")
    doppler = b_local * nd * n_delay * c64
    want = [b_local * sp.nfft_seg * c64] * 2 + \
        [b_local * sp.spectrum.n_spectrum * c64] + \
        ([b_local * f32] if row_shard else [doppler])
    assert psums == sorted(want)
    scatter = [op.bytes_per_rank for op in ops if op.kind == "psum_scatter"]
    assert scatter == ([b_local * (sp.nd_rows_pad // n_p) * n_delay * c64]
                       if row_shard else [])
    pmaxes = [op.bytes_per_rank for op in ops if op.kind == "pmax"]
    assert pmaxes == ([b_local * f32] if row_shard else [])
    gathers = sorted(op.bytes_per_rank for op in ops
                     if op.kind == "all_gather")
    cells = b_local * sp.nd_rows_pad * n_delay
    assert gathers == (sorted([cells * f32, cells * 1]) if row_shard else [])
    assert {op.dtype for op in ops if op.kind == "all_gather"} == \
        ({torch.float32, torch.bool} if row_shard else set())
    assert len(ops) == (12 if row_shard else 8)
    # The same permutes and Doppler reduction as JAX's compiled program;
    # row-sharded, its two scalar all-reduces (the dB sum and max) and its
    # all-gathers of the f32 dB rows and the pred mask, and no all-gather
    # of the complex map (its complex all-gather is the spectrum fold's).
    ref = JaxSharded(jax_config(d), jax_mesh(2, 4), row_shard=row_shard)
    jops = commstats.collect(ref._fn, *ref.shard_inputs(x, x))
    assert sorted(op.bytes_per_rank for op in jops
                  if op.kind == "collective-permute") == permutes
    if row_shard:
        assert [op.bytes_per_rank for op in jops
                if op.kind == "reduce-scatter"] == scatter
        scalars = sorted(op.bytes_per_rank for op in jops
                         if op.kind == "all-reduce"
                         and all(t.startswith("f32[") for t in op.shapes))
        assert scalars == sorted([b_local * f32] + pmaxes)
        assert sorted(op.bytes_per_rank for op in jops
                      if op.kind == "all-gather"
                      and op.shapes[0].startswith(("f32[", "pred["))) \
            == gathers
        assert [t for op in jops if op.kind == "all-gather"
                for t in op.shapes if t.startswith("c64[")] == \
            [f"c64[2,{sp.spectrum.n_spectrum}]"]
    # The pallas backend moves the same payloads as planes.
    sp.halo_backend = "pallas"
    with coll.count_bytes(mesh) as ops2:
        sp(xp, yp)
    assert sorted(op.bytes_per_rank for op in ops2
                  if op.kind == "permute") == permutes


def test_calibrate_row_shard_picks_measured_winner():
    cal = calibrate_row_shard(config_from_dict(SCENE), _mesh((2, 4)),
                              n_trials=2)
    assert cal["ms_on"] > 0.0 and cal["ms_off"] > 0.0
    assert cal["row_shard"] == (cal["ms_on"] <= cal["ms_off"])
    assert cal["pipeline"]._row_shard is cal["row_shard"]


def test_sharded_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedCpiPipeline(config_from_dict(SCENE), make_radar_mesh())
