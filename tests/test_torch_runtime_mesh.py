"""The port's runtime in mesh mode (the sharded pipeline over logical ranks in
one process) against the JAX runtime's mesh mode on the same windows (the
counterparts of tests/test_runtime_mesh.py:40-99), its batch loop, deferral
and flushes, and the CLI's mesh flags in subprocesses on the CPU. The port
runs 8 logical ranks on ``cpu``; JAX its 8 virtual CPU devices."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
from blah2_tpu.runtime.radar import RadarRuntime as JaxRuntime
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline
from blah2_tpu_torch.runtime.radar import RadarRuntime
from blah2_tpu_torch.runtime.spans import KEYS as SPAN_KEYS
from tests.test_torch_runtime import ALL_KEYS, _run_bounded, _spy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config-synthetic.yml")

# The config of tests/test_runtime_mesh.py:16-28.
CFG = {
    "capture": {"fs": 40_000, "fc": 100_000_000, "type": "Synthetic"},
    "process": {
        "data": {"cpi": 0.1, "buffer": 8},
        "ambiguity": {"delayMin": -5, "delayMax": 40,
                      "dopplerMin": -50, "dopplerMax": 50},
        "clutter": {"enable": True, "delayMin": -5, "delayMax": 40},
        "detection": {"enable": True, "pfa": 1e-4, "nGuard": 1,
                      "nTrain": 4, "minDelay": 3, "minDoppler": 10,
                      "nCentroid": 4},
    },
}


def _mesh(shape=(2, 4)):
    return make_radar_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _runtime(**kw):
    return RadarRuntime(config_from_dict(CFG), mesh=kw.pop("mesh", _mesh()),
                        **kw)


def _windows(count, seed=5):
    n = config_from_dict(CFG).n_samples
    out = []
    for k in range(count):
        x, y = synthetic_cpi(n, 40_000, [TargetSpec(12, 30.0, 0.3)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=seed + k)
        out.append((x.astype(np.complex64), y.astype(np.complex64)))
    return out


def _maps(emissions):
    return [json.loads(v) for p, v, _ in emissions if p == "map"]


def test_mesh_runtime_emits_per_cpi_products_as_jax():
    """One batch of two windows through both runtimes' process_cpi_batch:
    deferred (None), then flushed; per CPI the same products as JAX's,
    the map within 0.05 dB (plus the JSON's 0.01 dB rounding), and timing
    docs with JAX's keys and the port's span keys, exactly."""
    port = _runtime()
    ref = JaxRuntime(jax_config(CFG), mesh=jax_mesh(2, 4))
    assert port.cpi_batch == ref.cpi_batch == 2
    wins = _windows(2)
    got = {}
    for name, rt in (("port", port), ("jax", ref)):
        emissions = _spy(rt)
        assert rt.process_cpi_batch(wins, [1000, 1100]) is None
        assert rt._pending_batch is not None
        results = rt._flush_pending_batch()
        assert len(results) == 2 and rt._pending_batch is None
        got[name] = (results, [json.loads(v) for p, v, _ in emissions
                               if p == "timing"])
    for a, b in zip(got["port"][0], got["jax"][0]):
        assert a.keys() == b.keys() == {"iqdata", "map", "detection"}
        mp, mj = json.loads(a["map"]), json.loads(b["map"])
        assert mp["timestamp"] == mj["timestamp"]
        np.testing.assert_allclose(np.array(mp["data"]),
                                   np.array(mj["data"]), atol=0.05 + 0.011)
        assert abs(mp["noisePower"] - mj["noisePower"]) <= 0.011
        dp, dj = json.loads(a["detection"]), json.loads(b["detection"])
        assert len(dp["delay"]) == len(dj["delay"]) >= 1
        np.testing.assert_allclose(dp["delay"], dj["delay"], atol=0.011)
        ip, ij = json.loads(a["iqdata"]), json.loads(b["iqdata"])
        np.testing.assert_allclose(ip["spectrum"], ij["spectrum"],
                                   atol=0.011)
    docs, jdocs = got["port"][1], got["jax"][1]
    assert len(docs) == len(jdocs) == 2
    for a, b in zip(docs, jdocs):
        assert set(a) == set(b) | set(SPAN_KEYS) and ALL_KEYS <= set(a)


def test_mesh_runtime_products_equal_the_pipeline():
    """Undeferred: the emitted maps are the sharded pipeline's on the same
    windows (tests/test_runtime_mesh.py:61-71)."""
    rt = _runtime(defer_fetch=False)
    wins = _windows(2, seed=9)
    results = rt.process_cpi_batch(wins, [5, 6])
    assert len(results) == 2
    sp = ShardedCpiPipeline(config_from_dict(CFG), _mesh())
    ref = sp(*sp.shard_inputs(np.stack([w[0] for w in wins]),
                              np.stack([w[1] for w in wins])))
    for i, emitted in enumerate(results):
        m = json.loads(emitted["map"])
        assert m["timestamp"] == [5, 6][i]
        want = ref.db_map[i].numpy() - float(ref.noise_power[i])
        np.testing.assert_allclose(np.asarray(m["data"]), want, atol=0.006)


@pytest.mark.parametrize("backend", ["ppermute", "pallas"])
def test_mesh_runtime_loop_batches_in_order(backend):
    """run(4) on a 2 × 4 mesh: two batches of two, four product sets of
    each kind, in window order, ``latency`` equal to ``cpi``."""
    rt = _runtime(halo_backend=backend)
    emissions = _spy(rt)
    for x, y in _windows(4, seed=11):
        rt.buffer1.push(x)
        rt.buffer2.push(y)
    _run_bounded(rt, 4)
    assert rt.n_cpis_done == 4 and rt._pending_batch is None
    for product in ("map", "detection", "iqdata", "timing", "timestamp"):
        assert sum(p == product for p, _, _ in emissions) == 4, product
    stamps = [m["timestamp"] for m in _maps(emissions)]
    assert stamps == sorted(stamps)
    for p, v, _ in emissions:
        if p == "timing":
            doc = json.loads(v)
            assert ALL_KEYS <= set(doc) and doc["latency"] == doc["cpi"]


@pytest.mark.parametrize("word", [0, 2])
def test_mesh_runtime_checks_the_halo_error_words(word, monkeypatch):
    """The batch fetch brings the halo kernel's error words of the
    runtime's mesh (faked here: on the CPU no plan takes flags): a set word
    raises before any product of the batch is emitted, a clean one
    emits."""
    from blah2_tpu_torch.ops.halo import halo_permute

    rt = _runtime(halo_backend="pallas")
    emissions = _spy(rt)
    monkeypatch.setattr(halo_permute, "error_words", lambda mesh=None: [
        torch.tensor([word if mesh is rt.sharded.mesh else 0])])
    assert rt.process_cpi_batch(_windows(2), [1, 2]) is None
    if word:
        with pytest.raises(RuntimeError, match="a wait timed out"):
            rt._flush_pending_batch()
        assert not _maps(emissions)
    else:
        assert len(rt._flush_pending_batch()) == 2
        assert len(_maps(emissions)) == 2


def test_mesh_runtime_windows_match_jax_loop():
    """Both runtimes' loops over the same four windows in their rings emit
    maps that agree CPI by CPI."""
    maps = {}
    for name, rt in (("port", _runtime()),
                     ("jax", JaxRuntime(jax_config(CFG),
                                        mesh=jax_mesh(2, 4)))):
        emissions = _spy(rt)
        for x, y in _windows(4, seed=13):
            rt.buffer1.push(x)
            rt.buffer2.push(y)
        _run_bounded(rt, 4)
        maps[name] = _maps(emissions)
    assert len(maps["port"]) == len(maps["jax"]) == 4
    for a, b in zip(maps["port"], maps["jax"]):
        np.testing.assert_allclose(np.array(a["data"]), np.array(b["data"]),
                                   atol=0.05 + 0.011)


def test_mesh_capture_stall_flushes_the_pending_batch():
    """Two batches in the rings and no capture: the second batch, deferred
    behind a third that never comes, is emitted when extraction times out;
    the third arrives later and drains at run(n)'s end."""
    rt = _runtime()
    emissions = _spy(rt)
    wins = _windows(6, seed=17)
    for x, y in wins[:4]:
        rt.buffer1.push(x)
        rt.buffer2.push(y)
    t = threading.Thread(target=rt.run, kwargs={"n_cpis": 6, "quiet": True},
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while len(_maps(emissions)) < 4:
            assert time.monotonic() < deadline, "stall flush never came"
            time.sleep(0.05)
        assert rt.n_cpis_done == 4
        for x, y in wins[4:]:
            rt.buffer1.push(x)
            rt.buffer2.push(y)
        t.join(60.0)
        assert not t.is_alive()
    finally:
        rt.stop()
        t.join(10.0)
    assert len(_maps(emissions)) == 6
    assert sum(p == "timestamp" for p, _, _ in emissions) == 6


def test_mesh_transport_recycle_flushes_the_batch():
    """recycle_transport in mesh mode flushes the deferred batch (nothing
    is torn down on a card attached to its host); the loop keeps
    producing, in order."""
    rt = _runtime(staged_sample_every=0, recycle_every_cpis=2)
    emissions = _spy(rt)
    for x, y in _windows(4, seed=19):
        rt.buffer1.push(x)
        rt.buffer2.push(y)
    sharded = rt.sharded
    _run_bounded(rt, 4)
    assert rt.sharded is sharded
    stamps = [m["timestamp"] for m in _maps(emissions)]
    assert len(stamps) == 4 and stamps == sorted(stamps)


def test_mesh_runtime_row_shard_options():
    for row_shard, want in ((True, True), (False, False)):
        assert _runtime(row_shard=row_shard).sharded._row_shard is want
    rt = _runtime(row_shard="calibrate", mesh=_mesh((1, 4)))
    assert isinstance(rt.sharded._row_shard, bool) and rt.cpi_batch == 1
    assert rt.device == torch.device("cpu")


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", "--config",
         CONFIG, "--no-api", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [[], ["--halo-backend", "pallas",
                                        "--row-shard", "calibrate"]],
                         ids=["default", "pallas-calibrate"])
def test_cli_mesh_on_the_cpu(extra):
    proc = _cli("--mesh", "2x4", "--device", "cpu", "--cpis", "4", *extra)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("(batch of 2") == 2
    if extra:
        assert "row_shard calibration" in proc.stdout


def test_cli_mesh_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    proc = _cli("--mesh", "1x4", "--cpis", "1")
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    proc = _cli("--mesh", "1by4", "--device", "cpu", "--cpis", "1")
    assert proc.returncode == 2 and "--mesh must look like" in proc.stderr
