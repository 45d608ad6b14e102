"""The plain reference against the port at a size the CPU holds, its
tracker against the port's, and the control, which ``correct`` must
reject."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, judge, manifest
from benchmark.reference import dsp
from benchmark.reference.tracker import MofN
from benchmark.tests.conftest import tiny_config, tiny_traffic

ROOT = manifest.ROOT


def _scene(tmp_path, config="rspduo", mix="replay"):
    import yaml

    from benchmark import scene

    path = tiny_config(config, str(tmp_path / "c.yml"))
    with open(path) as f:
        doc = yaml.safe_load(f)
    doc.pop("bench")
    g = dsp.geometry(doc)
    return doc, g, scene.make(tiny_traffic(mix)["scene"], g, 1234567890123,
                              "cpu")


def test_reference_matches_the_ports_complex128_path(tmp_path):
    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    doc, g, sc = _scene(tmp_path)
    pipe = CpiPipeline(config_from_dict(doc), dtype=torch.complex128,
                       device="cpu")
    for x, y in zip(sc.x, sc.y):
        ref = dsp.products(x, y, g)
        out = pipe(x, y)
        rel = out.db_map.numpy() - float(out.noise_power)
        assert np.abs(rel - ref.db_rel).max() < 1e-8
        assert float(out.noise_power) == pytest.approx(ref.noise, abs=1e-9)
        v = out.detections.valid.numpy()
        got = np.stack([out.detections.delay.numpy()[v],
                        out.detections.doppler.numpy()[v],
                        out.detections.snr.numpy()[v]], axis=1)
        assert len(ref.detections) >= 2
        np.testing.assert_allclose(got, ref.detections, atol=1e-6)


def test_the_ports_complex64_path_reads_well_inside_the_limits(tmp_path):
    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    doc, g, sc = _scene(tmp_path)
    pipe = CpiPipeline(config_from_dict(doc), device="cpu")
    for x, y in zip(sc.x, sc.y):
        ref = dsp.products(x, y, g)
        out = pipe(x, y)
        noise = float(out.noise_power)
        doc_map = {"noisePower": round(noise, 2),
                   "maxPower": round(float(out.max_power), 2),
                   "data": np.round(out.db_map.numpy() - noise, 2)}
        v = out.detections.valid.numpy()
        dets = np.stack([out.detections.delay.numpy()[v],
                         out.detections.doppler.numpy()[v],
                         out.detections.snr.numpy()[v]], axis=1)
        assert judge.map_gap(doc_map, ref, g) < 0.02
        served = np.stack([np.round(dets[:, 0] * g.km_per_bin, 2)
                           / g.km_per_bin, np.round(dets[:, 1], 2),
                           np.round(dets[:, 2], 2)], axis=1)
        gaps = judge.detection_gaps(served, ref, g)
        assert gaps["detection_gap_db"] < 0.02
        # The served places are the reference's to the JSON's rounding.
        assert gaps["delay_gap_db"] == 0.0 and gaps["doppler_gap_db"] == 0.0


def test_the_reference_tracker_follows_the_ports(tmp_path):
    from blah2_tpu_torch.data.detection import Detection
    from blah2_tpu_torch.tracker import Tracker

    rng = np.random.default_rng(5)
    args = (3, 5, 10, 0.5, 10.0, 149.896229, 1.4649)
    port, ref = Tracker(*args), MofN(*args)
    d0 = np.array([40.0, 80.0, 120.0])
    f = np.array([30.0, -50.0, 90.0])
    for k in range(40):
        ts = 1_700_000_000_000 + 500 * k
        d = d0 + k * f * 0.5 * 1.4649 / 149.896229 \
            + rng.normal(0, 0.05, 3)
        rows = [(d[i], f[i] + rng.normal(0, 0.2), 20.0) for i in range(3)
                if rng.random() > 0.15]
        rows += [(rng.uniform(5, 400), rng.uniform(-200, 200), 13.0)
                 for _ in range(rng.integers(0, 3))]
        port.process(Detection(*zip(*rows)) if rows else Detection(), ts)
        ref.process(rows, ts)
        mine = sorted((s, round(a, 6), round(b, 6), n)
                      for s, a, b, n in ref.confirmed())
        theirs = sorted((t.state, round(t.current[0], 6),
                         round(t.current[1], 6), len(t.associated))
                        for t in port.store.tracks
                        if t.state in ("ACTIVE", "COASTING"))
        assert mine == theirs
        # The whole served document: counts, states, histories, places.
        assert judge.track_state_mismatch(port.store.to_json(ts),
                                          ref.document()) == 0
    assert any(s == "ACTIVE" for s, *_ in ref.confirmed())
    # A track served with one association too few is caught.
    doc = json.loads(port.store.to_json(ts))
    doc["data"][0]["n"] -= 1
    assert judge.track_state_mismatch(json.dumps(doc), ref.document()) == 1


@pytest.mark.parametrize("cell", ["rspduo.replay", "usrp_tcp.live_tracks"])
def test_the_control_is_rejected(tmp_path, cell):
    config, mix = cell.split(".")
    spec = manifest.cell(cell)
    got = control.readings(spec, 31, "cpu",
                           config_file=tiny_config(config,
                                                   str(tmp_path / "c.yml")),
                           traffic=tiny_traffic(mix))
    with open(spec["limits_file"]) as f:
        limits = json.load(f)
    assert any(got[k] > limits[k] for k in limits), got


def test_the_reference_and_the_judge_load_nothing_of_the_port():
    code = ("import sys; import benchmark.reference.dsp, "
            "benchmark.reference.tracker, benchmark.judge, benchmark.scene; "
            "import json; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(json.loads(out))
    assert not tops & {"blah2_tpu_torch", "blah2_tpu", "jax", "jaxlib",
                       "flax"}, tops
