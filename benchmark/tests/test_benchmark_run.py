"""Whole runs of the harness at a size the CPU holds (the look for a card
skipped): sound runs come out correct, and the timed path broken
underneath makes ``correct`` false, once for each fault the cells can
have. Without a card the command exits 2 and prints no result; a run on
the card is the ``cuda``-marked test."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import manifest, run

ROOT = manifest.ROOT


def _main(capsys, cell, tiny, seconds="3"):
    rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds",
                   seconds, "--trace", "0"], device="cpu", **tiny(cell))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["rspduo.replay", "usrp_tcp.replay_tracks",
                                  "rspduo.openloop", "usrp_tcp.live_tracks"])
def test_a_sound_run_is_correct(capsys, tiny, cell):
    res = _main(capsys, cell, tiny)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    spec = manifest.cell(cell)
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    if "track_docs" in res["judged"]:
        assert res["judged"]["active_tracks"] > 0
        assert res["judged"]["track_state_docs"] > 0


def _alter(monkeypatch, fault):
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    forward = CpiPipeline.forward

    def broken(self, x, y):
        out = forward(self, x, y)
        if fault == "map":
            db = out.db_map.clone()
            db[db.shape[0] // 3] += 1.0
            return out._replace(db_map=db)
        det = out.detections
        if fault in ("delay_centre", "delay_sign"):
            # The interpolation's offset dropped, or taken the wrong way.
            centre = torch.round(det.delay)
            delay = centre if fault == "delay_centre" else \
                2 * centre - det.delay
            return out._replace(detections=det._replace(delay=delay))
        if fault == "doppler_sign":
            axis = torch.as_tensor(self.ambiguity.doppler_axis,
                                   dtype=det.doppler.dtype)
            centre = axis[det.row.clamp(0, len(axis) - 1)]
            return out._replace(detections=det._replace(
                doppler=2 * centre - det.doppler))
        first = int(torch.nonzero(det.valid)[0])
        valid = det.valid.clone()
        valid[first] = False
        return out._replace(detections=det._replace(valid=valid))

    monkeypatch.setattr(CpiPipeline, "forward", broken)


@pytest.mark.parametrize("fault", ["map", "detection", "delay_centre",
                                   "delay_sign", "doppler_sign"])
def test_an_answer_altered_where_it_is_produced_is_incorrect(
        capsys, tiny, monkeypatch, fault):
    _alter(monkeypatch, fault)
    res = _main(capsys, "rspduo.replay", tiny)
    assert not res["correct"]
    key = {"map": "map_gap_db", "detection": "detection_gap_db",
           "delay_centre": "delay_gap_db", "delay_sign": "delay_gap_db",
           "doppler_sign": "doppler_gap_db"}[fault]
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]


def test_a_tracker_that_keeps_its_state_is_incorrect(capsys, tiny,
                                                     monkeypatch):
    from blah2_tpu_torch.tracker import Tracker

    process = Tracker.process
    calls = []

    def stuck(self, detection, ts):
        calls.append(ts)
        if len(calls) <= 40:       # set-up runs; then the state stays
            return process(self, detection, ts)
        return self.store

    monkeypatch.setattr(Tracker, "process", stuck)
    res = _main(capsys, "usrp_tcp.replay_tracks", tiny)
    assert not res["correct"]
    assert res["checks"]["track_mismatch"]["value"] > 0


def test_a_tracker_that_drops_its_associations_is_incorrect(
        capsys, tiny, monkeypatch):
    """Each track moves to its detection but keeps no history of it: ACTIVE
    places do not move, the served state does."""
    from blah2_tpu_torch.data.track import TrackRecord

    def forgetful(self, point):
        self.current = point

    monkeypatch.setattr(TrackRecord, "associate", forgetful)
    res = _main(capsys, "usrp_tcp.live_tracks", tiny)
    assert not res["correct"]
    assert res["checks"]["track_mismatch"]["value"] == 0
    assert res["checks"]["track_state_mismatch"]["value"] > 0


def test_without_a_card_it_exits_2_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "rspduo.replay", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2 and proc.stdout == ""


def test_a_run_loads_no_jax_and_leaves_no_process(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from benchmark.tests.conftest import tiny_config, tiny_traffic
from benchmark import run
rc = run.main(["--workload", "usrp_tcp.live_tracks", "--seed", "9",
               "--seconds", "2", "--trace", "0"], device="cpu",
              config_file=tiny_config("usrp_tcp", {str(tmp_path / 'c.yml')!r}),
              traffic=tiny_traffic("live_tracks"))
import multiprocessing
print(json.dumps({{"rc": rc, "mods": sorted({{m.split(".")[0]
      for m in sys.modules}}), "children":
      len(multiprocessing.active_children())}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["rc"] == 0, proc.stderr[-2000:]
    assert not set(last["mods"]) & run.FORBIDDEN
    assert "blah2_tpu_torch" in last["mods"]
    # The harness's own children: the poller, and the API process reading
    # its deployment file from the harness's "bench-" temporary directory.
    ps = subprocess.run(["ps", "-eo", "args"], capture_output=True,
                        text=True).stdout.splitlines()
    assert not [a for a in ps if "benchmark.poller" in a or (
        "blah2_tpu_torch.net.api" in a and "bench-" in a)]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "rspduo.replay", "--seed", "3", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
