"""BENCHMARK.json against the contract's rules on names, units and files;
every cell resolving its files by name; a cell and a metric added by new
files and entries alone; the readers reading, or staying silent."""

import json
import os
import shutil
from types import SimpleNamespace

import pytest

from benchmark import manifest
from benchmark.reference import dsp

MAN = manifest.load()


def test_manifest_names_units_paths_and_files():
    assert manifest.problems(MAN) == []
    assert MAN["command"] == ["python3", "-m", "benchmark.run"]
    assert MAN["paths"] == ["benchmark"]
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    assert all(m["bound"] <= 0.25 for m in MAN["end_to_end"])
    layers = {m["layer"] for m in MAN["per_layer"]}
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        perf = f.read()
    assert all(layer in perf for layer in layers)


def test_a_bad_name_and_unit_are_refused():
    bad = json.loads(json.dumps(MAN))
    bad["per_layer"][0]["name"] = "host ms"
    bad["per_layer"][1]["unit"] = "ms per CPI"
    found = manifest.problems(bad)
    assert "name 'host ms'" in found and "unit 'ms per CPI'" in found


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_resolves_its_files_by_name(cell):
    spec = manifest.cell(cell, MAN)
    for key in ("config_file", "kind_file", "limits_file"):
        assert os.path.isfile(spec[key]), key
    assert spec["per_layer"], "a cell reports at least one per-layer metric"
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in spec["per_layer"]:
        assert os.path.isfile(m["file"])
        assert m["moves"] in names


def test_a_new_cell_and_metric_come_from_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "kraken.yml").write_text(
        (bench / "configs" / "rspduo.yml").read_text())
    (bench / "traffic" / "burst.json").write_text(json.dumps(
        {"kind": "paced", "rate_msps": 1.0, "chunks_per_cpi": 8,
         "warmup_cpis": 34, "scene": {}, "judge": {"map_every_cpis": 64}}))
    (bench / "limits" / "kraken.burst.json").write_text(
        json.dumps({"map_gap_db": 1.0, "detection_gap_db": 1.0}))
    (bench / "metrics" / "burst_ms.py").write_text(
        "def read(run):\n    return 1.0\n")
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "kraken", "source": "x",
                           "file": "benchmark/configs/kraken.yml",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "kraken.burst", "config": "kraken",
                             "traffic": "burst", "chips": 1, "why": "x"})
    man["end_to_end"][2]["workloads"].append("kraken.burst")
    man["per_layer"].append({"name": "burst_ms", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "x", "moves": "latency_p50_ms",
                             "workloads": ["kraken.burst"]})
    # A metric of the same quantity in another cell reuses its reader.
    man["per_layer"].append({"name": "device_idle_share.burst",
                             "unit": "fraction", "better": "lower",
                             "source": "device_trace", "layer": "x",
                             "moves": "latency_p50_ms",
                             "workloads": ["kraken.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, str(root)) == []
    spec = manifest.cell("kraken.burst", man, str(root))
    assert spec["config_file"] == str(bench / "configs" / "kraken.yml")
    assert spec["kind_file"] == str(bench / "traffic" / "paced.py")
    assert [m["name"] for m in spec["per_layer"]] == [
        "burst_ms", "device_idle_share.burst"]
    assert spec["per_layer"][1]["file"] == str(
        bench / "metrics" / "device_idle_share.py")
    assert manifest.load_module(spec["per_layer"][0]["file"],
                                "m").read(None) == 1.0
    # No file that was there changed.
    assert all(p.read_bytes() == b for p, b in before.items())


def _run(**kw):
    base = dict(timing=[], trace=None, trace_cpis=None, lags_ms=[],
                geometry=dsp.geometry(_doc()))
    base.update(kw)
    return SimpleNamespace(**base)


def _doc():
    import yaml

    with open(os.path.join(manifest.ROOT, "benchmark", "configs",
                           "rspduo.yml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_each_reader_reads_or_stays_silent(metric):
    mod = manifest.load_module(manifest.reader_file(metric), "r")
    assert mod.read(_run()) is None
    trace = {"window_s": 5.0, "busy_s": 0.25,
             "kernels": {"void detect_tile<float2>(...)": (1e-4, 10),
                         "vector_fft": (0.1, 500)}}
    full = _run(timing=[{"cpi": 6.0, "output_radar_data": 4.0},
                        {"cpi": 8.0, "output_radar_data": 2.0}],
                trace=trace, trace_cpis=50, lags_ms=[1.0] * 20)
    value = mod.read(full)
    assert isinstance(value, float) and value > 0
    expect = {"host_ms_per_cpi.replay": 7.0, "output_ms_per_cpi.replay": 3.0,
              "output_ms_per_cpi.live": 3.0,
              "device_idle_share.replay": 0.95,
              "device_idle_share.live": 0.95,
              "device_busy_ms_per_cpi.openloop": 5.0,
              "detect_roofline": (301 * 411 * 20 + 411 * 4 + 8)
              / 3.35e12 / 1e-5 * 100,
              "generator_lag_p95_ms.openloop": 1.0}
    assert value == pytest.approx(expect[metric])
