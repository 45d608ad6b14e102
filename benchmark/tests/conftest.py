"""A cell cut to a size the CPU runs in seconds: fs 200 kHz, 0.1 s CPIs,
delays to 100 bins, two scene CPIs, targets moved inside the window."""

from __future__ import annotations

import json
import os

import pytest
import yaml

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_config(config: str, path: str) -> str:
    with open(os.path.join(BENCH, "configs", config + ".yml")) as f:
        doc = yaml.safe_load(f)
    doc["capture"]["fs"] = 200_000
    doc["process"]["data"]["cpi"] = 0.1
    doc["process"]["ambiguity"]["delayMax"] = 100
    doc["process"]["clutter"]["delayMax"] = 100
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


def tiny_traffic(mix: str, **changes) -> dict:
    with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
        t = json.load(f)
    t["scene"]["cpis"] = 2
    for tgt in t["scene"]["targets"]:
        tgt["delay"] = min(tgt["delay"] // 4 + 10, 95)
        tgt["amplitude"] *= 5
    t["warmup_cpis"] = 20
    if "map_every_cpis" in t["judge"]:
        t["judge"]["map_every_cpis"] = 32
    else:  # polled: several maps and track documents in a 3 s window
        t["judge"].update(map_every_s=0.3, track_every_s=0.2)
    if t["kind"] == "paced":
        t["rate_msps"] = 0.2
    t.update(changes)
    return t


@pytest.fixture
def tiny(tmp_path):
    """``tiny(cell)``: the keyword arguments that cut ``cell`` to size for
    ``run.main`` and ``harness.run_cell``."""
    def make(cell: str, **changes) -> dict:
        config, mix = cell.split(".")
        return {"config_file": tiny_config(config,
                                           str(tmp_path / "config.yml")),
                "traffic": tiny_traffic(mix, **changes)}
    return make
