"""``BENCHMARK.json`` and the files each cell finds by name.

A cell ``<config>.<mix>`` resolves to ``configs/<config>.yml``,
``traffic/<mix>.json`` (whose ``kind`` names ``traffic/<kind>.py``),
``limits/<cell>.json`` and one reader per per-layer metric that lists the
cell: ``metrics/<metric>.py`` where that file exists, else the file of the
name before the metric's last dot (``output_ms_per_cpi.live`` and
``output_ms_per_cpi.replay`` share ``metrics/output_ms_per_cpi.py``). A
later cell or metric is added by adding files and entries; nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def problems(man: dict, root: str = ROOT) -> List[str]:
    """What in ``man`` breaks the rules on names, units, paths and files
    (an empty list when nothing does)."""
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(man) != keys:
        out.append(f"keys {sorted(man)}")
    for p in man.get("paths", []):
        if not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    if not 1 <= len(man.get("command", [])) <= 32 or not all(
            _line(w) for w in man["command"]):
        out.append("command")
    if not (isinstance(man.get("run_seconds"), int)
            and 1 <= man["run_seconds"] <= 51):
        out.append("run_seconds")
    names = []
    for c in man.get("configs", []):
        names.append(c["name"])
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config keys {sorted(c)}")
        if not _line(c["source"]) or not _line(c["why"]):
            out.append(f"config {c['name']} source or why")
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"config file {c['file']}")
        out += [f"reduced key {k!r}" for k in c["reduced"]
                if not NAME_RE.match(k)]
    for w in man.get("workloads", []):
        names.append(w["name"])
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload keys {sorted(w)}")
        if w["name"] != f"{w['config']}.{w['traffic']}":
            out.append(f"workload {w['name']} is not config.traffic")
        if w["chips"] not in (1, 4) or not _line(w["why"]):
            out.append(f"workload {w['name']} chips or why")
    metrics = man.get("end_to_end", []) + man.get("per_layer", [])
    for m in metrics:
        names.append(m["name"])
        if not UNIT_RE.match(m["unit"]):
            out.append(f"unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher") \
                or m["source"] not in SOURCES:
            out.append(f"metric {m['name']} better or source")
    for m in man.get("per_layer", []):
        if not _line(m["layer"]):
            out.append(f"layer of {m['name']}")
    out += [f"name {n!r}" for n in names if not NAME_RE.match(n)]
    dup = {n for n in names if names.count(n) > 1}
    out += [f"duplicate name {n!r}" for n in sorted(dup)]
    return out


def reader_file(name: str, root: str = ROOT) -> str:
    """The file of per-layer metric ``name``'s reader."""
    metrics = os.path.join(root, "benchmark", "metrics")
    own = os.path.join(metrics, name + ".py")
    if os.path.isfile(own) or "." not in name:
        return own
    return os.path.join(metrics, name.rsplit(".", 1)[0] + ".py")


def _end_to_end(man: dict, cell: str) -> List[dict]:
    return [m for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])]


def cell(name: str, man: dict = None, root: str = ROOT) -> Dict:
    """Everything the harness needs of cell ``name``: its workload entry,
    the files its configuration, traffic, generator kind and limits live in,
    its end-to-end metrics and its per-layer metrics with their readers'
    files. Raises KeyError for a cell the manifest does not hold."""
    man = load() if man is None else man
    work = {w["name"]: w for w in man["workloads"]}[name]
    conf = {c["name"]: c for c in man["configs"]}[work["config"]]
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", work["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = _end_to_end(man, name)
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return {
        "workload": work,
        "config_file": os.path.join(root, conf["file"]),
        "traffic": traffic,
        "kind_file": os.path.join(bench, "traffic", traffic["kind"] + ".py"),
        "limits_file": os.path.join(bench, "limits", name + ".json"),
        "end_to_end": e2e,
        "per_layer": [dict(m, file=reader_file(m["name"], root))
                      for m in per_layer],
    }


def load_module(path: str, name: str):
    """The module in file ``path`` (file names may hold dots, so not by
    import path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
