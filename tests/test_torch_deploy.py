"""The port as it is deployed, on the CPU, against the JAX side.

- The 3-process topology (``deploy/smoke_3proc_torch.sh``): the port's
  radar with TCP egress sends into ``python -m blah2_tpu_torch.net.api`` in
  a subprocess; every product crosses, the last CPI's among them, and the
  API serves config and web, as tests/test_tcp_egress.py checks for JAX.
  Free ports only: xdist runs that file beside this one.
- The supervised restart soak (``bench/soak_supervised.py``): two cycles
  with the JAX tool's keys and no failure; a worker that exits non-zero is
  reported and the supervisor exits non-zero.
- The deployment files: ``deploy/smoke_3proc_torch.sh`` itself on the CPU
  with free ports; every module and flag the compose file, the CUDA image
  and the script name exists and parses.
- Each new entry point exits 2 without a card unless asked for the CPU.

The dry runs of ``blah2_tpu_torch/entry.py`` and the scaling
projection are in tests/test_torch_dryrun.py.
"""

from __future__ import annotations

import argparse
import ast
import importlib
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from blah2_tpu_torch.bench import common, soak_supervised  # noqa: E402
from blah2_tpu_torch.net import topology as topo  # noqa: E402

torch.set_num_threads(1)

CPU = ["--device", "cpu", "--fs", "200000", "--cpi", "0.1"]
CPIS = 3
#: Longest a run here may take before the test fails (and its processes
#: are killed).
DEADLINE_S = 120.0


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _bounded(fn, *args):
    """``fn(*args)`` on a thread, failing the test past DEADLINE_S."""
    box = {}

    def target():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised on the test's thread
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    assert not t.is_alive(), f"{fn} ran past {DEADLINE_S} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _run(args, seconds=DEADLINE_S):
    """A subprocess of this Python in the repo, killed past ``seconds``."""
    return subprocess.run([sys.executable, *args], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=seconds)


#: The config's ports: the API, the six products' ingest, the config's.
PORT_NAMES = ("api", "map", "detection", "track", "timestamp", "timing",
              "iqdata", "config")


def _write_config(tmp_path):
    """config/config-synthetic.yml on free localhost ports; returns its
    path and the ports in PORT_NAMES order."""
    with open(os.path.join(REPO, "config", "config-synthetic.yml")) as f:
        raw = yaml.safe_load(f)
    ports = common.free_ports(len(PORT_NAMES))
    raw["network"]["ports"] = dict(zip(PORT_NAMES, ports))
    raw["network"]["ip"] = "127.0.0.1"
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(raw))
    return path, ports


# -- the 3-process topology ---------------------------------------------------

@pytest.fixture(scope="module")
def topology(tmp_path_factory):
    """The standalone API in a subprocess on free ports; the port's radar
    in this process with TCP egress runs CPIS CPIs of
    config/config-synthetic.yml (fs 200 kHz, tCpi 0.1 s) on the CPU.
    Returns (the last payload the radar sent per product, GET, the API's
    port)."""
    from blah2_tpu_torch.config import load_config
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    path, ports = _write_config(tmp_path_factory.mktemp("topology"))

    api = subprocess.Popen(
        [sys.executable, "-m", "blah2_tpu_torch.net.api", "-c", str(path)],
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)

    def get(p):
        with urllib.request.urlopen(f"http://127.0.0.1:{ports[0]}{p}",
                                    timeout=5) as r:
            return r.read().decode()

    try:
        topo.wait_for_ports(ports[:7], lambda: api.poll() is None,
                            DEADLINE_S)
        rt = RadarRuntime(load_config(str(path)), api_server=None,
                          use_tcp_egress=True, device="cpu")
        sent = {}
        orig = rt._emit

        def emit(product, payload, parsed=None):
            sent[product] = payload
            return orig(product, payload, parsed=parsed)

        rt._emit = emit
        rt.start_capture()
        try:
            _bounded(rt.run, CPIS, True)
        finally:
            rt.stop()
        yield sent, get, ports[0]
    finally:
        api.kill()
        api.wait(timeout=30)


def _served(get, path, done):
    """The API's product at ``path`` once ``done(it)`` (the ingest threads
    swap it in after the send), or what it holds after 10 s."""
    import time

    deadline = time.monotonic() + 10
    while True:
        got = get(path)
        if done(got) or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


@pytest.mark.parametrize("product,path", [
    ("map", "/api/map"), ("detection", "/api/detection"),
    ("track", "/api/tracker"), ("timestamp", "/api/timestamp"),
    ("timing", "/api/timing"), ("iqdata", "/api/iqdata")])
def test_last_cpi_products_cross_tcp(topology, product, path):
    """Each of the six products the radar sent last (its last CPI's, sent
    by the deferred fetch's final flush before ``run`` returns) is what the
    standalone API serves. The timestamp listener publishes every chunk, so
    stamps sent close together arrive joined, the last one last."""
    sent, get, _ = topology
    want = sent[product]
    if product == "timestamp":
        got = _served(get, path, lambda g: g.endswith(want))
        assert got.endswith(want)
        assert soak_supervised.last_stamp(got) == int(want)
    else:
        assert _served(get, path, lambda g: g == want) == want


def test_products_cross_tcp(topology):
    """tests/test_tcp_egress.py's checks of the products, and the timing
    product of the CPIS-th CPI."""
    sent, get, _ = topology
    timing = json.loads(_served(get, "/api/timing",
                                lambda g: g == sent["timing"]))
    assert timing["nCpi"] == CPIS
    doc = json.loads(get("/api/map"))
    assert doc["nRows"] > 0 and len(doc["data"]) == doc["nRows"]
    assert doc["maxPower"] > 10
    assert len(json.loads(get("/api/detection"))["delay"]) >= 1
    assert get("/api/timestamp").strip().isdigit()
    assert "ambiguity_processing" in timing
    assert len(json.loads(get("/api/iqdata"))["spectrum"]) > 0
    trk = json.loads(get("/api/tracker"))
    assert "n" in trk and "data" in trk
    assert json.loads(get("/stash/map"))["nRows"] == doc["nRows"]


def test_standalone_api_serves_config_and_web(topology):
    """The config, the web console, and the REST surface that
    deploy/smoke_3proc_torch.sh and chip_smoke.py check
    (``net/topology.py``), the CPIS-th CPI's timing product among it."""
    _, get, port = topology
    assert json.loads(get("/api/config"))["capture"]["fs"] == 200000
    assert "<html" in get("/").lower()
    found = topo.rest_checks(port, CPIS)
    assert list(found) == [f"/api/timing nCpi {CPIS}"] + \
        [p for p, _ in topo.REST_CHECKS]
    assert all(found.values()), found


def test_rest_checks_fail_without_an_api():
    """No API on the port: every check fails, and the command exits 1."""
    port = common.free_ports(1)[0]
    assert not any(topo.rest_checks(port, CPIS, seconds=0.2).values())
    with pytest.raises(RuntimeError, match="API process exited"):
        topo.wait_for_ports([port], lambda: False, DEADLINE_S)


def test_api_process_imports_no_torch():
    """The standalone API and the topology's checks start without torch
    (the package loads its device helpers on first use), so the API's
    ingest opens in about a second after its start."""
    proc = _run(["-c", "import sys, blah2_tpu_torch.net.api, "
                 "blah2_tpu_torch.net.topology; "
                 "print('torch' in sys.modules)"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


# -- the supervised restart soak ----------------------------------------------

def _jax_soak_keys():
    """(top-level keys, detail keys) of tools/soak_supervised.py's result
    dict, read from its source."""
    with open(os.path.join(REPO, "tools", "soak_supervised.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            pairs = {k.value: v for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant)}
            if getattr(pairs.get("metric"), "value", None) == \
                    "supervised_restart_soak":
                return set(pairs), {k.value for k in pairs["detail"].keys}
    raise AssertionError("no supervised_restart_soak result")


def test_supervised_soak_two_cycles():
    out = _bounded(soak_supervised.main,
                   CPU + ["--cycles", "2", "--cpis-per-cycle", str(CPIS)])
    top, detail = _jax_soak_keys()
    assert top <= set(out) and detail <= set(out["detail"])
    d = out["detail"]
    assert d["failures"] == []
    assert out["value"] == d["n_cpis_processed"] == 2 * CPIS
    assert [c["exit_code"] for c in d["cycles"]] == [0, 0]
    assert len(d["inter_restart_gaps_s"]) == 1
    assert 0 < d["inter_restart_gaps_s"][0] <= d["product_gap_s_max"] < 60
    assert out["vs_baseline"] == d["product_gap_s_max"] / 60.0
    assert all(v and v > 10 for v in d["rss_sawtooth_last_per_cycle"])
    assert all(0 < s < 60 for s in d["first_product_s_per_cycle"])
    assert d["first_product_s"] == d["first_product_s_per_cycle"][0]
    assert d["kernel_build_s"] is None and d["card"] is None
    assert d["device"] == "cpu"


def test_supervised_soak_reports_a_failing_worker():
    """A worker that exits non-zero (fs 40 kHz leaves too few samples a
    pulse for the default delay window: its pipeline refuses the config)
    stops the soak; the supervisor lists it and exits 1."""
    proc = _run(["-m", "blah2_tpu_torch.bench.soak_supervised", "--device",
                 "cpu", "--fs", "40000", "--cpi", "0.1", "--cycles", "2",
                 "--cpis-per-cycle", str(CPIS)])
    assert proc.returncode == 1, proc.stderr[-2000:]
    d = json.loads(proc.stdout.strip().splitlines()[-1])["detail"]
    assert d["n_cycles"] == 1 and d["cycles"][0]["exit_code"] == 1
    assert d["failures"][0].startswith("cycle 0: worker exited 1")
    assert f"0 CPIs done of {2 * CPIS} asked" in d["failures"]


def test_worker_command_takes_its_launcher():
    """The soak's workers run the CLI, or a launcher given in its place
    that takes the same arguments."""
    args = ["-c", "c.yml", "--no-api", "--tcp-egress", "--cpis", "3",
            "--staged-sample-every", "0", "--quiet", "--device", "cpu"]
    assert soak_supervised.worker_command("c.yml", 3, "cpu") == \
        [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", *args]
    assert soak_supervised.worker_command(
        "c.yml", 3, "cpu", launcher=["w", "--"]) == ["w", "--", *args]


def test_split_events_by_worker_start():
    events = [(1.0, 100), (1.2, 150), (5.0, 210), (5.2, 260)]
    assert soak_supervised.split_events(events, [90, 200]) == \
        [[1.0, 1.2], [5.0, 5.2]]
    assert soak_supervised.split_events(events, [120]) == [[1.2, 5.0, 5.2]]


# -- deployment files ---------------------------------------------------------

class _Parsed(Exception):
    pass


def _parses(module: str, argv) -> argparse.Namespace:
    """``module``'s ``main`` parses ``argv``: its parser runs and the run
    stops right after it (an unknown flag exits 2)."""
    mod = importlib.import_module(module)
    orig = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))

    argparse.ArgumentParser.parse_args = parse
    try:
        mod.main(list(argv))
    except _Parsed as p:
        return p.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f"{module}.main never parsed its arguments")


def _dockerfile_entry():
    """(ENTRYPOINT, CMD) of docker/Dockerfile-torch-cuda as lists."""
    with open(os.path.join(REPO, "docker", "Dockerfile-torch-cuda")) as f:
        text = f.read()
    entry = json.loads(re.search(r"^ENTRYPOINT (.+)$", text, re.M)[1])
    cmd = json.loads(re.search(r"^CMD (.+)$", text, re.M)[1])
    return entry, cmd


def _module_args(command):
    """(module, arguments) of ``python -m module args...``."""
    assert command[:2] == ["python", "-m"], command
    return command[2], command[3:]


def test_compose_file_names_port_modules_and_flags():
    with open(os.path.join(REPO, "deploy",
                           "docker-compose-3proc-torch.yml")) as f:
        services = yaml.safe_load(f)["services"]
    entry, cmd = _dockerfile_entry()
    seen = {}
    for name, svc in services.items():
        if svc.get("image") != "blah2_tpu_torch":
            continue
        argv = svc.get("entrypoint", entry) + (
            shlex.split(svc["command"]) if "command" in svc else cmd)
        module, args = _module_args(argv)
        assert module.startswith("blah2_tpu_torch.")
        assert importlib.util.find_spec(module) is not None, module
        ns = _parses(module, args)
        assert os.path.exists(os.path.join(REPO, ns.config)), ns.config
        seen[name] = (module, ns)
    radar, api = seen["radar"][1], seen["api"][1]
    assert seen["radar"][0] == "blah2_tpu_torch.runtime.cli"
    assert radar.no_api and radar.tcp_egress
    assert seen["api"][0] == "blah2_tpu_torch.net.api" and not api.no_ingest
    devices = services["radar"]["deploy"]["resources"]["reservations"][
        "devices"]
    assert devices[0]["driver"] == "nvidia" and "gpu" in \
        devices[0]["capabilities"]
    assert services["radar"]["build"]["dockerfile"] == \
        "docker/Dockerfile-torch-cuda"
    module, args = _module_args(entry + cmd)
    assert _parses(module, args).config == "config/config.yml"


def test_cuda_image_copies_the_port_and_builds_its_kernels():
    with open(os.path.join(REPO, "docker", "Dockerfile-torch-cuda")) as f:
        text = f.read()
    base = re.search(r"^FROM (\S+)", text, re.M)[1]
    assert base.startswith("pytorch/pytorch:") and base.endswith("-devel")
    for d in ("blah2_tpu_torch", "native", "web", "config"):
        assert re.search(rf"^COPY {d} {d}$", text, re.M), d
    assert "_build.build(n) for n in ('detect', 'halo')" in text


def test_smoke_script_runs_on_the_cpu(tmp_path):
    """``BLAH2_SMOKE_DEVICE=cpu bash deploy/smoke_3proc_torch.sh CFG``:
    every check passes and it exits 0. Its whole process group is killed
    past the deadline."""
    import signal

    env = _env()
    env["BLAH2_SMOKE_DEVICE"] = "cpu"
    proc = subprocess.Popen(
        ["bash", os.path.join(REPO, "deploy", "smoke_3proc_torch.sh"),
         str(_write_config(tmp_path)[0])], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out = proc.communicate(timeout=DEADLINE_S)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert f"ok  /api/timing nCpi {CPIS}" in out and "3proc smoke OK" in out
    assert "FAIL" not in out


def test_smoke_script_names_port_modules():
    with open(os.path.join(REPO, "deploy", "smoke_3proc_torch.sh")) as f:
        text = f.read()
    modules = set(re.findall(r"python -m ([\w.]+)", text))
    assert modules == {"blah2_tpu_torch.net.api",
                       "blah2_tpu_torch.net.topology",
                       "blah2_tpu_torch.runtime.cli"}
    for m in modules:
        assert importlib.util.find_spec(m) is not None
    assert "--no-api --tcp-egress" in text and "BLAH2_SMOKE_DEVICE" in text
    assert _parses("blah2_tpu_torch.runtime.cli", [
        "-c", "config/config-synthetic.yml", "--no-api", "--tcp-egress",
        "--cpis", "3", "--quiet", "--device", "cpu"]).cpis == 3


# -- no card ------------------------------------------------------------------

@pytest.mark.parametrize("module,args", [
    ("blah2_tpu_torch.entry", ["dryrun", "4"]),
    ("blah2_tpu_torch.entry", ["dryrun2proc", "2"]),
    ("blah2_tpu_torch.bench.soak_supervised", ["--cycles", "1"]),
    ("blah2_tpu_torch.bench.projection", ["--measure"]),
], ids=["dryrun", "dryrun2proc", "soak_supervised", "projection"])
def test_entry_points_need_a_card_unless_told(module, args, capsys):
    """Without a card and without ``--device cpu`` each entry point says
    why and exits 2 before it starts anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(SystemExit) as e:
        importlib.import_module(module).main(args)
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""
