"""The port over several processes (``parallel/distributed.py``) on the CPU:
the counterpart of tests/test_multihost.py and tests/multihost_worker.py.

Two gloo processes of four CPU ranks each run the sharded pipeline over a
global eight-rank mesh, on the 2 x 4 mesh (one cpi row in each process, no
payload crosses) and the 1 x 8 mesh (one CPI's time axis across the
process boundary: halos and the Doppler and spectrum psums cross), at
complex64 and complex128, with both halo backends, on the scene of
tests/multihost_worker.py:52-74; and the 1 x 8 mesh row-sharded
(``1x8rows``: each rank detects its own Doppler rows, the dB-sum psum, the
dB-max pmax and the all-gather of dB rows and masks cross, and at
complex64 the fused detector's row halos). The parent holds their products against
the one-process eight-rank port and against JAX's eight-device
``ShardedCpiPipeline``.

The workers are this file run as a script:

    python tests/test_torch_multiprocess.py --worker --coordinator H:P \\
        --num-processes 2 --process-id K --out DIR [--case cpu|halo|step]

They import no JAX. A module fixture starts them once, with a deadline
that kills both, so a hang fails the tests instead of holding the suite.
The cases ``halo`` and ``step`` run on two cards, one process each (NCCL,
the halo kernel through CUDA IPC), for tests/test_torch_cuda.py.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: (n_cpi, n_pulse, row_shard): the layouts' "auto" (2 x 4 row-sharded,
#: 1 x 8 replicated), then 1 x 8 row-sharded.
MESHES = ((2, 4, "auto"), (1, 8, "auto"), (1, 8, True))
DTYPES = ("complex64", "complex128")
BACKENDS = ("ppermute", "pallas")
WORKER_SECONDS = 240

# The scene of tests/multihost_worker.py:52-74.
SCENE = {
    "capture": {"fs": 40_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.1, "buffer": 2},
        "ambiguity": {"delayMin": -5, "delayMax": 40,
                      "dopplerMin": -200, "dopplerMax": 200},
        "clutter": {"enable": True, "delayMin": -5, "delayMax": 20},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                      "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                      "nCentroid": 6},
    },
}


def scene_batch():
    """The two seeded CPIs of tests/multihost_worker.py."""
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.config import config_from_dict

    cfg = config_from_dict(SCENE)
    xs, ys = [], []
    for k in range(2):
        x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                             [TargetSpec(10, -33.0, 0.1)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=100 + k)
        xs.append(x)
        ys.append(y)
    return cfg, np.stack(xs), np.stack(ys)


def products(out) -> dict:
    """A step's products as NumPy arrays, by name."""
    got = {"db": out.db_map, "noise": out.noise_power, "ok": out.clutter_ok,
           "max": out.max_power, "spectrum": out.spectrum_db}
    for k in out.detections._fields:
        got[f"det_{k}"] = getattr(out.detections, k)
    return {k: v.cpu().numpy() for k, v in got.items()}


def case_name(n_cpi, n_pulse, rows, dt, backend) -> str:
    forced = "rows" if rows is True else ""
    return f"{n_cpi}x{n_pulse}{forced}-{dt}-{backend}"


def parse_case(case: str):
    """(n_cpi, n_pulse, row_shard, dtype) of a case name."""
    mesh, dt, _ = case.split("-")
    rows = True if mesh.endswith("rows") else "auto"
    n_cpi, n_pulse = (int(v) for v in mesh.removesuffix("rows").split("x"))
    return n_cpi, n_pulse, rows, dt


def run_cases(mesh_of) -> dict:
    """Every case of the module on meshes ``mesh_of(n_cpi, n_pulse)``:
    {case name: products}, with each case's collective log."""
    from blah2_tpu_torch.parallel.collectives import count_bytes
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    cfg, xb, yb = scene_batch()
    results, logs = {}, {}
    for n_cpi, n_pulse, rows in MESHES:
        mesh = mesh_of(n_cpi, n_pulse)
        for dt in DTYPES:
            for backend in BACKENDS:
                pipe = ShardedCpiPipeline(
                    cfg, mesh, dtype=getattr(torch, dt),
                    halo_backend=backend, row_shard=rows,
                    use_fused_detect=rows is True and dt == "complex64")
                planes = pipe.shard_inputs(xb[:n_cpi], yb[:n_cpi])
                with count_bytes(mesh) as ops:
                    out = pipe(*planes)
                name = case_name(n_cpi, n_pulse, rows, dt, backend)
                results[name] = products(out)
                logs[name] = [[op.kind, op.axis, list(op.shape),
                               str(op.dtype), op.bytes_per_rank]
                              for op in ops]
    return results, logs


#: The cards' scene (tests/test_torch_cuda.py's cross-card test).
CARD_SCENE = {
    "capture": {"fs": 80_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.2},
        "ambiguity": {"delayMin": -5, "delayMax": 60,
                      "dopplerMin": -100, "dopplerMax": 100},
        "clutter": {"enable": True, "delayMin": -5, "delayMax": 30},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                      "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                      "nCentroid": 6}}}
HALO_REPEATS = 50


def card_scene():
    from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
    from blah2_tpu_torch.config import config_from_dict

    cfg = config_from_dict(CARD_SCENE)
    x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                         [TargetSpec(20, -44.0, 0.1)],
                         clutter_amplitude=2.0, noise_amplitude=1e-3, seed=0)
    return cfg, x, y


def worker_halo(args) -> dict:
    """The halo kernel against halo_permute_plain (whose pairs across
    processes go by NCCL) on 1 x 2 and 1 x 4 meshes over the processes,
    both directions, circular and masked, float32, complex64 and
    complex128 strided slices, then HALO_REPEATS back-to-back calls; the
    pairs by route and the launches."""
    from blah2_tpu_torch.ops.halo import halo_permute, halo_permute_plain
    from blah2_tpu_torch.parallel import distributed
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh, rank_devices

    n = distributed.process_count()
    cases = bad = 0
    routes = []
    for shape in ((1, 2), (1, 4)):
        mesh = make_radar_mesh(*shape, devices=rank_devices(
            shape[0] * shape[1] // n))
        gen = torch.Generator().manual_seed(distributed.process_index())

        def rand(size, dtype=torch.float32):
            return [None if mesh.devices[r] is None else
                    torch.randn(size, dtype=dtype, generator=gen).to(
                        mesh.devices[r]) for r in range(mesh.size)]

        for to_left in (True, False):
            for dtype, mask in ((torch.float32, False),
                                (torch.float32, True),
                                (torch.complex64, True),
                                (torch.complex128, True)):
                blocks = rand((2, 1000), dtype)
                parts = [None if b is None else
                         b[..., :409] if to_left else b[..., -409:]
                         for b in blocks]
                before = dict(halo_permute.pairs), halo_permute.launches
                for _ in range(HALO_REPEATS if dtype == torch.complex64
                               else 1):
                    got = halo_permute(parts, mesh, to_left=to_left,
                                       mask_edge=mask, collective_id=1)
                    want = halo_permute_plain(parts, mesh, to_left=to_left,
                                              mask_edge=mask)
                    for r in mesh.local_ranks:
                        g, w = got[r], want[r]
                        if g.is_complex():
                            g, w = torch.view_as_real(g), torch.view_as_real(w)
                        bad += int((g != w).sum())
                    cases += 1
                routes.append({
                    "mesh": list(shape), "to_left": to_left,
                    "dtype": str(dtype), "mask": mask,
                    "launches": halo_permute.launches - before[1],
                    "pairs": {k: v - before[0][k]
                              for k, v in halo_permute.pairs.items()}})
    halo_permute.check()
    return {"cases": cases, "differing": bad, "routes": routes}


def worker_step(args) -> dict:
    """The sharded step on a 1 x 2 mesh over the processes (one rank each,
    complex64, the fused detector), with both halo backends; process 0
    keeps the products."""
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel import distributed
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh, rank_devices
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

    cfg, x, y = card_scene()
    mesh = make_radar_mesh(1, 2, devices=rank_devices(
        2 // distributed.process_count()))
    got = {}
    for backend in BACKENDS:
        sp = ShardedCpiPipeline(cfg, mesh, halo_backend=backend,
                                use_fused_detect=True)
        planes = sp.shard_inputs(x, y)
        sp(*planes)
        launches = halo_permute.launches
        got[backend] = products(sp(*planes))
        got[backend + "_launches"] = halo_permute.launches - launches
    halo_permute.check()
    if distributed.process_index() == 0:
        np.savez(os.path.join(args.out, "step.npz"),
                 **{f"{b}/{k}": v for b in BACKENDS
                    for k, v in got[b].items()})
    return {"launches": {b: got[b + "_launches"] for b in BACKENDS}}


def worker_cpu(args) -> int:
    """Every case of the module in this gloo process, then
    calibrate_row_shard; this process's products and meta to ``--out``."""
    from blah2_tpu_torch.ops.halo import halo_permute
    from blah2_tpu_torch.parallel import distributed
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import calibrate_row_shard

    assert distributed.maybe_initialize(args.coordinator, args.num_processes,
                                        args.process_id, device="cpu")
    assert distributed.process_count() == args.num_processes
    per = 8 // args.num_processes
    results, logs = run_cases(
        lambda c, p: make_radar_mesh(c, p, devices=["cpu"] * per))
    cfg, _, _ = scene_batch()
    cal = calibrate_row_shard(cfg, make_radar_mesh(2, 4,
                                                   devices=["cpu"] * per),
                              n_trials=1)
    assert cal["pipeline"]._row_shard == cal["row_shard"]
    me = distributed.process_index()
    # The halo kernel's error words as read in each process: clean in both,
    # then a timed-out wait in process 1 only.
    raised = []
    for words in ((0, 0), (0, 2)):
        try:
            halo_permute.check(words[me])
            raised.append(False)
        except RuntimeError:
            raised.append(True)
    np.savez(os.path.join(args.out, f"products_{me}.npz"),
             **{f"{case}/{k}": v for case, got in results.items()
                for k, v in got.items()})
    with open(os.path.join(args.out, f"meta_{me}.json"), "w") as f:
        json.dump({"row_shard": cal["row_shard"], "logs": logs,
                   "backend": distributed.job().backend,
                   "check_raised": raised}, f)
    distributed.shutdown()
    return 0


def worker(args) -> int:
    from blah2_tpu_torch.parallel import distributed

    if args.case == "cpu":
        return worker_cpu(args)
    assert distributed.maybe_initialize(args.coordinator, args.num_processes,
                                        args.process_id)
    job = distributed.job()
    mine = {"backend": job.backend, "cards": list(job.cards),
            **(worker_halo if args.case == "halo" else worker_step)(args)}
    every = distributed.all_gather_object(mine)
    if distributed.process_index() == 0:
        with open(os.path.join(args.out, f"{args.case}.json"), "w") as f:
            json.dump(every, f)
    distributed.shutdown()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script, extra, n, seconds, env=None):
    """Start ``n`` processes of ``script --worker`` on one coordinator and
    wait for them: a process that runs past ``seconds`` is killed with the
    rest, and that raises. Returns their outputs."""
    port = free_port()
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, script, "--worker", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id",
         str(k), *extra], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=seconds)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for k, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {k} exited {p.returncode}:\n{out}")
    return outs


# -- the parent's side --------------------------------------------------------

@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both processes' products, calibration decisions and collective logs:
    [(products by case, meta)] in process order."""
    out = tmp_path_factory.mktemp("workers")
    run_workers(os.path.abspath(__file__), ["--out", str(out)], 2,
                WORKER_SECONDS)
    got = []
    for k in range(2):
        npz = np.load(out / f"products_{k}.npz")
        by_case: dict = {}
        for key in npz.files:
            case, name = key.split("/")
            by_case.setdefault(case, {})[name] = npz[key]
        with open(out / f"meta_{k}.json") as f:
            got.append((by_case, json.load(f)))
    return got


@pytest.fixture(scope="module")
def one_process():
    """The same cases on the one-process eight-rank port."""
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    return run_cases(lambda c, p: make_radar_mesh(c, p,
                                                  devices=["cpu"] * 8))


@pytest.fixture(scope="module")
def jax_products():
    """JAX's eight-device ShardedCpiPipeline on the scene, per mesh and
    dtype (its ppermute backend; tests/test_halo.py holds its backends
    equal)."""
    import jax.numpy as jnp

    from blah2_tpu.config import config_from_dict
    from blah2_tpu.parallel.mesh import make_radar_mesh
    from blah2_tpu.parallel.sharded import ShardedCpiPipeline

    cfg = config_from_dict(SCENE)
    _, xb, yb = scene_batch()
    out = {}
    for n_cpi, n_pulse, rows in MESHES:
        for dt in DTYPES:
            pipe = ShardedCpiPipeline(cfg, make_radar_mesh(n_cpi, n_pulse),
                                      dtype=getattr(jnp, dt), row_shard=rows)
            res = pipe(*pipe.shard_inputs(xb[:n_cpi], yb[:n_cpi]))
            det = res.detections
            out[n_cpi, n_pulse, rows, dt] = {
                "db": np.asarray(res.db_map),
                "noise": np.asarray(res.noise_power),
                "ok": np.asarray(res.clutter_ok),
                "det_row": np.asarray(det.row), "det_col": np.asarray(det.col),
                "det_valid": np.asarray(det.valid)}
    return out


#: Maps and noise against the one-process port, in dB, by dtype.
ONE_PROCESS_DB = {"complex64": 1e-4, "complex128": 1e-6}
#: Against JAX: its own multi-host bar at complex64
#: (tests/test_multihost.py:105) and the port's 1e-6 dB at complex128.
JAX_DB = {"complex64": 2e-2, "complex128": 1e-6}


def det_sets(got: dict) -> list:
    """Per CPI, the (row, col) cells of the valid detections."""
    return [set(zip(r[v].tolist(), c[v].tolist())) for r, c, v in
            zip(got["det_row"], got["det_col"], got["det_valid"])]


CASES = [case_name(c, p, rows, dt, b) for c, p, rows in MESHES
         for dt in DTYPES for b in BACKENDS]


@pytest.mark.parametrize("case", CASES)
def test_two_processes_match_one_process(case, workers, one_process):
    """Two processes of four ranks give the one-process eight-rank port's
    products: the maps and noise within ONE_PROCESS_DB (the same ops in the
    same order, so in practice the same bits), the same clutter flags and
    detection sets."""
    got, want = workers[0][0][case], one_process[0][case]
    bar = ONE_PROCESS_DB[parse_case(case)[3]]
    assert got["db"].shape == want["db"].shape
    np.testing.assert_allclose(got["db"], want["db"], rtol=0, atol=bar)
    np.testing.assert_allclose(got["noise"], want["noise"], rtol=0, atol=bar)
    np.testing.assert_array_equal(got["ok"], want["ok"])
    assert got["ok"].all()
    assert det_sets(got) == det_sets(want)


@pytest.mark.parametrize("case", CASES)
def test_two_processes_match_jax(case, workers, jax_products):
    """The two-process port against JAX's eight-device pipeline: maps
    within JAX_DB and the same detection sets, both CPIs."""
    n_cpi, n_pulse, rows, dt = parse_case(case)
    got, want = workers[0][0][case], jax_products[n_cpi, n_pulse, rows, dt]
    np.testing.assert_allclose(got["db"], want["db"], rtol=0,
                               atol=JAX_DB[dt])
    np.testing.assert_allclose(got["noise"], want["noise"], rtol=0,
                               atol=JAX_DB[dt])
    np.testing.assert_array_equal(got["ok"], want["ok"])
    assert det_sets(got) == det_sets(want)


@pytest.mark.parametrize("case", CASES)
def test_every_process_ends_with_the_whole_batch(case, workers):
    """Both processes return every CPI's products, the same bits."""
    a, b = workers[0][0][case], workers[1][0][case]
    assert a.keys() == b.keys()
    n_cpi = int(case.split("x")[0])
    for k in a:
        assert a[k].shape[0] == n_cpi, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_calibrate_row_shard_decision_is_process_0s(workers):
    """Every process ends calibrate_row_shard with the same decision."""
    assert isinstance(workers[0][1]["row_shard"], bool)
    assert workers[0][1]["row_shard"] == workers[1][1]["row_shard"]


@pytest.mark.parametrize("case", CASES)
def test_count_bytes_as_in_one_process(case, workers, one_process):
    """count_bytes logs the same collectives and bytes in each process as
    in one process: the HLO model's bytes, not the gathered ones."""
    want = json.loads(json.dumps(one_process[1][case]))
    assert want
    for _, meta in workers:
        assert meta["logs"][case] == want


def test_the_cpu_takes_gloo(workers):
    assert [meta["backend"] for _, meta in workers] == ["gloo", "gloo"]


def test_a_halo_error_in_one_process_raises_in_every_process(workers):
    """halo_permute.check or-reduces the error words over the processes:
    clean words raise nowhere, a timed-out wait in process 1 raises in
    both."""
    assert [meta["check_raised"] for _, meta in workers] == \
        [[False, True]] * 2


# -- the halo kernel's routes ------------------------------------------------

@pytest.fixture
def as_process(monkeypatch):
    """Make the meshes built next those of process ``index`` of ``count``
    (on ``hosts``), without a job: the halo's routes are a function of the
    layout alone."""
    from blah2_tpu_torch.parallel import distributed

    def make(index, count, hosts=None):
        monkeypatch.setattr(distributed, "process_count", lambda: count)
        monkeypatch.setattr(distributed, "process_index", lambda: index)
        monkeypatch.setattr(distributed, "job", lambda: distributed.Job(
            "gloo", "", tuple(hosts or [""] * count), (), None))
    return make


def _routes(as_process, index, count, ipc_ok, hosts=None, to_left=True):
    from blah2_tpu_torch.ops.halo import routes
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    as_process(index, count, hosts)
    mesh = make_radar_mesh(1, 4, devices=["cpu"] * (4 // count))
    return routes(mesh, "pulse", to_left, True, ipc_ok)


def test_routes_two_processes_sharing_a_card(as_process):
    """1 x 4 split 2 + 2 on one card (gloo): inside each process the
    kernel, with no flags; the pair 2 -> 1 through the group; the masked
    edge 3, whose sender 0 is in the other process, zero-filled by its own
    process's launch. Per shift 2 pairs by the kernel and 1 by the group,
    one launch a process."""
    from blah2_tpu_torch.ops.halo import Block

    p0 = _routes(as_process, 0, 2, ipc_ok=False)
    p1 = _routes(as_process, 1, 2, ipc_ok=False)
    assert p0.blocks == [[Block(1, 0, False, None, None)]]
    assert p1.blocks == [[Block(3, 2, False, None, None),
                          Block(None, 3, True, None, None)]]
    assert p0.group_pairs == p1.group_pairs == [(2, 1)]
    assert not (p0.flags or p1.flags or p0.ipc or p1.ipc)
    assert {k: p0.counts[k] + p1.counts[k] for k in p0.counts} == \
        {"kernel": 2, "ipc": 0, "group": 1}


def test_routes_one_process_a_card_on_one_host(as_process):
    """1 x 4 over four processes with cards of their own on one host: every
    pair through IPC with the flag protocol, the masked edge's zeros
    written by its sender as on one card."""
    from blah2_tpu_torch.ops.halo import Block

    got = [_routes(as_process, k, 4, ipc_ok=True) for k in range(4)]
    assert [g.blocks for g in got] == [
        [[Block(0, 3, True, 0, 0)]], [[Block(1, 0, False, 1, 1)]],
        [[Block(2, 1, False, 2, 2)]], [[Block(3, 2, False, 3, 3)]]]
    assert all(g.flags and g.ipc and not g.group_pairs for g in got)
    assert [g.counts["ipc"] for g in got] == [1, 1, 1, 0]


def test_routes_across_hosts_take_the_group(as_process):
    """Two hosts of two processes: IPC on each host, the group between
    them; a block with no route to its peer keeps only its own flags."""
    from blah2_tpu_torch.ops.halo import Block

    hosts = ["a", "a", "b", "b"]
    got = [_routes(as_process, k, 4, True, hosts, to_left=False)
           for k in range(4)]
    assert [g.group_pairs for g in got] == [[(1, 2)]] * 4
    assert got[1].blocks == [[Block(1, None, False, 1, 1)]]
    assert got[2].blocks == [[Block(2, 3, False, None, None)]]
    # Rank 0, the masked edge, has its sender on the other host.
    assert got[0].blocks == [[Block(0, 1, False, None, None),
                              Block(None, 0, True, None, None)]]
    assert {k: sum(g.counts[k] for g in got) for k in got[0].counts} == \
        {"kernel": 0, "ipc": 2, "group": 1}


# -- the products' gather -----------------------------------------------------

def _outputs(n, seed, detections=True, sub=False):
    from blah2_tpu_torch.dsp.cfar import CfarDetections
    from blah2_tpu_torch.dsp.pipeline import CpiOutputs

    g = torch.Generator().manual_seed(seed)
    k = 5 if detections else 0
    return CpiOutputs(
        db_map=torch.randn(n, 7, 9, generator=g),
        noise_power=torch.randn(n, generator=g),
        max_power=torch.randn(n, generator=g),
        spectrum_db=torch.randn(n, 11, dtype=torch.float64, generator=g),
        clutter_ok=torch.rand(n, generator=g) > 0.5,
        detections=CfarDetections(
            row=torch.randint(0, 7, (n, k), generator=g),
            col=torch.randint(0, 9, (n, k), generator=g),
            delay=torch.randn(n, k, generator=g),
            doppler=torch.randn(n, k, generator=g),
            snr=torch.randn(n, k, generator=g),
            valid=torch.rand(n, k, generator=g) > 0.5,
            count=torch.randint(0, k + 1, (n,), dtype=torch.int32,
                                generator=g)),
        sub_spectra_db=torch.randn(n, 3, 11, generator=g) if sub else None)


@pytest.mark.parametrize("detections", [True, False])
@pytest.mark.parametrize("counts", [(2, 1), (1, 0), (1, 0, 2)])
def test_products_gather_joins_every_process_in_order(counts, detections,
                                                      monkeypatch):
    """Each process's products, packed as bytes (float32, float64, int64,
    int32, bool and empty fields), come back whole and in process order,
    whichever processes hold none (process 0 always holds row 0)."""
    from blah2_tpu_torch.parallel import distributed, sharded

    outs = [None if n == 0 else _outputs(n, seed=p, detections=detections,
                                         sub=True)
            for p, n in enumerate(counts)]
    spec = [None if t is None else (tuple(t.shape[1:]), t.dtype)
            for t in sharded._fields(outs[0])]
    cpu = torch.device("cpu")
    # Each process packs its buffer; then every process joins them all.
    bufs = []
    monkeypatch.setattr(distributed, "all_gather",
                        lambda buf: bufs.append(buf) or [buf] * len(counts))
    for out in outs:
        sharded._gather_products(out, list(counts), spec, cpu)
    monkeypatch.setattr(distributed, "all_gather", lambda buf: bufs)
    for out in outs:
        got = sharded._gather_products(out, list(counts), spec, cpu)
        for a, *parts in zip(sharded._fields(got), *[
                sharded._fields(o) for o in outs if o is not None]):
            if a is None:
                assert all(p is None for p in parts)
            else:
                assert torch.equal(a, torch.cat(parts))


# -- maybe_initialize ---------------------------------------------------------

class _Initialised(Exception):
    pass


@pytest.fixture
def init_args(monkeypatch):
    """The arguments maybe_initialize passes to init_process_group, which
    is stopped there; the BLAH2_* variables cleared first."""
    for name in ("BLAH2_COORDINATOR", "BLAH2_NUM_PROCESSES",
                 "BLAH2_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    seen = {}

    def init(**kw):
        seen.update(kw)
        raise _Initialised

    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    return seen


def test_maybe_initialize_without_a_coordinator_does_nothing(init_args):
    from blah2_tpu_torch.parallel import distributed

    assert distributed.maybe_initialize(device="cpu") is False
    assert distributed.maybe_initialize(None, 2, 1, device="cpu") is False
    assert init_args == {}
    assert not distributed.is_multiprocess()
    assert (distributed.process_index(), distributed.process_count()) == \
        (0, 1)


@pytest.mark.parametrize("source", ["arguments", "environment", "both",
                                    "auto"])
def test_maybe_initialize_takes_arguments_then_environment(
        source, init_args, monkeypatch):
    """Explicit arguments first, then BLAH2_*; "auto" is torchrun's
    env://. The payloads' backend comes later, from the layout: the
    default group is gloo."""
    from blah2_tpu_torch.parallel import distributed

    if source in ("environment", "both"):
        monkeypatch.setenv("BLAH2_COORDINATOR", "10.0.0.1:1000")
        monkeypatch.setenv("BLAH2_NUM_PROCESSES", "4")
        monkeypatch.setenv("BLAH2_PROCESS_ID", "3")
    args = {"arguments": ("127.0.0.1:2000", 2, 1),
            "both": ("127.0.0.1:2000", 2, 1),
            "environment": (None, None, None),
            "auto": ("auto", None, None)}[source]
    with pytest.raises(_Initialised):
        distributed.maybe_initialize(*args, device="cpu")
    assert init_args["backend"] == "gloo"
    want = {"arguments": ("tcp://127.0.0.1:2000", 2, 1),
            "both": ("tcp://127.0.0.1:2000", 2, 1),
            "environment": ("tcp://10.0.0.1:1000", 4, 3),
            "auto": ("env://", None, None)}[source]
    assert (init_args["init_method"], init_args.get("world_size"),
            init_args.get("rank")) == want


#: Job layouts, (host, cards seen) per process, and the backend, the reason
#: and each process's card indices they take.
LAYOUTS = {
    "cpu": ([("a", []), ("a", [])], "gloo", "host", [(), ()]),
    "one shared card": ([("a", ["u0"]), ("a", ["u0"])], "gloo", "share",
                        [(0,), (0,)]),
    "four cards, each sees all": ([("a", ["u0", "u1", "u2", "u3"])] * 4,
                                  "nccl", "own", [(0,), (1,), (2,), (3,)]),
    "two hosts, each process one card": (
        [("a", ["u0"]), ("a", ["u1"]), ("b", ["u0"]), ("b", ["u1"])],
        "nccl", "own", [(0,)] * 4),
    "two processes of two cards": ([("a", ["u0", "u1", "u2", "u3"])] * 2,
                                   "nccl", "own", [(0, 1), (2, 3)]),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_backend_follows_the_layout(name):
    """NCCL where every process has cards of its own, gloo on the host and
    where processes share a card; the cards shared out in host order."""
    from blah2_tpu_torch.parallel.distributed import choose_backend

    layout, backend, why, cards = LAYOUTS[name]
    for k in range(len(layout)):
        got, reason, mine = choose_backend(layout, k, nccl=True)
        assert (got, mine) == (backend, cards[k])
        assert why in reason


def test_cards_of_their_own_without_nccl_raise():
    """No fallback to gloo for a job on cards of their own: a PyTorch
    without NCCL raises; the gloo layouts do not need it."""
    from blah2_tpu_torch.parallel.distributed import choose_backend

    with pytest.raises(RuntimeError, match="NCCL"):
        choose_backend([("a", ["u0"]), ("a", ["u1"])], 0, nccl=False)
    for name in ("cpu", "one shared card"):
        assert choose_backend(LAYOUTS[name][0], 0, nccl=False)[0] == "gloo"


@pytest.mark.parametrize("missing", ["num_processes", "process_id"])
def test_maybe_initialize_needs_a_count_and_an_id(missing, init_args):
    from blah2_tpu_torch.parallel import distributed

    kw = {"num_processes": 2, "process_id": 0}
    kw.pop(missing)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.maybe_initialize("127.0.0.1:2000", device="cpu", **kw)
    assert init_args == {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--case", choices=("cpu", "halo", "step"), default="cpu")
    return worker(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
