"""The sharded step as the port's CUDA graph records it
(``parallel/sharded.py`` ``ShardedCpiPipeline._step`` through
``dsp/graph.py`` ``StaticCall``), run on the CPU.

There is no CUDA graph on the CPU, so these tests hold what the graph
records and how its replays count: the body over the graph's static
buffers gives the bits of the eager ``forward`` for every algorithm of the
sharded path (Wiener with the fused detector row-sharded, Wiener unfused
and replicated, ECA-B, NLMS with its ranks batched and in turn, nSub 4,
OS-CFAR) on 1 × 4 and 2 × 2 logical ranks, and agrees with the JAX
package's ``ShardedCpiPipeline`` at the suites' bars (complex128: maps
within 1e-6 dB, the fused detector's float32 map within 2e-4, the same
detection sets; complex64: the bounds of
``test_torch_sharded.py::test_sharded_matches_jax``). The replay path runs
against a stand-in graph that reruns the body into fixed output buffers
with its own counting taken back, as a CUDA graph replays without Python:
the inputs copied, the outputs cloned, no state carried from an earlier
step, the halo kernel's launches and pairs and the collectives' bytes
counted once a replay and taken back from the capture, one graph per
layout; and through it the mesh runtime emits the eager loop's products.
Where the step cannot be a graph (the CPU, a gloo job) ``graph="auto"``
runs eagerly and says why, and ``graph=True`` raises; over several cards
and in NCCL jobs it captures and says so, from the layout alone. The card's own checks are ``tests/test_torch_cuda.py``'s
``sharded_graph`` cases and ``chip_smoke.py`` ``phase_sharded_graph``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
from blah2_tpu.parallel.sharded import ShardedCpiPipeline as JaxSharded
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.device import tree_map
from blah2_tpu_torch.dsp import graph as graph_mod
from blah2_tpu_torch.dsp.graph import StaticCall
from blah2_tpu_torch.ops.halo import HaloKernel
from blah2_tpu_torch.parallel import collectives as coll
from blah2_tpu_torch.parallel import distributed
from blah2_tpu_torch.parallel import sharded as sharded_mod
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline, graph_mode
from blah2_tpu_torch.runtime.radar import RadarRuntime
from tests.test_torch_runtime import _run_bounded
from tests.test_torch_sharded import SCENE, _batch, _scene

torch.set_num_threads(1)

_FUSED = {"use_fused_detect": True, "halo_backend": "pallas"}
#: The algorithms of the sharded path: (scene changes, pipeline settings).
ALGORITHMS = {
    "wiener-fused": ({}, _FUSED),
    "wiener-replicated": ({}, {"row_shard": False}),
    "eca-b": ({"process__clutter__filter": "eca-b"}, _FUSED),
    "nlms": ({"process__clutter__filter": "nlms"}, _FUSED),
    "nlms-ranks-in-turn": ({"process__clutter__filter": "nlms"},
                           {**_FUSED, "nlms_batch_ranks": False}),
    "nsub4": ({"process__spectrum": {"nSub": 4}}, _FUSED),
    "os": ({"process__detection__cfar": "os"}, {"halo_backend": "pallas"}),
}
SHAPES = {"1x4": (1, 4), "2x2": (2, 2)}


def _mesh(shape):
    return make_radar_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _pipe(name, shape, dtype=torch.complex64):
    changes, kw = ALGORITHMS[name]
    kw = dict(kw)
    batch_ranks = kw.pop("nlms_batch_ranks", True)
    sp = ShardedCpiPipeline(config_from_dict(_scene(**changes)),
                            _mesh(shape), dtype=dtype, **kw)
    sp.nlms_batch_ranks = batch_ranks
    return sp, _scene(**changes)


def _leaves(out):
    return [out.db_map, out.noise_power, out.max_power, out.spectrum_db,
            out.clutter_ok, *out.detections, out.sub_spectra_db]


def _assert_bits(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _body_call(sp, planes):
    """The StaticCall the sharded step's graph records, made as
    ``ShardedCpiPipeline._capture`` makes it, without the capture."""
    flat = [*planes[0], *planes[1]]
    return StaticCall(sp._flat_step, flat, sp.device,
                      meshes=(sp.mesh,)), flat


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ALGORITHMS)
def test_step_body_gives_the_eager_bits(name, shape):
    """The recorded body over the static buffers on two batches gives the
    eager step's bits, the pipeline's row layout as its algorithm asks."""
    sp, d = _pipe(name, SHAPES[shape])
    assert sp._row_shard is (name != "wiener-replicated")
    b = max(2, sp.n_cpi_axis)
    batches = [sp.shard_inputs(*_batch(d, b=b, seed=s)) for s in (1, 2)]
    call, _ = _body_call(sp, batches[0])
    for planes in batches:
        _assert_bits(call(*planes[0], *planes[1]), sp(*planes))
        _assert_bits(sp._step(*planes), sp(*planes))
    if name == "nsub4":
        assert sp(*batches[0]).sub_spectra_db.shape[:2] == (b, 4)


@pytest.mark.parametrize("dtype", ["c128", "c64"])
@pytest.mark.parametrize("name", [n for n in ALGORITHMS
                                  if n != "nlms-ranks-in-turn"])
def test_step_body_matches_jax(name, dtype):
    """The recorded body on 1 × 4 ranks against JAX's sharded step (its
    Pallas detector in interpret mode where the port fuses)."""
    tdt, jdt = {"c128": (torch.complex128, jnp.complex128),
                "c64": (torch.complex64, jnp.complex64)}[dtype]
    sp, d = _pipe(name, (1, 4), dtype=tdt)
    fused = sp.fused_detector is not None
    ref = JaxSharded(jax_config(d), jax_mesh(1, 4, devices=jax.devices()[:4]),
                     dtype=jdt, row_shard=sp._row_shard,
                     use_pallas_detect=fused)
    xb, yb = _batch(d, b=1, seed=4)
    planes = sp.shard_inputs(xb, yb)
    call, flat = _body_call(sp, planes)
    out = call(*flat)
    jout = ref(*ref.shard_inputs(xb, yb))
    db, jdb = out.db_map.numpy(), np.asarray(jout.db_map)
    assert db.shape == jdb.shape == (1, 41, 66)
    noise, jnoise = out.noise_power.numpy(), np.asarray(jout.noise_power)
    maxp, jmaxp = out.max_power.numpy(), np.asarray(jout.max_power)
    if dtype == "c128":
        atol = 2e-4 if fused else 1e-6
        for got, want in ((db, jdb), (noise, jnoise), (maxp, jmaxp)):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        np.testing.assert_allclose(out.spectrum_db.numpy(),
                                   np.asarray(jout.spectrum_db), atol=1e-6)
        v, jv = out.detections.valid[0].numpy(), \
            np.asarray(jout.detections.valid)[0]
        assert set(zip(out.detections.row[0].numpy()[v].tolist(),
                       out.detections.col[0].numpy()[v].tolist())) == \
            set(zip(np.asarray(jout.detections.row)[0][jv].tolist(),
                    np.asarray(jout.detections.col)[0][jv].tolist()))
    else:
        np.testing.assert_allclose(db, jdb, rtol=0, atol=0.05)
        np.testing.assert_allclose(noise, jnoise, rtol=0, atol=1e-3)
        np.testing.assert_allclose(maxp, jmaxp, rtol=0, atol=1e-3)
    if jout.sub_spectra_db is not None:
        np.testing.assert_allclose(out.sub_spectra_db.numpy(),
                                   np.asarray(jout.sub_spectra_db),
                                   atol=1e-6 if dtype == "c128" else 1e-3)
    np.testing.assert_array_equal(out.clutter_ok.numpy(),
                                  np.asarray(jout.clutter_ok))


# -- the replay path, through a stand-in graph -------------------------------

def _uncounted(mesh, fn):
    """``fn()`` with the wrappers' counts and ``mesh``'s log left as they
    were: a replay runs no Python."""
    before = graph_mod.counts()
    saved, mesh.comm_log = mesh.comm_log, None
    try:
        return fn()
    finally:
        after = graph_mod.counts()
        graph_mod.add_counts({k: v - before[k] for k, v in after.items()},
                             -1)
        mesh.comm_log = saved


class _StandInGraph:
    """Reruns a StaticCall's body into the call's fixed output buffers,
    uncounted, as a CUDA graph writes its static outputs on a replay."""

    def __init__(self, call):
        self.call = call
        self.replays = 0

    def replay(self):
        call = self.call
        fresh = _uncounted(call.meshes[0],
                           lambda: call.body(*call.inputs))
        for buf, new in zip(_leaves(call.outputs), _leaves(fresh)):
            if buf is not None:
                buf.copy_(new)
        self.replays += 1


class _CpuGraphCall(StaticCall):
    """StaticCall whose capture runs the warm-up on the CPU, then the body
    under ``record`` (what a capture counts taken back) into the outputs a
    stand-in graph rewrites."""

    def capture(self, *inputs):
        self._load(inputs)
        warm = self.body(*self.inputs)
        self.outputs = self.record(
            lambda: tree_map(torch.clone, self.body(*self.inputs)))
        self.graph = _StandInGraph(self)
        return warm


@pytest.fixture
def stand_in(monkeypatch):
    """Sharded pipelines capture through the stand-in, and the halo
    wrapper counts on the CPU what the kernel counts on one card: a launch
    a call, a ``kernel`` pair per rank with a source."""
    monkeypatch.setattr(sharded_mod, "StaticCall", _CpuGraphCall)
    call = HaloKernel.__call__

    def counting(self, bufs, mesh, *args, **kw):
        out = call(self, bufs, mesh, *args, **kw)
        self.add_launches(1, {"kernel": mesh.size - mesh.shape["cpi"]})
        return out

    monkeypatch.setattr(HaloKernel, "__call__", counting)

    def make(name, shape=(1, 4)):
        sp, d = _pipe(name, shape)
        sp.graph = True
        return sp, d
    return make


def _ops(ops):
    return [(op.kind, op.shape, op.dtype, op.bytes_per_rank) for op in ops]


@pytest.mark.parametrize("name", ["wiener-fused", "os"])
def test_replays_copy_inputs_clone_outputs_and_count_once(stand_in, name):
    """The first call captures and returns the warm-up's products, counted
    as one eager step; each replay then counts the halo kernel's launches
    and pairs and logs the collectives of one eager step, the capture's
    taken back; a returned product is unchanged by the next replay."""
    sp, d = stand_in(name)
    hooks = []
    sp.before_capture = lambda: hooks.append(1)
    batches = [sp.shard_inputs(*_batch(d, b=1, seed=s)) for s in (1, 2)]
    eager = []
    for planes in batches:
        before = graph_mod.counts()
        with coll.count_bytes(sp.mesh) as ops:
            eager.append(sp._step(*planes))
        step = {k: v - before[k] for k, v in graph_mod.counts().items()}
        step_ops = _ops(ops)
    assert step["halo"] == (6 if name == "wiener-fused" else 4)
    assert step["halo_kernel"] == 3 * step["halo"]

    before = graph_mod.counts()
    with coll.count_bytes(sp.mesh) as ops:
        first = sp(*batches[0])
    _assert_bits(first, eager[0])
    assert {k: v - before[k] for k, v in graph_mod.counts().items()} == step
    assert _ops(ops) == step_ops
    (call,) = sp.graphs.values()
    assert call.counts == {k: v for k, v in step.items() if v}
    assert _ops(call.ops[0]) == step_ops and hooks == [1]

    before = graph_mod.counts()
    with coll.count_bytes(sp.mesh) as ops:
        a = sp(*batches[0])
        kept = tree_map(torch.clone, a)
        b = sp(*batches[1])
    assert {k: v - before[k] for k, v in graph_mod.counts().items()} == \
        {k: 2 * v for k, v in step.items()}
    assert _ops(ops) == 2 * step_ops
    assert call.graph.replays == 2 and hooks == [1]
    _assert_bits(a, kept)
    _assert_bits(a, eager[0])
    _assert_bits(b, eager[1])
    assert not torch.equal(a.db_map, b.db_map)
    with pytest.raises(ValueError, match="buffer"):
        sp.graphs[next(iter(sp.graphs))](*batches[0][0][:3], None,
                                         *batches[0][1])


@pytest.mark.parametrize("name", ["wiener-fused", "nlms"])
def test_replays_hold_no_state_of_an_earlier_step(stand_in, name):
    """Three different batches, then the first again, through one graph:
    each gives its own eager bits."""
    sp, d = stand_in(name)
    batches = [sp.shard_inputs(*_batch(d, b=1, seed=s)) for s in (5, 6, 7)]
    want = [sp._step(*planes) for planes in batches]
    for k in (0, 1, 2, 0):
        _assert_bits(sp(*batches[k]), want[k])
    (call,) = sp.graphs.values()
    assert call.graph.replays == 3


def test_one_graph_per_layout(stand_in):
    """A graph per batch size, and per setting the step reads (the halo
    backend, NLMS's batched ranks); a batch of a captured layout replays
    that layout's graph."""
    sp, d = stand_in("nlms", shape=(2, 2))
    xb, yb = _batch(d, b=4, seed=3)
    for b in (2, 4, 2):
        _assert_bits(sp(*sp.shard_inputs(xb[:b], yb[:b])),
                     sp._step(*sp.shard_inputs(xb[:b], yb[:b])))
    assert len(sp.graphs) == 2
    sp.nlms_batch_ranks = False
    sp(*sp.shard_inputs(xb[:2], yb[:2]))
    sp.halo_backend = "ppermute"
    sp(*sp.shard_inputs(xb[:2], yb[:2]))
    assert len(sp.graphs) == 4
    key = sp._layout([None if t is None else (tuple(t.shape), t.dtype)
                      for planes in sp.shard_inputs(xb[:2], yb[:2])
                      for t in planes])
    call = sp.graphs[key]
    replays = call.graph.replays
    planes = sp.shard_inputs(xb[2:], yb[2:])
    _assert_bits(sp(*planes), sp._step(*planes))
    assert call.graph.replays == call.replays == replays + 1
    assert len(sp.graphs) == 4


@pytest.mark.parametrize("cut", [-7, 0, 9])
@pytest.mark.parametrize("shape", SHAPES)
def test_shard_inputs_gives_the_padded_batchs_planes(shape, cut):
    """Each rank's planes, filled in one pass from the host batch, are its
    block of the batch zero-padded (or cut) to n_pad, split into real and
    imaginary planes: for a batch shorter than n_samples, as long, and
    longer than n_pad."""
    sp, d = _pipe("wiener-fused", SHAPES[shape])
    xb, yb = _batch(d, b=2 * SHAPES[shape][0], seed=8)
    n = (sp.n_pad + cut) if cut > 0 else xb.shape[1] + cut
    xb = np.pad(xb, ((0, 0), (0, max(0, n - xb.shape[1]))))[:, :n]
    b_loc = xb.shape[0] // sp.n_cpi_axis
    want = np.zeros((xb.shape[0], sp.n_pad), xb.dtype)
    want[:, :min(n, sp.n_pad)] = xb[:, :sp.n_pad]
    planes = np.stack([want.real, want.imag], -1).astype(np.float32)
    got, _ = sp.shard_inputs(xb, xb)
    for r in sp.mesh.local_ranks:
        c, p = sp.mesh.coords(r)
        assert got[r].dtype == torch.float32
        np.testing.assert_array_equal(
            got[r].numpy(), planes[c * b_loc:(c + 1) * b_loc,
                                   p * sp.block_len:(p + 1) * sp.block_len])


def test_a_dropped_pipeline_frees_its_graphs_at_once(stand_in):
    """The graph holds the step as a weak method: dropping the pipeline
    that holds the graph frees both without the cyclic collector, and the
    graph's body then raises."""
    import gc
    import weakref

    sp, d = stand_in("wiener-fused")
    planes = sp.shard_inputs(*_batch(d, b=1, seed=1))
    for _ in range(2):
        sp(*planes)
    (call,) = sp.graphs.values()
    gone = weakref.ref(sp)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del sp
        assert gone() is None
    finally:
        if collecting:
            gc.enable()
    with pytest.raises(ReferenceError, match="owner is gone"):
        call.body


def test_mesh_runtime_through_the_graph_emits_the_eager_loops_products(
        stand_in):
    """Six windows through the mesh runtime's loop on 2 × 2 ranks (three
    batches, deferred fetch), eager and through the stand-in graph: six
    product sets in order, each the eager loop's bits; the first batch
    captures, the other two replay."""
    cfg = config_from_dict(_scene(process__data__buffer=8))
    xb, yb = _batch(SCENE, b=6, seed=21)
    runs = {}
    for kind in ("eager", "graph"):
        rt = RadarRuntime(cfg, mesh=_mesh((2, 2)), halo_backend="pallas")
        assert rt.sharded.graph is False and rt.defer_fetch
        if kind == "graph":
            rt.sharded.graph = True
        outs, stamps = [], []
        emit = rt._emit_products

        def keep(out, t0, _outs=outs, _stamps=stamps, _emit=emit, **kw):
            _outs.append(out)
            _stamps.append(t0)
            return _emit(out, t0, **kw)

        rt._emit_products = keep
        for x, y in zip(xb, yb):
            rt.buffer1.push(x.astype(np.complex64))
            rt.buffer2.push(y.astype(np.complex64))
        _run_bounded(rt, 6)
        assert stamps == sorted(stamps)
        runs[kind] = (outs, rt)
    outs, rt = runs["graph"]
    assert len(outs) == len(runs["eager"][0]) == 6
    (call,) = rt.sharded.graphs.values()
    assert call.graph.replays == 2
    for a, b in zip(outs, runs["eager"][0]):
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            assert (x is None and y is None) or np.array_equal(x, y)
    assert not np.array_equal(outs[0].db_map, outs[1].db_map)


# -- where the step stays eager ---------------------------------------------

def test_graphs_need_a_card():
    mesh = _mesh((1, 4))
    on, why = graph_mode(mesh)
    assert not on and why.startswith("the ranks are on cpu")
    sp = ShardedCpiPipeline(config_from_dict(SCENE), mesh)
    assert sp.graph is False and "cpu" in sp.graph_reason
    with pytest.raises(ValueError, match="CUDA graph needs a card"):
        ShardedCpiPipeline(config_from_dict(SCENE), mesh, graph=True)
    assert graph_mode(mesh, False) == (False, "graph=False")


@pytest.mark.parametrize("cards", [2, 4])
def test_several_cards_capture_and_say_so(cards):
    """A 1 × 4 mesh over two or four cards of one process (described, not
    built on: no card here): "auto" and True capture, and the reason names
    the cards."""
    devices = [torch.device("cuda", r * cards // 4) for r in range(4)]
    mesh = make_radar_mesh(1, 4, devices=devices)
    names = ", ".join(f"cuda:{c}" for c in range(cards))
    for graph in ("auto", True):
        on, why = graph_mode(mesh, graph)
        assert on and why == f"every rank of this process on {names}, " \
            f"one process"


def _as_job(monkeypatch, backend, index=0, count=2, reason=""):
    """The meshes built next those of process ``index`` of a ``backend``
    job (as ``test_torch_multiprocess.py``'s ``as_process``)."""
    monkeypatch.setattr(distributed, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_index", lambda: index)
    monkeypatch.setattr(distributed, "job", lambda: distributed.Job(
        backend, reason, ("",) * count, (), None))


@pytest.mark.parametrize("index", [0, 1])
def test_nccl_processes_capture_and_say_so(monkeypatch, index):
    """Each process of a two-process NCCL job, two cards of its own: both
    decide to capture from the layout alone, each naming its cards and its
    place in the job."""
    _as_job(monkeypatch, "nccl", index)
    own = [torch.device("cuda", 2 * index + k) for k in range(2)]
    mesh = make_radar_mesh(1, 4, devices=own)
    for graph in ("auto", True):
        on, why = graph_mode(mesh, graph)
        assert on and why == (
            f"every rank of this process on cuda:{2 * index}, "
            f"cuda:{2 * index + 1}, process {index} of 2: the NCCL "
            f"payloads captured")


def test_several_processes_stay_eager_and_say_why(monkeypatch):
    """Process 0 of two in a gloo job (the mesh stand-in of
    ``test_torch_multiprocess.py``'s ``as_process``): "auto" builds an
    eager pipeline that says why; True raises. Processes that share a
    card are gloo too, and stay eager by the same rule."""
    _as_job(monkeypatch, "gloo", reason="a process computes on the host")
    mesh = make_radar_mesh(1, 4, devices=["cpu"] * 2)
    assert mesh.process_count == 2
    sp = ShardedCpiPipeline(config_from_dict(SCENE), mesh)
    assert sp.graph is False
    assert sp.graph_reason.startswith(
        "the mesh spans 2 processes over gloo (a process computes on the "
        "host): the payloads travel through host memory")
    with pytest.raises(ValueError, match="2 processes over gloo.*host "
                       "memory"):
        ShardedCpiPipeline(config_from_dict(SCENE), mesh, graph=True)
    _as_job(monkeypatch, "gloo", reason="processes share a card")
    shared = make_radar_mesh(1, 4, devices=[torch.device("cuda", 0)] * 2)
    on, why = graph_mode(shared)
    assert not on and "over gloo (processes share a card)" in why
    with pytest.raises(ValueError, match="over gloo"):
        graph_mode(shared, True)


def test_static_call_makes_each_buffer_on_its_inputs_device():
    """Each static buffer lies on its input's device, like the input, and
    a host input's on the home device (the call copies it in); the home
    device comes first among the call's cards; a capture needs every one
    of them to be a card."""
    inputs = [torch.zeros(3, 2), None,
              torch.zeros(4, dtype=torch.complex64, device="meta"),
              torch.zeros(5, dtype=torch.float64, device="meta")]
    call = StaticCall(lambda *b: b, inputs, torch.device("cpu"))
    assert [None if b is None else (b.device.type, tuple(b.shape), b.dtype)
            for b in call.inputs] == [
        ("cpu", (3, 2), torch.float32), None,
        ("meta", (4,), torch.complex64), ("meta", (5,), torch.float64)]
    assert call.cards == [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="needs a card.*cpu, meta"):
        call.capture(*inputs)
    home = StaticCall(lambda *b: b, inputs[:1], torch.device("meta"))
    assert home.inputs[0].device.type == "meta"
    assert home.cards == [torch.device("meta")]


def test_shutdown_frees_the_registered_graphs_before_the_groups_go(
        monkeypatch):
    """A graph that captured NCCL calls is freed when the job is left,
    before its groups go (their communicator waits for such graphs), and a
    later call raises rather than run the body eagerly; a graph already
    dropped is not kept alive for it."""
    events = []
    monkeypatch.setattr(distributed, "_job", distributed.Job(
        "nccl", "", ("",), (), None))
    monkeypatch.setattr(torch.distributed, "barrier",
                        lambda: events.append("barrier"))
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda: events.append("destroy"))
    calls = [StaticCall(lambda *b: b[0], [torch.zeros(2)],
                        torch.device("cpu")) for _ in range(2)]
    for call in calls:
        call.graph, call.outputs = object(), torch.ones(2)
        distributed.at_shutdown(call.release)
    distributed.at_shutdown(lambda: events.append("hook"))
    gone = calls.pop()
    del gone
    distributed.shutdown()
    assert events == ["hook", "barrier", "destroy"]
    assert calls[0].graph is None and calls[0].outputs is None
    assert distributed.job() is None and distributed._at_shutdown == []
    with pytest.raises(ReferenceError, match="freed at shutdown"):
        calls[0](torch.ones(2))
