"""The function the port's CUDA graph records (``dsp/graph.py``
``StaticCall`` over the pipeline's entry bodies), run eagerly on the CPU.

There is no CUDA graph on the CPU, so these tests hold what the graph
records: the body over its static buffers gives the bits of the eager
entries ``call_quad12`` and ``call_chunks`` for Wiener/CA, ECA-B, NLMS,
OS-CFAR and nSub 2, and agrees with the JAX package's ``call_quad12`` and
``call_chunks`` at the suites' bars (complex128: the map within 1e-6 dB and
identical detection sets; complex64: the bounds of
``test_torch_pipeline.py::test_pipeline_complex64_matches_jax``). The replay
path (input copies, the outputs cloned, the detect kernel's launches
counted) runs against a stand-in graph that reruns the body into fixed
output buffers, as a CUDA graph writes its static outputs; through it the
runtime's single-device loop must emit N product sets for N CPIs, in order,
with the eager loop's bits. The card's own checks are ``chip_smoke.py``
``phase_graph`` and ``phase_runtime``."""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.dsp.pipeline import CpiPipeline as JaxPipeline
from blah2_tpu_torch.capture.source import Source
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.device import tree_map
from blah2_tpu_torch.dsp import graph as graph_mod
from blah2_tpu_torch.dsp import pipeline as pipeline_mod
from blah2_tpu_torch.dsp.graph import StaticCall, as_tensor
from blah2_tpu_torch.dsp.pipeline import CpiPipeline
from blah2_tpu_torch.ops.detect import detect
from blah2_tpu_torch.ops.pack12 import pack12_planes, pack12_quads
from blah2_tpu_torch.runtime.radar import RadarRuntime

torch.set_num_threads(1)

# The scene of the verify recipe: fs 200 kHz, CPI 0.1 s, delay −10..100.
SCENE = {
    "capture": {"fs": 200_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.1},
        "ambiguity": {"delayMin": -10, "delayMax": 100, "dopplerMin": -200,
                      "dopplerMax": 200},
        "clutter": {"enable": True, "delayMin": -10, "delayMax": 100},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2, "nTrain": 6,
                      "minDelay": 5, "minDoppler": 15, "nCentroid": 6},
    },
}
CASES = {
    "wiener-ca": {},
    "eca-b": {"clutter": {"filter": "eca-b", "nBatches": 4}},
    "nlms": {"clutter": {"filter": "nlms", "mu": 0.1}},
    "os": {"detection": {"cfar": "os", "osRank": 0.75}},
    "nsub2": {"spectrum": {"nSub": 2}},
}
N_CHUNKS = 4


def _config(name):
    d = {k: dict(v) if isinstance(v, dict) else v for k, v in SCENE.items()}
    d["process"] = {k: dict(v) for k, v in SCENE["process"].items()}
    for stage, kv in CASES[name].items():
        d["process"].setdefault(stage, {}).update(kv)
    return d


def _quads(seed):
    """A 20,000-sample CPI with two targets, as 12-bit int16 quads."""
    x, y = synthetic_cpi(20_000, 200_000, [TargetSpec(40, -77.0, 0.05),
                                           TargetSpec(61, 112.0, 0.03)],
                         clutter_amplitude=3.0, noise_amplitude=1e-3,
                         seed=seed)
    return np.clip(np.round(np.stack([x.real, x.imag, y.real, y.imag],
                                     axis=1) * 150), -2048, 2047
                   ).astype(np.int16)


@pytest.fixture(scope="module")
def cpis():
    return [_quads(seed) for seed in (7, 8)]


def _chunks(quads):
    split = np.split(np.arange(quads.shape[0]), N_CHUNKS)
    return ([pack12_planes(quads[i, :2]) for i in split],
            [pack12_planes(quads[i, 2:]) for i in split])


def _leaves(out):
    leaves = []
    for v in out:
        leaves.extend(v if isinstance(v, tuple) else [v])
    return leaves


def _assert_bits(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_complex():
            x, y = torch.view_as_real(x), torch.view_as_real(y)
        assert torch.equal(x, y)


def _body_call(pipe, entry, quads):
    """A StaticCall over ``entry``'s body, made for ``quads``, and the
    inputs the entry takes."""
    if entry == "quad12":
        inputs = (pack12_quads(quads),)
        body = pipe.run_quad12
    else:
        xc, yc = _chunks(quads)
        inputs = (*xc, *yc)
        n = len(xc)

        def body(*ch):
            return pipe.run_chunks(ch[:n], ch[n:])
    tensors = [as_tensor(a) for a in inputs]
    return StaticCall(body, tensors, torch.device("cpu")), tensors


def _eager(pipe, entry, quads):
    if entry == "quad12":
        return pipe.call_quad12(pack12_quads(quads))
    return pipe.call_chunks(*_chunks(quads))


@pytest.mark.parametrize("entry", ["quad12", "chunks"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_body_gives_the_eager_entrys_bits(cpis, name, entry):
    """The body over its static buffers against the eager entry, the fused
    detector's plain twin on (the card's path)."""
    pipe = CpiPipeline(config_from_dict(_config(name)), fused_detect=True,
                       device="cpu")
    assert not pipe.graph
    call, inputs = _body_call(pipe, entry, cpis[0])
    got = call(*inputs)
    _assert_bits(got, _eager(pipe, entry, cpis[0]))
    if name == "nsub2":
        assert got.sub_spectra_db.shape == (2, pipe.spectrum.n_spectrum)
    assert not pipe.graphs


def _dets(det):
    v = np.asarray(det.valid)
    return set(zip(np.asarray(det.row)[v].tolist(),
                   np.asarray(det.col)[v].tolist()))


@pytest.mark.parametrize("entry", ["quad12", "chunks"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_body_matches_jax_complex128(cpis, name, entry):
    d = _config(name)
    pipe = CpiPipeline(config_from_dict(d), dtype=torch.complex128,
                       device="cpu")
    ref = JaxPipeline(jax_config(d), dtype=jnp.complex128, use_pallas=False)
    call, inputs = _body_call(pipe, entry, cpis[0])
    out = call(*inputs)
    jout = ref.call_quad12(pack12_quads(cpis[0])) if entry == "quad12" \
        else ref.call_chunks(*_chunks(cpis[0]))
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               rtol=0, atol=1e-6)
    assert abs(float(out.noise_power) - float(jout.noise_power)) < 1e-6
    assert bool(out.clutter_ok) == bool(jout.clutter_ok) is True
    assert _dets(out.detections) == _dets(jout.detections)
    assert len(_dets(jout.detections)) >= 1
    if name == "nsub2":
        np.testing.assert_allclose(out.sub_spectra_db.numpy(),
                                   np.asarray(jout.sub_spectra_db),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["wiener-ca", "nsub2"])
def test_body_matches_jax_complex64(cpis, name):
    """The card's path (complex64, fused detector) against JAX's Pallas
    detector in interpret mode, at the complex64 bars."""
    d = _config(name)
    pipe = CpiPipeline(config_from_dict(d), fused_detect=True, device="cpu")
    ref = JaxPipeline(jax_config(d), use_pallas=True)
    call, inputs = _body_call(pipe, "quad12", cpis[0])
    out = call(*inputs)
    jout = ref.call_quad12(pack12_quads(cpis[0]))
    np.testing.assert_allclose(out.db_map.numpy(), np.asarray(jout.db_map),
                               atol=0.05)
    assert abs(float(out.noise_power) - float(jout.noise_power)) <= 1e-4
    assert abs(float(out.max_power) - float(jout.max_power)) <= 1e-3
    assert _dets(out.detections) == _dets(jout.detections)
    v = np.asarray(jout.detections.valid)
    np.testing.assert_allclose(out.detections.snr.numpy()[v],
                               np.asarray(jout.detections.snr)[v],
                               atol=2e-3)


@pytest.mark.parametrize("name", ["wiener-ca", "nlms"])
def test_static_buffers_hold_no_state_of_an_earlier_cpi(cpis, name):
    """Two different CPIs through the same static buffers, then the first
    again: each gives its own eager bits."""
    pipe = CpiPipeline(config_from_dict(_config(name)), fused_detect=True,
                       device="cpu")
    call, _ = _body_call(pipe, "quad12", cpis[0])
    for quads in (cpis[0], cpis[1], cpis[0]):
        _assert_bits(call(as_tensor(pack12_quads(quads))),
                     _eager(pipe, "quad12", quads))
    assert not torch.equal(_eager(pipe, "quad12", cpis[0]).db_map,
                           _eager(pipe, "quad12", cpis[1]).db_map)


class _StandInGraph:
    """Replays a StaticCall's body into the call's fixed output buffers,
    as a CUDA graph writes its static outputs on every replay."""

    def __init__(self, call):
        self.call = call
        self.replays = 0

    def replay(self):
        fresh = self.call.body(*self.call.inputs)
        for buf, new in zip(_leaves(self.call.outputs), _leaves(fresh)):
            if buf is not None:
                buf.copy_(new)
        self.replays += 1


class _CpuGraphCall(StaticCall):
    """StaticCall whose capture runs the warm-up on the CPU and installs a
    stand-in graph (the test's replacement for a card)."""

    def capture(self, *inputs):
        self._load(inputs)
        warm = self.body(*self.inputs)
        self.outputs = tree_map(torch.clone, warm)
        self.graph = _StandInGraph(self)
        return warm


def test_replays_copy_inputs_clone_outputs_and_count_launches(cpis):
    """The replay path: the inputs copied into the buffers, a returned
    product unchanged by the next replay, each replay's launches added to
    the detect wrapper's count."""
    pipe = CpiPipeline(config_from_dict(_config("wiener-ca")),
                       fused_detect=True, device="cpu")
    packed = [as_tensor(pack12_quads(q)) for q in cpis]
    call = _CpuGraphCall(pipe.run_quad12, packed[:1], torch.device("cpu"))
    first = call.capture(packed[0])
    _assert_bits(first, pipe.call_quad12(packed[0]))
    call.counts = {"detect": 1}
    before = detect.launches
    a = call(packed[0])
    kept = tree_map(torch.clone, a)
    b = call(packed[1])
    _assert_bits(a, kept)
    _assert_bits(b, pipe.call_quad12(packed[1]))
    assert not torch.equal(a.db_map, b.db_map)
    assert detect.launches - before == 2 and call.graph.replays == 2
    detect.add_launches(-2)
    with pytest.raises(ValueError, match="buffer"):
        call(as_tensor(pack12_quads(cpis[0][:-2])))


def test_graphs_need_a_card():
    cfg = config_from_dict(_config("wiener-ca"))
    with pytest.raises(ValueError, match="CUDA"):
        CpiPipeline(cfg, graph=True, device="cpu")
    pipe = CpiPipeline(cfg, device="cpu")
    assert not pipe.graph
    call = StaticCall(pipe.run_quad12, [torch.zeros(30_000,
                                                    dtype=torch.uint8)],
                      torch.device("cpu"))
    with pytest.raises(ValueError, match="needs a card"):
        call.capture(torch.zeros(30_000, dtype=torch.uint8))


def test_entries_key_one_graph_per_layout(cpis, monkeypatch):
    """Through ``_entry`` with the stand-in: one capture per (entry,
    layout), one per chunk count, each later call a replay."""
    monkeypatch.setattr(pipeline_mod, "StaticCall", _CpuGraphCall)
    pipe = CpiPipeline(config_from_dict(_config("wiener-ca")),
                       fused_detect=True, device="cpu")
    pipe.graph = True
    hooks = []
    pipe.before_capture = lambda: hooks.append(1)
    for quads in (cpis[0], cpis[1]):
        _assert_bits(pipe.call_quad12(pack12_quads(quads)),
                     pipe.run_quad12(pack12_quads(quads)))
        _assert_bits(pipe.call_chunks(*_chunks(quads)),
                     pipe.run_chunks(*_chunks(quads)))
    two = np.split(np.arange(cpis[0].shape[0]), 2)
    pipe.call_chunks([pack12_planes(cpis[0][i, :2]) for i in two],
                     [pack12_planes(cpis[0][i, 2:]) for i in two])
    names = sorted(k[0] for k in pipe.graphs)
    assert names == ["chunks2", f"chunks{N_CHUNKS}", "quad12"]
    assert len(hooks) == 3
    assert all(c.graph.replays >= 1 for k, c in pipe.graphs.items()
               if k[0] != "chunks2")


def _replay_config(fname):
    return config_from_dict({
        "capture": {"fs": 200_000, "fc": 204_640_000,
                    "replay": {"state": True, "loop": True, "file": fname}},
        "process": {**SCENE["process"], "data": {"cpi": 0.1, "buffer": 4}}})


def _run(rt, n, seconds=120.0):
    err = []

    def body():
        try:
            rt.run(n_cpis=n, quiet=True)
        except BaseException as e:  # handed to the test thread
            err.append(e)

    t = threading.Thread(target=body, daemon=True)
    rt.start_capture()
    t.start()
    t.join(seconds)
    rt.stop()
    if t.is_alive():
        t.join(10.0)
        pytest.fail(f"run of {n} CPIs did not end within {seconds} s")
    if err:
        raise err[0]


def test_runtime_through_the_graph_path_emits_the_eager_loops_products(
        cpis, tmp_path, monkeypatch):
    """A looped replay of three different windows, 7 CPIs with a staged
    sample every 3, deferred fetch: through the stand-in graph the loop
    emits 7 product sets in order, each the eager loop's bits."""
    src = Source("RspDuo", 200_000, 204_640_000, path=str(tmp_path))
    fname = src.open_record_file()
    for q in (*cpis, _quads(9)):
        src.record(q[:, 0] + 1j * q[:, 1], q[:, 2] + 1j * q[:, 3])
    src.close_record_file()
    n = 7
    runs = {}
    for kind in ("eager", "graph"):
        rt = RadarRuntime(_replay_config(fname), staged_sample_every=3,
                          staged_warmup="sync", device="cpu")
        if kind == "graph":
            monkeypatch.setattr(pipeline_mod, "StaticCall", _CpuGraphCall)
            rt.pipeline.graph = True
        assert rt.defer_fetch and rt.ingest_chunks == 8
        outs, stamps = [], []
        emit = rt._emit_products

        def keep(out, t0, _outs=outs, _stamps=stamps, _emit=emit, **kw):
            _outs.append(out)
            _stamps.append(t0)
            return _emit(out, t0, **kw)

        rt._emit_products = keep
        _run(rt, n)
        runs[kind] = (outs, stamps, rt)
    outs, stamps, rt = runs["graph"]
    assert len(outs) == len(runs["eager"][0]) == n
    assert stamps == sorted(stamps)
    (call,) = rt.pipeline.graphs.values()
    # CPIs 0, 3 and 6 are staged samples; CPI 1 captures; 2, 4, 5 replay.
    assert call.graph.replays == 3
    for a, b in zip(outs, runs["eager"][0]):
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            assert (x is None and y is None) or np.array_equal(x, y)
    assert not np.array_equal(outs[1].db_map, outs[2].db_map)


def test_capture_error_names_the_failing_line():
    def body(t):
        return t.nonexistent_op()

    err = graph_mod.GraphCaptureError("x")
    assert isinstance(err, RuntimeError)
    try:
        body(torch.zeros(1))
    except AttributeError as e:
        where = graph_mod._failing_line(e)
    assert "test_torch_graph.py" in where and "nonexistent_op" in where
