"""The runtime's spans (``runtime/spans.py``) on the CPU: every timing
document of every path carries every span key once, the keys add up as
``runtime/radar.py`` defines them, the CLI's ``--profile-dir`` trace holds
the spans on the profiler's clock, and the benchmark's readers of the new
keys take their means."""

from __future__ import annotations

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import manifest
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.net.stash import TimingStash
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.runtime import cli, spans
from blah2_tpu_torch.runtime.radar import RadarRuntime
from tests.test_torch_runtime import REF_KEYS, _run_bounded, _spy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config-synthetic.yml")
DOC_KEYS = {"timestamp", "nCpi", "uptime_s", "uptime_days"}
FULL = set(REF_KEYS) | {"wire_transfer", "latency"} | set(spans.KEYS)
INGEST = ("ring_pop", "ingest_cast", "ingest_pack", "ingest_copy")


def _cfg(kind="Synthetic"):
    return config_from_dict({
        "capture": {"fs": 40_000, "fc": 100_000_000, "type": kind},
        "process": {
            "data": {"cpi": 0.1, "buffer": 8},
            "ambiguity": {"delayMin": -5, "delayMax": 40,
                          "dopplerMin": -50, "dopplerMax": 50},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 40},
            "detection": {"enable": True, "pfa": 1e-4, "nGuard": 1,
                          "nTrain": 4, "minDelay": 3, "minDoppler": 10,
                          "nCentroid": 4},
            "tracker": {"enable": True}}})


def _windows(count, counts=False, seed=3):
    """Seeded windows; ``counts``: 12-bit ADC counts (an int16 wire that
    packs)."""
    n = _cfg().n_samples
    out = []
    for k in range(count):
        x, y = synthetic_cpi(n, 40_000, [TargetSpec(12, 30.0, 0.3)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=seed + k)
        if counts:
            x, y = (np.round(np.clip(v.real * 300, -2047, 2047))
                    + 1j * np.round(np.clip(v.imag * 300, -2047, 2047))
                    for v in (x, y))
        out.append((x.astype(np.complex64), y.astype(np.complex64)))
    return out


def _push(rt, windows):
    for x, y in windows:
        rt.buffer1.push(x)
        rt.buffer2.push(y)


def _stall_run(rt):
    """Two CPIs, a stall (the extraction times out and flushes the pending
    CPI), then the third."""
    emissions = _spy(rt)
    w = _windows(3)
    _push(rt, w[:2])
    t = threading.Thread(target=rt.run, kwargs={"n_cpis": 3, "quiet": True},
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while sum(p == "timing" for p, _, _ in emissions) < 2:
            assert time.monotonic() < deadline, "stall flush never came"
            time.sleep(0.02)
        _push(rt, w[2:])
        t.join(60.0)
        assert not t.is_alive()
    finally:
        rt.stop()
        t.join(10.0)
    return emissions


#: name -> (runtime arguments, CPIs); each runs through ``run``.
PATHS = {
    "deferred": ({"staged_sample_every": 0}, 3),
    "synchronous": ({"staged_sample_every": 0, "defer_fetch": False}, 3),
    "staged_sample": ({"staged_sample_every": 2, "staged_warmup": "sync"},
                      3),
    "stall_flush": ({"staged_sample_every": 0}, None),
    "staged_timing": ({"staged_timing": True}, 3),
    "unchunked": ({"staged_sample_every": 0, "ingest_chunks": 1}, 3),
    "mesh": ({"mesh": "1x2"}, 2),
}


def _parsed(rt) -> list:
    """Keep each timing document of ``rt`` as it hands it to an
    in-process stash, before the JSON's rounding to 0.01."""
    docs = []
    emit = rt._emit

    def keep(product, payload, parsed=None):
        if product == "timing":
            docs.append(parsed)
        return emit(product, payload, parsed=parsed)

    rt._emit = keep
    return docs


def _run_path(name):
    """Run path ``name``; ``rt.parsed_timing``: its timing documents as
    ``_parsed`` keeps them."""
    kw, n = PATHS[name]
    kw = dict(kw)
    if kw.pop("mesh", None):
        kw["mesh"] = make_radar_mesh(1, 2, devices=["cpu"] * 2)
    rt = RadarRuntime(_cfg(), device="cpu", **kw)
    rt.parsed_timing = _parsed(rt)
    if n is None:
        return rt, _stall_run(rt)
    emissions = _spy(rt)
    _push(rt, _windows(n))
    _run_bounded(rt, n)
    return rt, emissions


@pytest.mark.parametrize("path", list(PATHS))
def test_every_document_carries_every_span_key(path):
    """Each key once and >= 0 on every document of the path, the same key
    set on each (a staged_timing CPI has no ``wire_transfer``, as in the
    JAX runtime), ``output_radar_data`` the sum of ``serialize`` and
    ``publish``, and a TimingStash fed the documents keeps series of one
    length."""
    rt, emissions = _run_path(path)
    payloads = [v for p, v, _ in emissions if p == "timing"]
    assert len(payloads) == rt.n_cpis_done
    want = FULL - DOC_KEYS - ({"wire_transfer"} if path == "staged_timing"
                              else set())
    stash = TimingStash()
    for text, doc in zip(payloads, rt.parsed_timing, strict=True):
        assert json.loads(text).keys() == doc.keys()
        assert set(doc) - DOC_KEYS == want, set(doc) ^ want
        for key in want:
            assert text.count(f'"{key}":') == 1, key
            assert doc[key] >= 0.0, key
        assert abs(doc["output_radar_data"]
                   - doc["serialize"] - doc["publish"]) < 0.01
        stash.update(text)
    lengths = {len(v) for v in json.loads(stash.get()).values()}
    assert lengths == {len(payloads)}


@pytest.mark.parametrize("path", ["deferred", "synchronous", "stall_flush",
                                  "staged_timing", "unchunked", "mesh"])
def test_deferral_only_under_deferred_fetch(path):
    """``deferral`` is the wait from a CPI's dispatch to its flush: > 0
    where products are emitted after the dispatch returns (the mesh's
    batches too), 0 where they are emitted at once. Before a stall, the
    rings run dry in the next CPI's fill, and the deferred CPI, done on
    the card, is emitted there: it does not wait the stall out."""
    rt, emissions = _run_path(path)
    docs = [json.loads(v) for p, v, _ in emissions if p == "timing"]
    if path in ("deferred", "stall_flush", "mesh"):
        assert all(d["deferral"] > 0.0 for d in docs)
    else:
        assert all(d["deferral"] == 0.0 for d in docs)
    if path == "stall_flush":
        # The second CPI's products are out before the 1 s extraction
        # timeout ends the third CPI's wait.
        assert docs[1]["deferral"] < 900.0
        assert (rt.flushed_in_fill, rt.flushed_behind) == (2, 0)


@pytest.mark.parametrize("wire", ["packed", "float32"])
def test_ingest_keys_on_the_chunked_path(wire):
    """Every ingest key > 0 where 12-bit counts pack; on a float32 wire
    nothing packs, and ``ingest_pack`` is 0. Dispatch, fetch and device
    are measured on each fused CPI, and the device's four stages and
    ``wire_transfer`` add up to ``device``."""
    kind = "RspDuo" if wire == "packed" else "Synthetic"
    rt = RadarRuntime(_cfg(kind), device="cpu", staged_sample_every=0)
    docs = _parsed(rt)
    for k, (x, y) in enumerate(_windows(3, counts=wire == "packed")):
        _push(rt, [(x, y)])
        chunks = rt._extract_cpi_chunks(timeout=1.0)
        assert chunks is not None
        if wire == "packed":
            assert chunks[0][0].dtype == torch.uint8
        assert rt.process_one_cpi_chunks(*chunks, timestamp_ms=100 + k) \
            is None
    rt._flush_pending()
    assert len(docs) == 3
    for d in docs:
        for key in ("ring_pop", "ingest_cast", "ingest_copy", "dispatch",
                    "device"):
            assert d[key] > 0.0, key
        assert (d["ingest_pack"] > 0.0) == (wire == "packed")
        stages = sum(d[k] for k in rt.DEVICE_STAGES)
        assert stages > 0.0
        assert abs(stages + d["wire_transfer"] - d["device"]) < 0.01


class _CardEvent:
    """A timing CUDA event as the runtime uses it, on the host: done at
    once (``busy`` False), or, like a CPI still running on the card, only
    once waited for. Each wait is logged in ``log``."""

    def __init__(self, log, busy=False):
        self.log, self.busy, self.done, self.t = log, busy, not busy, 0

    def record(self, stream=None):
        self.t, self.done = time.perf_counter_ns(), not self.busy

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append("wait")
        self.done = True

    def elapsed_time(self, end):
        assert self.done and end.done, "read before the work was done"
        return (end.t - self.t) / 1e6


def _order(busy) -> list:
    """The calls of four deferred CPIs and the waits for their products
    (the rings full): a CPI done on the card is waited for, at no cost, in
    the next CPI's fill, before that CPI's call; one still running (in
    ``busy``) only behind that call."""
    log = ["call"]
    for k in range(3):
        log += ["call", "wait"] if k in busy else ["wait", "call"]
    return log + ["wait"]


@pytest.mark.parametrize("busy", [(), (0, 1, 2, 3), (1,), (2,)], ids=str)
def test_stage_marks_never_hold_the_next_dispatch(monkeypatch, busy):
    """The runtime's use of the card's events, played on the host: the
    fetch event of each CPI in ``busy`` completes only when waited for, as
    where the card still runs a CPI when the next is dispatched. The next
    CPI is called before any wait for a busy one (that wait falls in the
    busy CPI's own ``fetch_wait``), while a CPI done on the card is
    emitted in the next CPI's fill, before that call; a busy CPI's marks
    are lost and counted, its ``device`` runs from its ``begin`` event to its fetch's,
    split by the stages' shares in the last CPI whose marks were read but
    the first, which captures its graph (none: all of it
    ``wire_transfer``). The last CPI, flushed with no CPI after it, is
    read once waited for."""
    from blah2_tpu_torch.runtime import radar, staging

    log = []
    rt = RadarRuntime(_cfg("RspDuo"), device="cpu", staged_sample_every=0)
    marks = rt.pipeline.stage_marks
    marks.on_card = True
    marks.events = [_CardEvent(log) for _ in marks.stamps]
    marks._begins = [_CardEvent(log), _CardEvent(log)]
    fetches = []

    def start_fetch(out, device):
        event = _CardEvent(log, len(fetches) in busy)
        event.record()
        fetches.append(event)
        return staging.Fetch(staging.tree_map(lambda t: t.detach(), out),
                             event)

    monkeypatch.setattr(radar, "start_fetch", start_fetch)
    call = rt.pipeline.call_chunks

    def logged_call(*a):
        if "call" not in log:  # the first call captures the graph
            rt.pipeline.graphs["captured"] = None
        log.append("call")
        return call(*a)

    monkeypatch.setattr(rt.pipeline, "call_chunks", logged_call)
    docs = _parsed(rt)
    for k, (x, y) in enumerate(_windows(4, counts=True)):
        _push(rt, [(x, y)])
        chunks = rt._extract_cpi_chunks(timeout=1.0)
        assert rt.process_one_cpi_chunks(*chunks, timestamp_ms=100 + k) \
            is None
    rt._flush_pending()
    assert log == _order(busy)
    assert len(docs) == 4
    lost = [k for k in busy if k < 3]
    assert rt.marks_lost == rt.flushed_behind == len(lost)
    assert (rt.flushed_in_fill, rt.flushed_waited) == (3 - len(lost), 0)
    for k, d in enumerate(docs):
        assert d["device"] > 0.0
        stages = [d[name] for name in rt.DEVICE_STAGES]
        assert abs(sum(stages) + d["wire_transfer"] - d["device"]) < 0.01
        if k not in lost:
            assert sum(stages) > 0.0
        elif k <= 1 or k - 1 in lost:
            assert sum(stages) == 0.0
        else:
            before = docs[k - 1]
            for name in rt.DEVICE_STAGES:
                assert d[name] / d["device"] == pytest.approx(
                    before[name] / before["device"])


def test_staged_sample_flush_stays_out_of_its_cpi():
    """A staged sample flushes the deferred CPI first: that flush's wall
    is the flushed CPI's, not the sample's ``cpi``; the sample reports its
    waited-for stages, their sum (and the wire wait) as ``device``."""
    rt = RadarRuntime(_cfg(), device="cpu", staged_sample_every=2,
                      staged_warmup="sync")
    docs = _parsed(rt)
    orig = rt._flush_pending

    def slow_flush():
        if rt._pending_out is not None:
            time.sleep(0.3)
        return orig()

    rt._flush_pending = slow_flush
    _push(rt, _windows(3))
    _run_bounded(rt, 3)
    sample = docs[2]   # CPIs 0 and 2 are staged samples
    assert sample["cpi"] < 250.0
    assert sample["dispatch"] == 0.0 and sample["deferral"] == 0.0
    assert abs(sample["device"] - sample["wire_transfer"] - sum(
        sample[k] for k in rt.DEVICE_STAGES)) < 0.01


def test_cli_profile_trace_holds_the_spans(tmp_path):
    """``--profile-dir`` with staged samples off: the trace holds the
    spans on two named tracks, and every ``aten::cat`` (the eager
    ``run_chunks``, the only caller then) lies inside a ``dispatch`` span,
    each dispatch holding some: the spans are on the profiler's clock."""
    rc = cli.main(["--config", CONFIG, "--device", "cpu", "--no-api",
                   "--cpis", "3", "--staged-sample-every", "0", "--quiet",
                   "--profile-dir", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    got = [e for e in events if e.get("cat") == "span"]
    names = {e["name"] for e in got}
    assert {"ring_wait", "ring_pop", "ingest_cast", "ingest_copy",
            "dispatch", "deferral", "fetch_wait", "serialize",
            "publish"} <= names
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert tracks[spans.TRACK_TID].endswith("spans")
    assert tracks[spans.DEFERRAL_TID].endswith("deferral")
    dispatch = [(e["ts"], e["ts"] + e["dur"]) for e in got
                if e["name"] == "dispatch"]
    assert len(dispatch) == 3
    cats = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == "aten::cat"]
    assert cats
    slack = 50.0   # us
    for a, b in cats:
        assert any(lo - slack <= a and b <= hi + slack
                   for lo, hi in dispatch), (a, b)
    for lo, hi in dispatch:
        assert any(lo - slack <= a and b <= hi + slack for a, b in cats)


def test_span_log_keeps_the_last_spans_on_unix_time():
    """The ring keeps the last ``capacity`` spans in order; the export
    converts through the anchor and names the tracks."""
    log = spans.SpanLog(4)
    log.anchor = (1_000, 5_000_000)
    for k in range(6):
        log.add(spans.DISPATCH if k % 2 else spans.DEFERRAL, k,
                2_000 + 1_000 * k, 2_500 + 1_000 * k)
    assert [s[1] for s in log.spans()] == [2, 3, 4, 5]
    name, cpi, t0, t1 = log.spans()[0]
    assert (name, t0, t1) == ("deferral", 5_003_000, 5_003_500)
    ev = log.trace_events(base_ns=5_000_000, pid=7)
    assert [e["ph"] for e in ev] == ["M", "M", "X", "X", "X", "X"]
    x = ev[2]
    assert (x["ts"], x["dur"], x["tid"], x["args"]) == \
        (3.0, 0.5, spans.DEFERRAL_TID, {"cpi": 2})
    assert ev[3]["tid"] == spans.TRACK_TID


def test_merge_into_trace_adds_the_spans(tmp_path):
    log = spans.SpanLog(8)
    t = time.perf_counter_ns()
    spans.SpanTimer(log, cpi=4).span(spans.PUBLISH, t)
    path = tmp_path / "trace.json"
    base = time.time_ns() - 10_000_000
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": [{"ph": "X"}]}))
    assert spans.merge_into_trace(str(path), log) == 1
    events = json.loads(path.read_text())["traceEvents"]
    (span,) = [e for e in events if e.get("cat") == "span"]
    assert span["name"] == "publish" and span["args"] == {"cpi": 4}
    assert 0.0 < span["ts"] < 20_000.0


def test_span_timer_sums_keys_and_keeps_apart_out():
    st = spans.SpanTimer()
    st.start()
    t = time.perf_counter_ns()
    t = st.span(spans.RING_WAIT, t - 2_000_000)
    st.span(spans.TRACKER, t)
    with st.apart():
        time.sleep(0.05)
    assert st.finish_cpi() < 40.0
    ns = dict(zip(spans.KEYS, st.take()))
    assert ns["ring_wait"] >= 2_000_000 and sum(ns.values()) == ns["ring_wait"]
    assert not any(st.ns)


READERS = {
    "ingest_ms_per_cpi.replay": INGEST,
    "deferral_ms_per_cpi.openloop": ("deferral",),
    "deferral_ms_per_cpi.live": ("deferral",),
    "device_ms_per_cpi.openloop": ("device",),
    "publish_ms_per_cpi.replay": ("publish",),
    "publish_ms_per_cpi.live": ("publish",),
}


@pytest.mark.parametrize("name", list(READERS))
def test_benchmark_reader_takes_the_mean_of_its_keys(name):
    """Each new per-layer metric's reader: the mean over the run's judged
    CPIs of its keys' sum (the device's over fused CPIs alone); None on a
    program whose documents lack them."""
    mod = manifest.load_module(manifest.reader_file(name), "reader_" +
                               name.replace(".", "_"))
    docs = [{k: 1.0 + i + 0.5 * j for j, k in enumerate(spans.KEYS)}
            for i in range(3)]
    want = np.mean([sum(d[k] for k in READERS[name]) for d in docs])
    assert mod.read(SimpleNamespace(timing=docs)) == pytest.approx(want)
    # A staged sample (no dispatch): its device is the host's wall.
    sample = dict(docs[0], dispatch=0.0, device=1e3)
    if name.startswith("device_"):
        assert mod.read(SimpleNamespace(timing=docs + [sample])) == \
            pytest.approx(want)
    assert mod.read(SimpleNamespace(timing=[{"cpi": 1.0}])) is None
