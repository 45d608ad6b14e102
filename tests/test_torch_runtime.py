"""The port's radar runtime and CLI against the JAX package's, on the CPU.

Both runtimes take the same seeded NumPy windows, through the synchronous
and the chunked entries, and their parsed products must agree: the map to
0.05 dB, noise and detections as in test_torch_pipeline.py's complex64 test,
the same tracks and timing key sets. Then the port's own loop: a threaded
synthetic capture under deferred fetch, the flush on a capture stall,
overlap and seam behaviour (as tests/test_overlap.py and
tests/test_chunked_ingest.py hold the JAX runtime), staged samples, and the
refusals of mesh mode. Every run that waits on a capture thread or a ring
does so under a deadline (``_run_bounded``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from blah2_tpu.config import load_config as jax_load_config
from blah2_tpu.runtime.radar import RadarRuntime as JaxRuntime
from blah2_tpu_torch.capture.source import Source
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict, load_config
from blah2_tpu_torch.ops.pack12 import unpack12_np
from blah2_tpu_torch.runtime import cli
from blah2_tpu_torch.runtime.radar import RadarRuntime
from blah2_tpu_torch.runtime.spans import KEYS as SPAN_KEYS
from blah2_tpu_torch.runtime.staging import fetch, start_fetch, tree_map

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config-synthetic.yml")
REF_KEYS = ("extract_buffer", "spectrum", "clutter_filter",
            "ambiguity_processing", "detector", "tracker",
            "output_radar_data", "cpi")
ALL_KEYS = set(REF_KEYS) | {"wire_transfer", "latency"}


def _runtime(cfg=None, **kw):
    return RadarRuntime(load_config(CONFIG) if cfg is None else cfg,
                        device="cpu", **kw)


def _run_bounded(rt, n_cpis, seconds=120.0):
    """``rt.run(n_cpis)`` in a thread that must end within ``seconds``;
    a run that does not is stopped and fails the test."""
    err = []

    def body():
        try:
            rt.run(n_cpis=n_cpis, quiet=True)
        except BaseException as e:  # handed to the test thread
            err.append(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        rt.stop()
        t.join(10.0)
        pytest.fail(f"run of {n_cpis} CPIs did not end within {seconds} s")
    if err:
        raise err[0]


def _spy(rt):
    """Record every emission of ``rt`` as (product, payload, CPIs done)."""
    emissions = []
    orig = rt._emit

    def spy(product, payload, **kw):
        emissions.append((product, payload, rt.n_cpis_done))
        return orig(product, payload, **kw)

    rt._emit = spy
    return emissions


def _windows(n, count, seed=20):
    out = []
    for k in range(count):
        x, y = synthetic_cpi(n, 200_000, [TargetSpec(40, -77.0, 0.05),
                                          TargetSpec(85, 44.0, 0.03)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=seed + k)
        out.append((x.astype(np.complex64), y.astype(np.complex64)))
    return out


def _numbers_close(a, b, tol):
    """Two parsed JSON values equal in structure and strings, numbers
    within ``tol``."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _numbers_close(a[k], b[k], tol) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _numbers_close(u, v, tol) for u, v in zip(a, b))
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return isinstance(b, (int, float)) and abs(a - b) <= tol
    return a == b


def _assert_products_agree(port, jax_):
    """Parsed products of one CPI: map within 0.05 dB (plus the JSON's
    0.01 dB rounding), noise within 1e-4 dB before the rounding to 0.01,
    detections at the same cells (positions within one 0.01 rounding
    step), SNR within 2e-3 dB plus the rounding; tracks the same but for
    the last digit of values derived from those positions."""
    mp, mj = json.loads(port["map"]), json.loads(jax_["map"])
    assert {k: mp[k] for k in ("nRows", "nCols", "delay", "doppler",
                               "timestamp")} == \
        {k: mj[k] for k in ("nRows", "nCols", "delay", "doppler",
                            "timestamp")}
    np.testing.assert_allclose(np.array(mp["data"]), np.array(mj["data"]),
                               atol=0.05 + 0.011)
    assert abs(mp["noisePower"] - mj["noisePower"]) <= 0.011
    assert abs(mp["maxPower"] - mj["maxPower"]) <= 0.011
    dp, dj = json.loads(port["detection"]), json.loads(jax_["detection"])
    assert dp["timestamp"] == dj["timestamp"]
    assert len(dj["delay"]) >= 2 and len(dp["delay"]) == len(dj["delay"])
    for k, tol in (("delay", 0.011), ("doppler", 0.011),
                   ("snr", 2e-3 + 0.011)):
        np.testing.assert_allclose(dp[k], dj[k], atol=tol)
    assert _numbers_close(json.loads(port["track"]),
                          json.loads(jax_["track"]), 0.011)
    ip, ij = json.loads(port["iqdata"]), json.loads(jax_["iqdata"])
    assert ip.keys() == ij.keys()
    np.testing.assert_allclose(ip["spectrum"], ij["spectrum"], atol=0.011)
    assert ip["frequency"] == ij["frequency"]


# -- the port against the JAX runtime ------------------------------------------

def test_process_one_cpi_matches_jax():
    port = _runtime(staged_sample_every=0)
    ref = JaxRuntime(jax_load_config(CONFIG), staged_sample_every=0)
    keys = []
    for k, (x, y) in enumerate(_windows(port.n_samples, 3)):
        a = port.process_one_cpi(x, y, timestamp_ms=1000 + k)
        b = ref.process_one_cpi(x, y, timestamp_ms=1000 + k)
        assert a.keys() == b.keys() == {"iqdata", "map", "detection",
                                        "track"}
        _assert_products_agree(a, b)
        keys.append((list(port.timer.names), list(ref.timer.names)))
    for p, j in keys:
        assert p == j


@pytest.mark.parametrize("defer", [True, False], ids=["deferred", "sync"])
def test_process_one_cpi_chunks_matches_jax(defer):
    """The chunked entry of both runtimes on the same windows, popped from
    their rings in 4 chunks; under deferred fetch each CPI's products come
    out one CPI behind, and the timing docs carry JAX's keys and the
    port's span keys, exactly."""
    port = _runtime(staged_sample_every=0, ingest_chunks=4,
                    defer_fetch=defer)
    ref = JaxRuntime(jax_load_config(CONFIG), staged_sample_every=0,
                     ingest_chunks=4, defer_fetch=defer)
    got = {"port": [], "jax": []}
    docs = {"port": [], "jax": []}
    for name, rt in (("port", port), ("jax", ref)):
        emissions = _spy(rt)
        for k, (x, y) in enumerate(_windows(port.n_samples, 3)):
            rt.buffer1.push(x)
            rt.buffer2.push(y)
            chunks = rt._extract_cpi_chunks(timeout=1.0)
            assert chunks is not None and len(chunks[0]) == 4
            out = rt.process_one_cpi_chunks(*chunks, timestamp_ms=1000 + k)
            assert (out is None) == defer
            if out is not None:
                got[name].append(out)
        last = rt._flush_pending()
        if defer:
            got[name] = [{p: v for p, v, _ in emissions
                          if p in ("iqdata", "map", "detection", "track")
                          and json.loads(v)["timestamp"] == 1000 + i}
                         for i in range(3)]
            assert last is not None
            docs[name] = [json.loads(v) for p, v, _ in emissions
                          if p == "timing"]
    for a, b in zip(got["port"], got["jax"]):
        _assert_products_agree(a, b)
    if defer:
        assert len(docs["port"]) == len(docs["jax"]) == 3
        for a, b in zip(docs["port"], docs["jax"]):
            assert set(a) == set(b) | set(SPAN_KEYS) and ALL_KEYS <= set(a)


# -- the port's own loop -----------------------------------------------------

def test_threaded_synthetic_run_emits_every_cpi_in_order():
    """A capture thread of the synthetic source, N CPIs under deferred
    fetch with staged samples every 2 CPIs: N product sets in order, each
    fused CPI's one CPI behind its own, every timing doc with the full key
    set, both injected targets detected."""
    rt = _runtime(staged_sample_every=2, staged_warmup="sync")
    assert rt.defer_fetch and rt.ingest_chunks == 8
    emissions = _spy(rt)
    rt.start_capture()
    try:
        _run_bounded(rt, 5)
    finally:
        rt.stop()
    maps = [(json.loads(v), done) for p, v, done in emissions if p == "map"]
    assert len(maps) == 5
    stamps = [m["timestamp"] for m, _ in maps]
    assert stamps == sorted(stamps)
    # CPI j emits during CPI j+1's fill or behind its dispatch (fused) or
    # during its own (staged: CPIs 0, 2, 4); the last fused CPI would drain
    # after the loop.
    assert [done - j for j, (_, done) in enumerate(maps)] == [0, 1, 0, 1, 0]
    timings = [json.loads(v) for p, v, _ in emissions if p == "timing"]
    assert len(timings) == 5 and timings[-1]["nCpi"] == 5
    for doc in timings:
        assert ALL_KEYS <= set(doc)
        assert all(doc[k] >= 0.0 for k in ALL_KEYS)
    assert rt._sample_stage_ms is not None
    km = 299_792_458 / 200_000 / 1000
    for p, v, _ in emissions:
        if p == "detection":
            d = json.loads(v)["delay"]
            for bins in (40, 85):
                assert any(abs(x - bins * km) < 1.0 for x in d), (bins, d)
    assert (rt.buffer1.dropped, rt.buffer2.dropped) == (0, 0)


def test_capture_stall_flushes_the_pending_cpi():
    """Two CPIs in the rings and no capture: the second CPI's products,
    deferred behind a third that does not come, are emitted as the third
    CPI's fill finds the rings dry; the third arrives later and drains at
    the end."""
    rt = _runtime(staged_sample_every=0)
    emissions = _spy(rt)
    (x0, y0), (x1, y1), (x2, y2) = _windows(rt.n_samples, 3)
    for x, y in ((x0, y0), (x1, y1)):
        rt.buffer1.push(x)
        rt.buffer2.push(y)
    t = threading.Thread(target=rt.run, kwargs={"n_cpis": 3, "quiet": True},
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while sum(p == "map" for p, _, _ in emissions) < 2:
            assert time.monotonic() < deadline, "stall flush never came"
            time.sleep(0.05)
        assert rt.n_cpis_done == 2
        rt.buffer1.push(x2)
        rt.buffer2.push(y2)
        t.join(60.0)
        assert not t.is_alive()
    finally:
        rt.stop()
        t.join(10.0)
    assert sum(p == "map" for p, _, _ in emissions) == 3
    assert sum(p == "timestamp" for p, _, _ in emissions) == 3


class _CardFetchEvent:
    """A CPI's fetch event as on a card, played on the host: the card runs
    the CPI for ``run_s`` from the fetch's start, so ``query`` is false
    until then, and ``synchronize`` (logged as "wait" in ``log``) sleeps
    out the rest."""

    def __init__(self, log, run_s):
        self.log, self.end = log, time.perf_counter() + run_s

    def query(self):
        return time.perf_counter() >= self.end

    def synchronize(self):
        self.log.append("wait")
        time.sleep(max(0.0, self.end - time.perf_counter()))


def _card_fetches(monkeypatch, log, run_s):
    """Route the runtime's fetches through :class:`_CardFetchEvent`s of
    ``run_s``; returns the events, in CPI order."""
    from blah2_tpu_torch.runtime import radar, staging

    events = []

    def start_fetch(out, device):
        events.append(_CardFetchEvent(log, run_s))
        return staging.Fetch(tree_map(lambda t: t.detach(), out), events[-1])

    monkeypatch.setattr(radar, "start_fetch", start_fetch)
    return events


def _log_calls(monkeypatch, rt, log, before=lambda: None):
    """Log each of ``rt``'s pipeline calls as "call", after ``before``."""
    call = rt.pipeline.call_chunks

    def logged_call(*a):
        before()
        log.append("call")
        return call(*a)

    monkeypatch.setattr(rt.pipeline, "call_chunks", logged_call)


def _paced_capture(rt, windows, delay=0.0):
    """A capture thread that pushes each window ``delay`` seconds after
    the runtime, having dispatched the CPI before, waits on a ring short of
    a chunk: so each fill's first wait finds the rings dry."""
    asked = [-1]  # CPIs done when the runtime last waited on a short ring
    wait_for = rt.buffer1.wait_for

    def paced_wait(n, timeout=None):
        if len(rt.buffer1) < n:
            asked[0] = rt.n_cpis_done
        return wait_for(n, timeout=timeout)

    rt.buffer1.wait_for = paced_wait

    def push():
        end = time.monotonic() + 60.0
        for k, (x, y) in enumerate(windows):
            while asked[0] < k:
                if time.monotonic() > end:
                    return
                time.sleep(0.001)
            time.sleep(delay)
            rt.buffer1.push(x)
            rt.buffer2.push(y)

    t = threading.Thread(target=push, daemon=True)
    t.start()
    return t


def _per_cpi(emissions) -> list:
    """The products of each CPI, in emission order: a dict of product to
    payload closed by the CPI's ``timestamp`` emission."""
    out, cur = [], {}
    for product, payload, _ in emissions:
        if product == "timestamp":
            out.append(cur)
            cur = {}
        elif product != "timing":
            cur[product] = payload
    return out


#: The card's time a CPI and the capture's delay, in seconds: the CPU's
#: fetch (done at once); a card done well before the capture sends the
#: next CPI (its ``device``, the CPU's wall of the eager call and the
#: fetch, a few hundred ms at most); a card that runs on while the capture
#: sends it at once.
PACED = {"done": (None, 0.0), "short": (0.02, 1.0), "long": (0.6, 0.0)}


@pytest.mark.parametrize("card", list(PACED))
def test_paced_cpis_emit_in_the_next_fill(monkeypatch, card):
    """Capture paced a CPI at a time. Where the card is done ("done") or
    its work is short against the capture's pace ("short"), each fused
    CPI's products go out in the next CPI's fill, before its call: at
    once where the card has them, or, with the rings dry, once the CPI has
    run as long as the CPI before on the card (the first, with none read
    before it, is waited for at once). Where the card's work is long and
    the next CPI's samples arrive meanwhile ("long"), the host ingests
    them and does not wait on the card (but for the first CPI): each CPI
    goes out behind the next dispatch. The products come in order with
    the bits of a synchronous run, and a flush lies outside the in-fill
    CPI's ring and ingest spans."""
    n = 3
    run_s, delay = PACED[card]
    rt = _runtime(staged_sample_every=0)
    log = []
    if run_s is not None:
        _card_fetches(monkeypatch, log, run_s)
    _log_calls(monkeypatch, rt, log)
    emissions = _spy(rt)
    orig = rt._emit

    def logged_emit(product, payload, **kw):
        if product == "timestamp":
            log.append("timestamp")
        return orig(product, payload, **kw)

    rt._emit = logged_emit
    windows = _windows(rt.n_samples, n)
    pusher = _paced_capture(rt, windows, delay)
    _run_bounded(rt, n)
    pusher.join(10.0)
    docs = [json.loads(v) for p, v, _ in emissions if p == "timing"]
    if card == "long":
        assert log == ["call", "wait", "timestamp", "call", "call", "wait",
                       "timestamp", "wait", "timestamp"]
        assert (rt.flushed_in_fill, rt.flushed_waited,
                rt.flushed_behind) == (1, 1, 1)
    else:
        assert [e for e in log if e != "wait"] == ["call", "timestamp"] * n
        assert (rt.flushed_in_fill, rt.flushed_behind) == (n - 1, 0)
        if card == "done":
            assert rt.flushed_waited == 0
        else:
            # Emitted as the card finished, not when the capture went on.
            assert 1 <= rt.flushed_waited <= n - 1
            assert all(d["deferral"] < 1e3 * delay for d in docs[:-1]), \
                [d["deferral"] for d in docs]

    stamps = [int(v) for p, v, _ in emissions if p == "timestamp"]
    assert stamps == sorted(stamps) and len(stamps) == n
    sync = _runtime(staged_sample_every=0, defer_fetch=False)
    for (x, y), stamp, got in zip(windows, stamps, _per_cpi(emissions)):
        sync.buffer1.push(x)
        sync.buffer2.push(y)
        assert got == sync.process_one_cpi_chunks(
            *sync._extract_cpi_chunks(timeout=1.0), timestamp_ms=stamp)

    logged = rt.spans.spans()
    fill = ("ring_wait", "ring_pop", "ingest_cast", "ingest_pack",
            "ingest_copy")
    for k in range(n - 1):
        flush_start = max(t1 for name, cpi, _, t1 in logged
                          if (name, cpi) == ("deferral", k))
        flush_end = max(t1 for _, cpi, _, t1 in logged if cpi == k)
        for name, cpi, t0, t1 in logged:
            if cpi == k + 1 and name in fill:
                assert t1 <= flush_start or t0 >= flush_end, (name, k)


def test_full_rings_keep_the_flush_behind_the_next_dispatch(monkeypatch):
    """The rings full and the card still running each CPI until the next
    is dispatched: no CPI is waited for during a fill; each goes out
    behind the next dispatch, as the one-CPI deferral always did, counted
    in ``flushed_behind``."""
    rt = _runtime(staged_sample_every=0)
    log = []
    events = _card_fetches(monkeypatch, log, 1.0)

    def dispatch():
        for ev in events:  # the card has finished every CPI before
            ev.end = 0.0

    _log_calls(monkeypatch, rt, log, before=dispatch)
    for x, y in _windows(rt.n_samples, 3):
        rt.buffer1.push(x)
        rt.buffer2.push(y)
    _run_bounded(rt, 3)
    assert log == ["call", "call", "wait", "call", "wait", "wait"]
    assert (rt.flushed_in_fill, rt.flushed_waited,
            rt.flushed_behind) == (0, 0, 2)


def test_deferred_products_equal_synchronous():
    outs = []
    x, y = _windows(load_config(CONFIG).n_samples, 1)[0]
    for defer in (True, False):
        rt = _runtime(staged_sample_every=0, defer_fetch=defer)
        rt.buffer1.push(x)
        rt.buffer2.push(y)
        got = rt._extract_cpi_chunks(timeout=1.0)
        out = rt.process_one_cpi_chunks(*got, timestamp_ms=99)
        outs.append(rt._flush_pending() if out is None else out)
    assert outs[0] == outs[1]


def _small_cfg(overlap=0.0, detection=True, **capture):
    return config_from_dict({
        "capture": {"fs": 40_000, "fc": 100_000_000, "type": "Synthetic",
                    **capture},
        "process": {
            "data": {"cpi": 0.1, "buffer": 4, "overlap": overlap},
            "ambiguity": {"delayMin": -5, "delayMax": 40,
                          "dopplerMin": -50, "dopplerMax": 50},
            "clutter": {"enable": detection, "delayMin": -5,
                        "delayMax": 40},
            "detection": {"enable": detection, "pfa": 1e-4, "nGuard": 1,
                          "nTrain": 4, "minDelay": 3, "minDoppler": 10,
                          "nCentroid": 4},
        },
    })


def _col0(chunks):
    """First-plane values of packed or plane chunks."""
    cols = []
    for ch in chunks:
        a = ch.numpy()
        if a.dtype == np.uint8:
            v = unpack12_np(a, (a.size * 2) // 3)
            cols.append(v[: v.size // 2])
        else:
            cols.append(a[:, 0])
    return np.concatenate(cols)


@pytest.mark.parametrize("overlap,frac", [(0.0, 1.0), (0.5, 0.5),
                                          (0.75, 0.25)])
def test_extract_windows_slide(overlap, frac):
    rt = _runtime(_small_cfg(overlap, detection=False))
    n = rt.n_samples
    assert rt.advance == max(1, int(round(n * frac)))
    ramp = (np.arange(4 * n) + 0j).astype(np.complex64)
    rt.buffer1.push(ramp)
    rt.buffer2.push(ramp)
    starts = []
    for _ in range(3):
        x, y = rt._extract_cpi(timeout=0.1)
        np.testing.assert_array_equal(np.real(x),
                                      np.arange(x[0].real, x[0].real + n))
        np.testing.assert_array_equal(np.real(y), np.real(x))
        starts.append(int(x[0].real))
    assert starts == [0, rt.advance, 2 * rt.advance]


def test_overlap_validation_and_chunk_geometry():
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="overlap"):
            _runtime(_small_cfg(bad))
    n = _small_cfg().n_samples
    with pytest.raises(ValueError, match="divide"):
        _runtime(_small_cfg(), ingest_chunks=7 if n % 7 else 11)


def test_chunked_overlap_windows_slide_and_seam_resets():
    """Chunked windows slide by the advance, reusing retained chunks; a
    ring overflow discards them and the next window starts fresh."""
    rt = _runtime(_small_cfg(0.5, detection=False), ingest_chunks=4)
    n, adv, cap = rt.n_samples, rt.advance, rt.buffer1.capacity
    ramp = (np.arange(2 * n) + 0j).astype(np.complex64)
    rt.buffer1.push(ramp)
    rt.buffer2.push(ramp)
    starts = []
    for _ in range(3):
        xc, _ = rt._extract_cpi_chunks(timeout=0.2)
        w = _col0(xc)
        np.testing.assert_array_equal(w, np.arange(w[0], w[0] + n))
        starts.append(int(w[0]))
    assert starts == [0, adv, 2 * adv] and rt._retained_chunks
    more = (np.arange(cap + n) + 5_000_000 + 0j).astype(np.complex64)
    rt.buffer1.push(more)
    rt.buffer2.push(more)
    assert rt.buffer1.dropped > 0
    xc, _ = rt._extract_cpi_chunks(timeout=0.2)
    w = _col0(xc)
    np.testing.assert_array_equal(w, np.arange(w[0], w[0] + n))
    assert w[0] >= 5_000_000


def test_chunked_timeout_keeps_partial_progress():
    rt = _runtime(_small_cfg(detection=False), ingest_chunks=4)
    n = rt.n_samples
    c = n // 4
    ramp = (np.arange(n) + 0j).astype(np.complex64)
    rt.buffer1.push(ramp[: 2 * c])
    rt.buffer2.push(ramp[: 2 * c])
    assert rt._extract_cpi_chunks(timeout=0.05) is None
    assert len(rt._pending_chunks) == 2
    rt.buffer1.push(ramp[2 * c:])
    rt.buffer2.push(ramp[2 * c:])
    xc, _ = rt._extract_cpi_chunks(timeout=0.2)
    np.testing.assert_array_equal(_col0(xc), np.arange(n))


def test_deferred_fetch_with_overlap_windows_and_recycle():
    """50 % overlap, 4 CPIs under deferred fetch with a recycle every 2:
    every emission present, in order; the recycle flushed the pending CPI
    and dropped the retained chunks."""
    rt = _runtime(_small_cfg(0.5), staged_sample_every=0,
                  recycle_every_cpis=2)
    emissions = _spy(rt)
    x, y = _windows(3 * rt.n_samples, 1)[0]
    rt.buffer1.push(x)
    rt.buffer2.push(y)
    _run_bounded(rt, 4)
    maps = [json.loads(v) for p, v, _ in emissions if p == "map"]
    assert len(maps) == 4
    assert [m["timestamp"] for m in maps] == sorted(m["timestamp"]
                                                    for m in maps)
    assert rt._retained_chunks == [] and rt._pending_out is None


@pytest.mark.parametrize("wire", ["packed", "int16", "float32"])
def test_replay_wire_formats_give_the_same_products(tmp_path, wire):
    """A 12-bit replay file through the capture thread: packed-12 chunks,
    int16 planes and f32 planes give identical products."""
    fs, cpi = 40_000, 0.2
    n = int(fs * cpi)
    x, y = synthetic_cpi(n, fs, [TargetSpec(12, 30.0, 0.05)],
                         clutter_amplitude=2.0, noise_amplitude=1e-3, seed=4)
    src = Source("RspDuo", fs, 100e6, path=str(tmp_path))
    fname = src.open_record_file()
    src.record(np.clip(x.real * 300, -2047, 2047)
               + 1j * np.clip(x.imag * 300, -2047, 2047),
               np.clip(y.real * 300, -2047, 2047)
               + 1j * np.clip(y.imag * 300, -2047, 2047))
    src.close_record_file()
    cfg = config_from_dict({
        "capture": {"fs": fs, "fc": 100e6,
                    "replay": {"state": True, "loop": True, "file": fname}},
        "process": {
            "data": {"cpi": cpi, "buffer": 4},
            "ambiguity": {"delayMin": -5, "delayMax": 40,
                          "dopplerMin": -100, "dopplerMax": 100},
            "clutter": {"enable": True, "delayMin": -5, "delayMax": 20},
            "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                          "nTrain": 6, "minDelay": 5, "minDoppler": 10,
                          "nCentroid": 6}}})

    def products(kind):
        rt = _runtime(cfg, staged_sample_every=0)
        if kind != "packed":
            rt._pack12_ok = False
        if kind == "float32":
            rt._wire_dtype = None
        seen = []
        orig = rt._to_device

        def spy(a):
            seen.append(a.dtype)
            return orig(a)

        rt._to_device = spy
        captured = {}
        orig_emit = rt._emit_products

        def cap(out, t0, **kw):
            e = orig_emit(out, t0, **kw)
            captured.update(e)
            return e

        rt._emit_products = cap
        rt.start_capture()
        try:
            _run_bounded(rt, 1)
        finally:
            rt.stop()
        return captured, set(seen)

    got, dtypes = products(wire)
    assert dtypes == {{"packed": np.dtype(np.uint8),
                       "int16": np.dtype(np.int16),
                       "float32": np.dtype(np.float32)}[wire]}
    want, _ = products("float32")
    assert json.loads(got["map"])["data"] == json.loads(want["map"])["data"]
    for k in ("delay", "doppler", "snr"):
        assert json.loads(got["detection"])[k] == \
            json.loads(want["detection"])[k]


def test_staged_timing_and_samples_fill_every_key():
    """``staged_timing`` runs every CPI as stages; staged samples every 2
    CPIs keep the fused CPIs' split; both carry the JAX runtime's keys."""
    for kw in ({"staged_timing": True},
               {"staged_sample_every": 2, "staged_warmup": "sync"}):
        rt = _runtime(**kw)
        emissions = _spy(rt)
        rt.start_capture()
        try:
            _run_bounded(rt, 3)
        finally:
            rt.stop()
        timings = [json.loads(v) for p, v, _ in emissions if p == "timing"]
        assert len(timings) == 3
        # Every CPI of a staged_timing run is a staged one: no wire key.
        want = ALL_KEYS - ({"wire_transfer"} if "staged_timing" in kw
                           else set())
        for doc in timings:
            assert want <= set(doc), doc
        if "staged_sample_every" in kw:
            assert set(rt._sample_stage_ms) == set(rt.DEVICE_STAGES)
            assert sum(timings[1][k] for k in rt.DEVICE_STAGES) > 0.0


def test_async_warmup_then_samples():
    rt = _runtime(staged_sample_every=1, staged_warmup="async")
    rt.start_capture()
    try:
        _run_bounded(rt, 2)
        assert rt._staged_warmup_thread is not None
        rt._staged_warmup_thread.join(60.0)
        assert rt._staged_ready.is_set() and rt._is_sample_cpi()
    finally:
        rt.stop()


def test_runtime_emits_sub_spectra():
    cfg = load_config(CONFIG)
    cfg.process.spectrum.n_sub = 4
    rt = _runtime(cfg, staged_sample_every=2, staged_warmup="sync")
    emissions = _spy(rt)
    rt.start_capture()
    try:
        _run_bounded(rt, 3)
    finally:
        rt.stop()
    docs = [json.loads(v) for p, v, _ in emissions if p == "iqdata"]
    assert len(docs) == 3
    for doc in docs:
        sub = np.asarray(doc["subSpectra"], dtype=float)
        assert sub.shape == (4, len(doc["spectrum"]))
        assert np.all(np.isfinite(sub))


def test_fetch_returns_host_arrays():
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline

    pipe = CpiPipeline(load_config(CONFIG), device="cpu")
    x, y = _windows(pipe.n_samples, 1)[0]
    out = pipe(x, y)
    host = fetch(out, pipe.device)
    assert isinstance(host.db_map, np.ndarray)
    assert isinstance(host.detections.valid, np.ndarray)
    assert host.sub_spectra_db is None
    np.testing.assert_array_equal(host.db_map, out.db_map.numpy())
    later = start_fetch(out, pipe.device).wait()
    assert tree_map(lambda a: a.shape, later) == tree_map(lambda a: a.shape,
                                                          host)


# -- refusals ------------------------------------------------------------------

def test_runtime_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RadarRuntime(load_config(CONFIG))


def test_mesh_mode_refuses():
    """Mesh mode runs, in one process or over several (nothing is refused
    for being unported any more); what it refuses is a device list that
    does not fill the mesh."""
    from blah2_tpu_torch.parallel.mesh import RadarMesh, make_radar_mesh
    from blah2_tpu_torch.runtime import radar

    rt = RadarRuntime(load_config(CONFIG), device="cpu",
                      mesh=make_radar_mesh(1, 2, devices=["cpu"] * 2))
    assert rt.sharded is not None and rt.cpi_batch == 1
    assert not hasattr(radar, "MESH_NOT_PORTED")
    with pytest.raises(ValueError, match="1 processes"):
        RadarMesh(1, 2, ["cpu"] * 3)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli_job(tmp_path, args, envs, seconds=240):
    """Two CLI processes (``args[k]``, ``envs[k]`` for process k) on the
    synthetic config with the API on a free port; both killed if either
    runs past ``seconds``. Returns [(exit code, stdout, stderr)]."""
    import yaml

    with open(CONFIG) as f:
        doc = yaml.safe_load(f)
    doc["network"]["ip"] = "127.0.0.1"
    doc["network"]["ports"]["api"] = _free_port()
    cfg = tmp_path / "config.yml"
    cfg.write_text(yaml.safe_dump(doc))
    procs = []
    for k in range(2):
        env = {n: v for n, v in os.environ.items() if n != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   **envs[k])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", "--config",
             str(cfg), "--device", "cpu", "--cpis", "1", *args[k]], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=seconds))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


@pytest.mark.parametrize("source", ["flags", "environment", "no-mesh"])
def test_cli_runs_across_two_processes(source, tmp_path):
    """The multi-process flags run, as in the JAX CLI: two gloo processes
    on the CPU, one CPI batch each, the mesh over both (2 x 4 from flags,
    1 x 8 from BLAH2_* variables; without --mesh each process runs the
    single-device pipeline). Each prints its distributed line; only
    process 0 serves the API."""
    coord = f"127.0.0.1:{_free_port()}"
    flags = [["--coordinator", coord, "--num-processes", "2",
              "--process-id", str(k)] for k in range(2)]
    env = [{"BLAH2_COORDINATOR": coord, "BLAH2_NUM_PROCESSES": "2",
            "BLAH2_PROCESS_ID": str(k)} for k in range(2)]
    args, envs, batch = {
        "flags": ([f + ["--mesh", "2x4"] for f in flags], [{}, {}],
                  "(batch of 2"),
        "environment": ([["--mesh", "1x8", "--halo-backend", "pallas"]] * 2,
                        env, "(batch of 1"),
        "no-mesh": (flags, [{}, {}], "CPI time (ms)"),
    }[source]
    runs = _cli_job(tmp_path, args, envs)
    for k, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"process {k}:\n{out}\n{err}"
        assert f"distributed: process {k}/2" in out
        assert "backend gloo" in out
        assert out.count(batch) == 1, out
        assert ("API on http://" in out) == (k == 0)


@pytest.mark.parametrize("flag", [["--mesh", "2x4"],
                                  ["--halo-backend", "pallas"],
                                  ["--row-shard", "on"]],
                         ids=lambda f: f[0])
def test_cli_mesh_flags_run_one_cpi(flag, capsys):
    """Each mesh-mode flag runs with ``--device cpu`` (the latter two on a
    1 × 2 mesh)."""
    mesh = [] if flag[0] == "--mesh" else ["--mesh", "1x2"]
    rc = cli.main(["--config", CONFIG, "--device", "cpu", "--no-api",
                   "--cpis", "1"] + mesh + flag)
    assert rc == 0
    assert "(batch of" in capsys.readouterr().out


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "blah2_tpu_torch.runtime.cli", "--config",
         CONFIG, "--no-api", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    proc = _cli("--device", "cpu", "--cpis", "3", "--staged-sample-every",
                "2", "--profile-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("CPI time (ms)") == 3
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    proc = _cli("--cpis", "1")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
