"""One run of one cell: the port's radar runtime built as its CLI builds it,
fed by the cell's traffic, observed where users observe it, judged against
the plain reference after the window has closed.

  - The runtime is ``RadarRuntime`` with ``runtime/cli.py``'s defaults:
    chunked ingest, deferred fetch, CUDA-graph replay, a staged sample
    every 16 CPIs, packed-12 wire where the front end gives 12-bit counts.
    It runs ``RadarRuntime.run`` in a thread of its own; the traffic
    generator (``traffic/<kind>.py``) feeds its two rings in the role of the
    SDR driver's callback.
  - ``in_process`` deployments serve the port's ``ApiServer`` inside the
    process, as the CLI starts it; the runtime publishes through a wrapper
    that stamps each ``publish`` when it returns. ``standalone_api``
    deployments run ``python -m blah2_tpu_torch.net.api`` as a process of
    its own, fed by the runtime's TCP egress (``--no-api --tcp-egress``),
    and a third process (``poller.py``) polls it over REST as the display
    does.
  - Set-up runs ``warmup_cpis`` CPIs with flow control (the CUDA graph's
    capture, the staged warm-up, a first staged sample) and waits for their
    products; the window opens then.
  - With the tracker on, what the runtime hands its tracker each CPI (the
    timestamp and a copy of the detections) is recorded, so that the
    tracker's served state can be judged on its own input.
  - ``hostload.py`` reads what the machine did at the window's edges.

Every port comes from the system (bound to port 0); the two child
processes are ended with a deadline, whatever happens.
"""

from __future__ import annotations

import gc
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import yaml

from benchmark import hostload, manifest, stats
from benchmark import judge as judging
from benchmark import scene as scenes
from benchmark.reference import dsp

#: CPIs the staged sampling comes round on (the CLI's default).
STAGED_EVERY = 16
#: How long the products of CPIs due in the window are waited for.
GRACE_S = 60.0


def free_ports(n: int) -> List[int]:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def deployment(config_file: str):
    """(upstream YAML document, its ``bench`` block) of a configuration
    file, the document's network moved to free localhost ports."""
    with open(config_file) as f:
        doc = yaml.safe_load(f)
    bench = doc.pop("bench")
    names = ("api", "map", "detection", "track", "timestamp", "timing",
             "iqdata", "config")
    doc["network"]["ip"] = "127.0.0.1"
    doc["network"]["ports"] = dict(zip(names, free_ports(len(names))))
    return doc, bench


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def _detections(text: str, g: dsp.Geometry, index: Dict[int, int]):
    """/stash/detection's flat lists as {CPI: (k, 3) delay bins, Hz, dB}."""
    doc = json.loads(text)
    out: Dict[int, list] = {}
    for ts, d, f, s in zip(doc["timestamp"], doc["delay"], doc["doppler"],
                           doc["snr"]):
        if ts in index:
            out.setdefault(index[ts], []).append((d / g.km_per_bin, f, s))
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


class InProcess:
    """The port's ApiServer inside the radar process; the runtime publishes
    into this wrapper, which stamps each product when its publish
    returns."""

    def __init__(self, config, keep_map):
        from blah2_tpu_torch.net.api import ApiServer

        self.port = config.network.api
        self.api = ApiServer(config, web_root=None)
        self.api.start(with_ingest=False)
        self.keep_map = keep_map
        self.stamps: List[tuple] = []
        self.timing: List[dict] = []
        self.maps: Dict[int, str] = {}
        self.tracks: Dict[int, str] = {}
        self._n_map = self._n_track = 0

    def publish(self, product: str, payload: str, parsed=None) -> None:
        self.api.publish(product, payload, parsed=parsed)
        t = time.perf_counter()
        if product == "timestamp":
            self.stamps.append((int(payload), t))
        elif product == "timing":
            self.timing.append(parsed if parsed is not None
                               else json.loads(payload))
        elif product == "map":
            if self.keep_map(self._n_map):
                self.maps[self._n_map] = payload
            self._n_map += 1
        elif product == "track":
            if self.keep_map(self._n_track):
                self.tracks[self._n_track] = payload
            self._n_track += 1

    def delivered(self) -> int:
        return len(self.stamps)

    def finish(self, rt, g: dsp.Geometry) -> SimpleNamespace:
        try:
            text = _get(self.port, "/stash/detection")
        finally:
            self.api.stop()
        ts = [s[0] for s in self.stamps]
        index = {t: k for k, t in enumerate(ts)}
        return SimpleNamespace(
            timestamps=ts, held=[s[1] for s in self.stamps],
            timing=self.timing, maps=self.maps, tracks=self.tracks,
            detections=_detections(text, g, index))

    def close(self) -> None:
        self.api.stop()


class Standalone:
    """The API as a process of its own, fed over TCP, and the poller."""

    def __init__(self, doc: dict, seed: int, traffic: dict, tmp: str,
                 root: str):
        self.port = doc["network"]["ports"]["api"]
        path = os.path.join(tmp, "deployment.yml")
        with open(path, "w") as f:
            yaml.safe_dump(doc, f)
        env = dict(os.environ, PYTHONPATH=root)
        self.procs = []
        self.api = self._spawn([sys.executable, "-m",
                                "blah2_tpu_torch.net.api", "-c", path],
                               root, env, subprocess.DEVNULL)
        ports = [self.port] + [doc["network"]["ports"][p] for p in (
            "map", "detection", "track", "timestamp", "timing", "iqdata")]
        deadline = time.monotonic() + 60.0
        for p in ports:
            while True:
                try:
                    socket.create_connection(("127.0.0.1", p), 1.0).close()
                    break
                except OSError:
                    if time.monotonic() > deadline or \
                            self.api.poll() is not None:
                        raise RuntimeError(
                            f"the API process did not open port {p}")
                    time.sleep(0.05)
        judge = traffic["judge"]
        self.poller = self._spawn(
            [sys.executable, "-m", "benchmark.poller", "--port",
             str(self.port), "--seed", str(seed),
             "--ts-every", str(judge["ts_every_s"]),
             "--map-every", str(judge["map_every_s"]),
             "--track-every", str(judge["track_every_s"])],
            root, env, subprocess.PIPE)
        self.lines: List[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self._rows: List[tuple] = []     # (timestamp, row dict, t seen)
        self._parsed = 0

    def _spawn(self, cmd, root, env, stdout):
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=stdout,
                                stderr=subprocess.DEVNULL, text=True,
                                start_new_session=True)
        self.procs.append(proc)
        return proc

    def _read(self) -> None:
        for line in self.poller.stdout:
            self.lines.append(line)

    def _merge(self) -> None:
        """Fold the timing-stash lines read so far into one row a CPI."""
        lines, self._parsed = self.lines[self._parsed:], len(self.lines)
        for line in lines:
            rec = json.loads(line)
            if rec["k"] != "timing":
                continue
            series = json.loads(rec["text"])
            keys = list(series)
            last = self._rows[-1][0] if self._rows else -1
            for vals in zip(*(series[k] for k in keys)):
                row = dict(zip(keys, vals))
                if row["timestamp"] > last:
                    self._rows.append((row["timestamp"], row, rec["t"]))
                    last = row["timestamp"]

    def delivered(self) -> int:
        self._merge()
        return len(self._rows)

    def finish(self, rt, g: dsp.Geometry) -> SimpleNamespace:
        last = str(rt.timing.t_now)
        deadline = time.monotonic() + 20.0
        while _get(self.port, "/api/timestamp")[-len(last):] != last:
            if time.monotonic() > deadline:
                raise RuntimeError("the API never held the last CPI")
            time.sleep(0.05)
        time.sleep(0.3)   # the poller's next timing read
        dets = _get(self.port, "/stash/detection")
        self.close()
        self._reader.join(10.0)
        self._merge()
        ts = [r[0] for r in self._rows]
        index = {t: k for k, t in enumerate(ts)}
        held = [r[2] for r in self._rows]
        maps, tracks = {}, {}
        for line in self.lines:
            rec = json.loads(line)
            if rec["k"] == "ts":
                k = index.get(int(rec["v"][-13:]))
                if k is not None:
                    held[k] = min(held[k], rec["t"])
            elif rec["k"] in ("map", "track"):
                k = index.get(judging.doc_timestamp(rec["text"]))
                if k is not None:
                    (maps if rec["k"] == "map" else tracks).setdefault(
                        k, rec["text"])
        return SimpleNamespace(
            timestamps=ts, held=held, timing=[r[1] for r in self._rows],
            maps=maps, tracks=tracks,
            detections=_detections(dets, g, index))

    def close(self) -> None:
        """End both processes: SIGTERM, then SIGKILL after 10 s."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in self.procs:
            try:
                proc.wait(10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10.0)


def record_tracker_inputs(tracker) -> List[tuple]:
    """Wrap ``tracker.process`` (on the instance) so that each call's
    timestamp and detections are kept, in order; returns the list."""
    calls: List[tuple] = []
    process = tracker.process

    def recorded(detection, timestamp_ms):
        calls.append((int(timestamp_ms), list(zip(
            detection.delay, detection.doppler, detection.snr))))
        return process(detection, timestamp_ms)

    tracker.process = recorded
    return calls


def _wait(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.01)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", man: dict = None,
             root: str = manifest.ROOT, traffic: dict = None,
             config_file: str = None) -> dict:
    """Run cell ``name`` once; the result's fields as ``run.py`` prints
    them. ``traffic`` and ``config_file`` stand in for the cell's own
    (sweeps and the CPU tests)."""
    import torch

    from blah2_tpu_torch.config import config_from_dict
    from blah2_tpu_torch.runtime.radar import RadarRuntime

    spec = manifest.cell(name, man, root)
    traffic = traffic or spec["traffic"]
    kind = manifest.load_module(
        os.path.join(root, "benchmark", "traffic", traffic["kind"] + ".py"),
        "benchmark_traffic_" + traffic["kind"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = [("imports", time.perf_counter())]
    doc, bench = deployment(config_file or spec["config_file"])
    g = dsp.geometry(doc)
    config = config_from_dict(doc)
    scene = scenes.make(traffic["scene"], g, seed, dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("scene", time.perf_counter()))

    # Maps kept for judging: two in every ``map_every_cpis`` CPIs (a multiple
    # of 16), one of them a staged sample's, which other the seed says; and
    # the window's first four (a traced open loop, slowed by the tracer,
    # may drop samples later on, and CPIs after a drop go unjudged).
    every = int(traffic["judge"].get("map_every_cpis", 0))
    phase = 1 + seed % (every - 1) if every else 0
    first = [math.inf]

    def keep_map(k):
        return bool(every) and (k % every in (0, phase)
                                or first[0] <= k < first[0] + 4)

    tmp = tempfile.mkdtemp(prefix="bench-")
    observer = None
    rt = radar = feed = window = None
    tracker_inputs: List[tuple] = []
    try:
        if bench["topology"] == "in_process":
            observer = InProcess(config, keep_map)
        else:
            observer = Standalone(doc, seed, traffic, tmp, root)
        # As runtime/cli.py builds it (its defaults; --no-api --tcp-egress
        # for the standalone API).
        rt = RadarRuntime(
            config, api_server=observer if bench["topology"] == "in_process"
            else None, use_tcp_egress=bench["topology"] != "in_process",
            staged_timing=False, staged_sample_every=STAGED_EVERY,
            ingest_chunks=None, defer_fetch=True, graph="auto",
            recycle_every_cpis=0, mesh=None, halo_backend="ppermute",
            row_shard="auto", device=dev)
        marks.append(("runtime built", time.perf_counter()))
        if rt.tracker is not None:
            tracker_inputs = record_tracker_inputs(rt.tracker)
        radar = threading.Thread(target=rt.run, kwargs={"quiet": True},
                                 name="radar", daemon=True)
        radar.start()
        feed = kind.Generator((rt.buffer1, rt.buffer2), scene, traffic, g.n)

        # Set-up: the warm-up CPIs, until a staged sample has run.
        n_warm = int(traffic["warmup_cpis"])
        feed.warmup(n_warm)
        _wait(lambda: observer.delivered() >= n_warm, 120.0, "warm-up")
        while rt._sample_stage_ms is None:
            n_warm += STAGED_EVERY
            feed.warmup(n_warm)
            _wait(lambda: observer.delivered() >= n_warm, 120.0, "warm-up")
        first[0] = feed.next_cpi
        if trace:
            from benchmark.trace import Window

            window = Window()
            window.open()
        load = hostload.HostLoad(
            {"radar": radar.ident},
            dict(zip(("api", "poller"),
                     (p.pid for p in getattr(observer, "procs", [])))))
        load.open()
        t0 = time.perf_counter() + 0.02
        t_end = t0 + seconds
        setup_s = t0 - t_start
        marks.append((f"{n_warm} warm-up CPIs", t0))
        prev = t_start
        print("setup:", ", ".join(f"{what} {t - p:.2f} s" for (what, t), p in
                                  zip(marks, [prev] + [m[1] for m in marks])),
              file=sys.stderr, flush=True)
        feed.start(t0, t_end)
        load.add_thread("feed", feed._thread.ident)
        time.sleep(max(0.0, t_end - time.perf_counter()))
        host = load.close()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        feed.stop()
        if window is not None:
            window.close()
        due = sorted(k for k, t in feed.due.items() if t <= t_end)
        if due:
            want = due[-1] + 1 if feed.drop_cpi is None else 0
            deadline = time.monotonic() + GRACE_S
            while observer.delivered() < want and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        rt.stop()
        radar.join(60.0)
        if radar.is_alive():
            raise RuntimeError("the runtime did not stop")
        served = observer.finish(rt, g)
        n_done = rt.n_cpis_done
    finally:
        if window is not None:
            window.close()
        if feed is not None:
            feed._stop.set()
        if rt is not None:
            rt.stop()
        if observer is not None:
            observer.close()
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)

    summary = None if window is None else window.summary()
    due_at = {k: t for k, t in feed.due.items() if t <= t_end}
    lags_ms, drop_cpi = feed.lags_ms, feed.drop_cpi
    ring_samples = rt.buffer1.capacity
    del rt, radar, feed, observer, window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if len(served.timestamps) != n_done:
        raise RuntimeError(f"{n_done} CPIs processed, "
                           f"{len(served.timestamps)} counted at the API")

    held = dict(enumerate(served.held))
    e2e = {"setup_s": setup_s}
    ages = None
    if traffic["kind"] == "replay":
        judged = [k for k, t in held.items() if t0 <= t <= t_end]
        attempted, failed = len(judged), 0
        e2e["throughput_msps"] = stats.throughput_msps(
            held.values(), t0, t_end, g.n)
    else:
        ages = stats.ages_ms(due_at, held, t_end, drop_cpi)
        judged = [k for k in sorted(due_at) if k in held
                  and (drop_cpi is None or k < drop_cpi)]
        attempted = len(ages)
        failed = sum(1 for a in ages if a == math.inf)
        e2e["latency_p95_ms"] = stats.reported(stats.percentile(ages, 0.95))
        e2e["latency_p50_ms"] = stats.reported(stats.percentile(ages, 0.50))
        # How near the window came to losing samples: the oldest product
        # and the latest push, against what a ring holds at this rate. The
        # last CPI due waits for a next CPI that the window never sends (the
        # deferral's 1 s wait), so its age is apart.
        rate = float(traffic["rate_msps"]) * 1e3      # samples a ms
        host["open_loop"] = {
            "age_max_ms": stats.reported(max(ages[:-1], default=0.0)),
            "last_age_ms": stats.reported(ages[-1]) if ages else None,
            "lag_max_ms": round(max(lags_ms, default=0.0), 3),
            "cpi_ms": round(g.n / rate, 3),
            "ring_ms": round(ring_samples / rate, 3)}

    # -- correctness, after the program's state is freed ---------------------
    refs = [dsp.products(x, y, g, device=dev)
            for x, y in zip(scene.x, scene.y)]
    checks, seen = judging.judge(
        {"maps": served.maps, "detections": served.detections,
         "tracks": served.tracks, "tracker_inputs": tracker_inputs}, refs, g,
        served.timestamps, judged)
    with open(spec["limits_file"]) as f:
        limits = json.load(f)
    missing = set(checks) - set(limits)
    if missing:
        raise RuntimeError(f"{spec['limits_file']} has no limit for "
                           f"{', '.join(sorted(missing))}")
    correct = bool(judged) and seen["maps"] > 0 and all(
        checks[k] <= limits[k] for k in checks) and (
        not g.tracker or seen["track_docs"] > 0)

    keys = sorted({key for k in judged for key in served.timing[k]})
    print("timing means (ms):", {key: round(float(np.mean(
        [served.timing[k][key] for k in judged
         if key in served.timing[k]])), 3) for key in keys
        if key not in ("timestamp", "nCpi", "uptime_s", "uptime_days")},
        file=sys.stderr, flush=True)
    run = SimpleNamespace(
        timing=[served.timing[k] for k in judged], trace=summary,
        lags_ms=lags_ms, geometry=g,
        trace_cpis=None if summary is None else sum(
            1 for t in held.values() if t0 <= t <= t_end))
    return {
        "judged": seen,
        "attempted": attempted, "failed": failed, "correct": correct,
        "end_to_end": e2e, "run": run, "ages_ms": ages, "peak": peak,
        "summary": summary, "host": host,
        "checks": {k: {"value": checks[k], "limit": limits[k]}
                   for k in checks},
    }
