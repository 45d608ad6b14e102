"""The display's side of the standalone API: a process of its own that polls
the API over REST, as the web frontend does, and writes what it read to
standard output, one JSON object a line, each with ``t``, the
``time.perf_counter()`` at which the reply was in (CLOCK_MONOTONIC, which
every process on the machine shares).

  - ``/api/timestamp`` every ``--ts-every`` seconds (0: never): a line
    ``{"k": "ts"}`` each time the value changes (the time the API held
    that CPI, to the poll);
  - ``/stash/timing`` every ``--timing-every`` seconds: its last 20 CPIs'
    rows, from which every CPI is counted;
  - ``/api/map`` and ``/api/tracker`` at times drawn from ``--seed``, on
    average every ``--map-every`` and ``--track-every`` seconds: the
    documents, judged after the run.

It imports the standard library only, and stops on SIGTERM.

    python3 -m benchmark.poller --port P --seed S [--map-every 1.5] ...
"""

from __future__ import annotations

import argparse
import json
import random
import signal
import sys
import time
import urllib.error
import urllib.request


def get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read().decode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ts-every", type=float, default=0.004)
    ap.add_argument("--timing-every", type=float, default=0.05)
    ap.add_argument("--map-every", type=float, default=1.5)
    ap.add_argument("--track-every", type=float, default=0.25)
    args = ap.parse_args(argv)

    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    rng = random.Random(args.seed)
    out = sys.stdout

    def emit(rec):
        out.write(json.dumps(rec) + "\n")

    now = time.perf_counter()
    due = {"timing": now,
           "map": now + rng.uniform(0, args.map_every),
           "track": now + rng.uniform(0, args.track_every)}
    if args.ts_every > 0:
        due["ts"] = now
    every = {"ts": args.ts_every, "timing": args.timing_every}
    paths = {"ts": "/api/timestamp", "timing": "/stash/timing",
             "map": "/api/map", "track": "/api/tracker"}
    last_ts = None
    while not stop:
        kind = min(due, key=due.get)
        wait = due[kind] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
            continue
        if kind in every:
            due[kind] += every[kind]
        else:  # exponential gaps drawn from the seed, at least 10 ms
            mean = args.map_every if kind == "map" else args.track_every
            due[kind] += max(0.01, rng.expovariate(1.0 / mean))
        try:
            text = get(args.port, paths[kind])
        except (OSError, urllib.error.URLError):
            continue
        t = time.perf_counter()
        if kind == "ts":
            if text and text != last_ts:
                last_ts = text
                emit({"k": "ts", "t": t, "v": text})
        elif text:
            emit({"k": kind, "t": t, "text": text})
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
