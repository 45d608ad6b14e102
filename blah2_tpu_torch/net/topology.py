"""Checks of the 3-process topology: the standalone API's ingest ports and
its REST surface (what ``deploy/smoke_3proc.sh`` checks for JAX).

One place for what the port's topology runs must see, shared by
``deploy/smoke_3proc_torch.sh``, ``bench/soak_supervised.py`` and the tests:

- :func:`wait_for_ports`: every ingest port of the API accepts a
  connection (the radar's senders connect when it starts);
- :func:`rest_checks`: each path of :data:`REST_CHECKS` answers with what it
  must hold, after the last CPI's timing product has arrived.

Imports no torch, so it runs beside an API process in a second or less.

    python -m blah2_tpu_torch.net.topology wait CONFIG --pid API_PID
    python -m blah2_tpu_torch.net.topology rest CONFIG --cpis 3

Each exits 0 when every check passes, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
import urllib.request
from typing import Callable, Dict, Iterable, Optional

import yaml

#: The ingest ports the radar's senders connect to, after the API's own.
PRODUCT_PORTS = ("map", "detection", "track", "timestamp", "timing",
                 "iqdata")
#: Longest the command's wait for the API's ports may take.
WAIT_SECONDS = 120.0
#: The REST surface: path, and what its body must hold.
REST_CHECKS = (("/api/map", b"nRows"), ("/api/detection", b"timestamp"),
               ("/api/timing", b"nCpi"), ("/api/iqdata", b"spectrum"),
               ("/stash/map", b"nRows"), ("/", b"<html"),
               ("/favicon/favicon-32x32.png", b"PNG"))


def config_ports(path: str) -> list:
    """The API port, then the six product ports, of the config at
    ``path``."""
    with open(path) as f:
        ports = yaml.safe_load(f)["network"]["ports"]
    return [ports["api"]] + [ports[k] for k in PRODUCT_PORTS]


def wait_for_ports(ports: Iterable[int], alive: Callable[[], bool],
                   seconds: float) -> None:
    """Wait until every port in ``ports`` accepts a connection; raise if
    ``alive()`` turns false (the API process exited) or ``seconds``
    pass."""
    deadline = time.monotonic() + seconds
    for port in ports:
        while True:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1.0).close()
                break
            except OSError:
                if not alive():
                    raise RuntimeError("the API process exited")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"port {port} not open after "
                                       f"{seconds} s")
                time.sleep(0.1)


def get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read()


def rest_checks(port: int, cpis: Optional[int] = None,
                seconds: float = 10.0) -> Dict[str, bool]:
    """{path: whether it holds what :data:`REST_CHECKS` asks} of the API on
    ``port``. With ``cpis``, first wait up to ``seconds`` for the timing
    product of CPI ``cpis`` (the last CPI's products were sent before the
    radar exited; the API swaps them in on its ingest threads), and report
    it as ``/api/timing nCpi <cpis>``."""
    found = {}
    if cpis is not None:
        deadline = time.monotonic() + seconds
        while True:
            try:
                ok = json.loads(get(port, "/api/timing") or b"{}") \
                    .get("nCpi") == cpis
            except (OSError, ValueError):
                ok = False
            if ok or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        found[f"/api/timing nCpi {cpis}"] = ok
    for path, want in REST_CHECKS:
        try:
            found[path] = want in get(port, path)
        except OSError:
            found[path] = False
    return found


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m blah2_tpu_torch.net.topology",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("check", choices=("wait", "rest"))
    ap.add_argument("config", help="the topology's config file")
    ap.add_argument("--pid", type=int,
                    help="wait: the API process, whose exit fails the wait")
    ap.add_argument("--cpis", type=int, default=None,
                    help="rest: the timing product's nCpi to wait for")
    args = ap.parse_args(argv)
    ports = config_ports(args.config)
    if args.check == "wait":
        if args.pid is None:
            ap.error("wait needs --pid")
        try:
            wait_for_ports(ports, lambda: _alive(args.pid), WAIT_SECONDS)
        except RuntimeError as e:
            print(f"FAIL: {e}")
            return 1
        return 0
    found = rest_checks(ports[0], args.cpis)
    for what, ok in found.items():
        print(f"{'ok ' if ok else 'FAIL'} {what}")
    return 0 if all(found.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
