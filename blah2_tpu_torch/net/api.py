"""REST API middleware with raw-TCP product ingest.

A Python reimplementation of the reference's Node.js API layer
(`api/server.js`), keeping the exact wire contract:

  - six raw-TCP listeners (map/detection/track on 3001-3003, timestamp/
    timing/iqdata on 4000-4002 per `config/config.yml:52-60`); each
    accumulates chunks until the trailing ``}`` then swaps the latest JSON
    into memory (`api/server.js:123-213`; the timestamp listener publishes
    every chunk, `api/server.js:166-176`);
  - REST endpoints ``/api/{map,detection,tracker,timestamp,timing,iqdata,
    config,adsb2dd}``, ``/stash/{map,detection,iqdata,timing}``,
    ``/capture`` and ``/capture/toggle`` (`api/server.js:48-117`) with
    CORS/no-cache headers (`api/server.js:40-46`);
  - the adsb2dd truth-query URL built from rx/tx geodetic config
    (`api/server.js:72-93`).

Differences: stashes update in-process on ingest instead of self-polling the
REST API at 10 Hz (same windows/output shapes); the server can also be fed
in-process (`publish``) when the radar runtime runs in the same process.
"""

from __future__ import annotations

import json
import mimetypes
import os
import socket
import socketserver
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from blah2_tpu_torch.config import Config
from blah2_tpu_torch.net.stash import (
    DetectionStash,
    IqDataStash,
    MaxholdStash,
    TimingStash,
)

PRODUCTS = ("map", "detection", "track", "timestamp", "timing", "iqdata")


class ApiState:
    def __init__(self):
        self.products: Dict[str, str] = {p: "" for p in PRODUCTS}
        self.capture = False
        self.lock = threading.Lock()
        self.maxhold = MaxholdStash()
        self.detection_stash = DetectionStash()
        self.iqdata_stash = IqDataStash()
        self.timing_stash = TimingStash()

    def publish(self, product: str, payload: str, parsed=None) -> None:
        """Swap ``payload`` in and update the product's stash.

        ``parsed`` skips the stash's JSON parse: a dict doc (TCP ingest
        hands the object it already decoded while framing), or for ``map``
        alternatively the zero-serialization triple
        ``(head_json, timestamp, dB ndarray)`` from the in-process radar
        runtime (see ``MaxholdStash.update_serialized``)."""
        with self.lock:
            self.products[product] = payload
        if product == "map":
            if isinstance(parsed, tuple):
                self.maxhold.update_serialized(*parsed)
            elif parsed is not None:
                self.maxhold.update_parsed(parsed)
            else:
                self.maxhold.update(payload)
            return
        stash = {"detection": self.detection_stash,
                 "iqdata": self.iqdata_stash,
                 "timing": self.timing_stash}.get(product)
        if stash is None:
            return
        if parsed is not None:
            stash.update_parsed(parsed)
        else:
            stash.update(payload)

    def get(self, product: str) -> str:
        with self.lock:
            return self.products.get(product, "")


class _IngestHandler(socketserver.BaseRequestHandler):
    """Accumulate chunks; publish complete JSON documents (timestamp:
    every chunk).

    The reference's Node listener publishes whenever the buffer ends with
    ``}`` (`api/server.js:123-136`) — a latent framing race: two products
    coalesced into one ``recv`` (the sender loops ``sendall`` per 1024-B
    chunk back-to-back, `net/socket.py`) publish as one concatenated
    string, corrupting the product. Here the buffer is split on JSON
    document boundaries with ``raw_decode`` (C-speed scan; also yields the
    parsed doc, which is handed to the stash so the TCP path never parses
    twice). The wire contract is unchanged — the same chunked streams are
    accepted, just framed correctly."""

    #: Resync bound: no product document approaches this (the full map is
    #: ~2 MB); a buffer past it means the head is poisoned by a malformed
    #: document, so the head is dropped to the next '{' to resynchronise
    #: (the replaced trailing-'}' framing recovered by accident: it
    #: published the garbage and cleared the buffer).
    MAX_BUF = 32 * 1024 * 1024

    def handle(self):
        product = self.server.product  # type: ignore[attr-defined]
        state = self.server.state  # type: ignore[attr-defined]
        decoder = json.JSONDecoder()
        buf = ""
        while True:
            try:
                data = self.request.recv(65536)
            except OSError:
                break
            if not data:
                break
            buf += data.decode(errors="replace")
            if product == "timestamp":
                state.publish(product, buf)
                buf = ""
                continue
            if not buf.endswith("}"):
                continue  # mid-document; keep accumulating
            idx = 0
            while idx < len(buf):
                while idx < len(buf) and buf[idx] in " \t\r\n":
                    idx += 1
                if idx >= len(buf):
                    break
                if buf[idx] != "{":
                    # Junk before the next document (malformed sender):
                    # skip to the next document start.
                    nxt = buf.find("{", idx)
                    if nxt < 0:
                        idx = len(buf)
                        break
                    idx = nxt
                try:
                    doc, end = decoder.raw_decode(buf, idx)
                except ValueError:
                    # Trailing partial document (or '}' inside a string)
                    # — keep accumulating. If the buffer has grown far
                    # beyond any real product, the head is a poisoned
                    # document that will never parse: resynchronise in ONE
                    # pass by scanning forward for a '{' where a document
                    # actually parses (stepping one brace per MAX_BUF
                    # refill would cost 32 MB of buffering per '{'
                    # embedded in the bad document's string literals).
                    if len(buf) - idx > self.MAX_BUF:
                        # Bounded scan: pathological input (deep nested
                        # prefixes repeated at every brace) could make an
                        # uncapped scan O(braces x token length) inside
                        # this synchronous handler; after the cap, the
                        # head is dropped wholesale.
                        scan = buf.find("{", idx + 1)
                        recovered = False
                        attempts = 0
                        while scan != -1 and attempts < 256:
                            attempts += 1
                            try:
                                doc, end = decoder.raw_decode(buf, scan)
                            except ValueError:
                                scan = buf.find("{", scan + 1)
                                continue
                            state.publish(product, buf[scan:end], parsed=doc)
                            idx = end
                            recovered = True
                            break
                        if recovered:
                            continue
                        # Nothing parseable found within the attempt cap:
                        # drop the poisoned head, keeping only the tail
                        # from the last '{' (a possible document still
                        # mid-transfer).
                        last = buf.rfind("{")
                        idx = last if last > idx else len(buf)
                    break
                state.publish(product, buf[idx:end], parsed=doc)
                idx = end
            buf = buf[idx:]


class _IngestServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, product: str, state: ApiState):
        super().__init__(addr, _IngestHandler)
        self.product = product
        self.state = state


def _build_adsb2dd_url(config: Config) -> Optional[str]:
    truth = config.truth or {}
    adsb = truth.get("adsb", {}) or {}
    if not adsb.get("enabled"):
        return None
    loc = config.location or {}
    rx, tx = loc.get("rx", {}), loc.get("tx", {})
    return (
        f"http://{adsb.get('adsb2dd')}/api/dd"
        f"?rx={rx.get('latitude')},{rx.get('longitude')},{rx.get('altitude')}"
        f"&tx={tx.get('latitude')},{tx.get('longitude')},{tx.get('altitude')}"
        f"&fc={config.capture.fc / 1_000_000}"
        f"&server=http://{adsb.get('tar1090')}"
    )


class ApiServer:
    def __init__(self, config: Config, web_root: Optional[str] = None):
        self.config = config
        self.state = ApiState()
        self.web_root = web_root
        self._servers = []
        self._threads = []

        state = self.state
        cfg = config
        adsb_url = _build_adsb2dd_url(config)
        web_root_abs = os.path.realpath(web_root) if web_root else None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, body: str, content_type="application/json",
                      status=200):
                data = body.encode()
                self.send_response(status)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Cache-Control", "private, no-cache, no-store, "
                    "must-revalidate")
                self.send_header("Expires", "-1")
                self.send_header("Pragma", "no-cache")
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_file(self, path: str) -> bool:
                """Serve a static file from the web root (the reference's
                httpd web container, `docker-compose.yml:33-43`). Directory
                paths resolve to index.html; traversal outside the root is
                rejected."""
                if web_root_abs is None:
                    return False
                rel = path.lstrip("/")
                full = os.path.realpath(os.path.join(web_root_abs, rel))
                if not (full == web_root_abs
                        or full.startswith(web_root_abs + os.sep)):
                    return False
                if os.path.isdir(full):
                    full = os.path.join(full, "index.html")
                if not os.path.isfile(full):
                    return False
                ctype = (mimetypes.guess_type(full)[0]
                         or "application/octet-stream")
                with open(full, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return True

            def do_GET(self):
                path = self.path.split("?")[0]
                routes = {
                    "/api/map": lambda: state.get("map"),
                    "/api/detection": lambda: state.get("detection"),
                    "/api/tracker": lambda: state.get("track"),
                    "/api/timestamp": lambda: state.get("timestamp"),
                    "/api/timing": lambda: state.get("timing"),
                    "/api/iqdata": lambda: state.get("iqdata"),
                    "/stash/map": state.maxhold.get,
                    "/stash/detection": state.detection_stash.get,
                    "/stash/iqdata": state.iqdata_stash.get,
                    "/stash/timing": state.timing_stash.get,
                }
                if path == "/" and web_root_abs is None:
                    self._send("Hello World", "text/plain")
                elif path in routes:
                    self._send(routes[path]())
                elif path == "/api/config":
                    self._send(json.dumps(cfg.raw))
                elif path == "/api/adsb2dd":
                    if adsb_url:
                        self._send(json.dumps({"url": adsb_url}))
                    else:
                        self._send("", status=400)
                elif path == "/capture":
                    self._send(json.dumps(state.capture))
                elif path == "/capture/toggle":
                    state.capture = not state.capture
                    self._send("{}")
                elif self._send_file(path):
                    pass
                else:
                    self._send("not found", "text/plain", 404)

        self._handler_cls = Handler

    def start(self, with_ingest: bool = True) -> None:
        net = self.config.network
        host = net.ip

        http_server = ThreadingHTTPServer((host, net.api), self._handler_cls)
        http_server.daemon_threads = True
        self._servers.append(http_server)
        t = threading.Thread(target=http_server.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

        if with_ingest:
            ports = {
                "map": net.map, "detection": net.detection,
                "track": net.track, "timestamp": net.timestamp,
                "timing": net.timing, "iqdata": net.iqdata,
            }
            for product, port in ports.items():
                srv = _IngestServer((host, port), product, self.state)
                self._servers.append(srv)
                t = threading.Thread(target=srv.serve_forever, daemon=True)
                t.start()
                self._threads.append(t)

    def publish(self, product: str, payload: str, parsed=None) -> None:
        """In-process publish path (no TCP round trip); ``parsed`` skips
        the stash JSON parse (see ``ApiState.publish``)."""
        self.state.publish(product, payload, parsed=parsed)

    def stop(self) -> None:
        for s in self._servers:
            try:
                s.shutdown()
                s.server_close()
            except Exception:
                pass
        self._servers.clear()


def main(argv=None) -> int:
    """Standalone API process: ``python -m blah2_tpu_torch.net.api -c config.yml``.

    Reproduces the reference's 3-process topology where the API runs as its
    own container (`api/server.js:1`, `docker-compose.yml:20-30` there): the
    radar process connects with ``--no-api --tcp-egress`` and streams the six
    JSON products over TCP into this process's ingest listeners.
    """
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        prog="blah2_tpu_torch.net.api",
        description="blah2_tpu REST API middleware (standalone process)")
    parser.add_argument("--config", "-c", required=True,
                        help="YAML config file (blah2 schema)")
    default_web = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "web")
    parser.add_argument("--web-root",
                        default=default_web if os.path.isdir(default_web)
                        else None,
                        help="serve the web frontend from this directory "
                             "(default: the repo's web/)")
    parser.add_argument("--no-ingest", action="store_true",
                        help="REST only: do not open the six TCP product "
                             "ingest listeners")
    args = parser.parse_args(argv)

    from blah2_tpu_torch.config import load_config

    config = load_config(args.config)
    server = ApiServer(config, web_root=args.web_root)
    server.start(with_ingest=not args.no_ingest)
    net = config.network
    print(f"API on http://{net.ip}:{net.api}"
          + ("" if args.no_ingest else
             f"; ingest on ports {net.map},{net.detection},{net.track},"
             f"{net.timestamp},{net.timing},{net.iqdata}"),
          flush=True)

    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
