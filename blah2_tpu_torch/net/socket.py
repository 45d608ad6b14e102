"""TCP JSON egress socket.

Parity with reference `src/process/utility/Socket.{h,cpp}`: a blocking TCP
client that sends JSON strings in MTU=1024-byte chunks (`Socket.cpp:4-5,
21-32`). The API's TCP listeners accumulate chunks until the trailing ``}``
(`api/server.js:123-136`), so chunking is part of the wire contract.

Additions over the reference (which crashes at startup if the API is down,
`src/blah2.cpp:101-112`): lazy connect with bounded retry and automatic
reconnect on a broken pipe.
"""

from __future__ import annotations

import socket
import time
from typing import Optional

MTU = 1024


class JsonTcpSender:
    def __init__(self, ip: str, port: int, connect_timeout: float = 5.0,
                 retry_interval: float = 1.0):
        self.ip = "127.0.0.1" if ip == "0.0.0.0" else ip
        self.port = int(port)
        self.connect_timeout = connect_timeout
        self.retry_interval = retry_interval
        self._sock: Optional[socket.socket] = None

    def connect(self, max_wait: float = 10.0) -> bool:
        deadline = time.monotonic() + max_wait
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection(
                    (self.ip, self.port), timeout=self.connect_timeout
                )
                s.settimeout(self.connect_timeout)
                self._sock = s
                return True
            except OSError:
                time.sleep(self.retry_interval)
        return False

    def send_data(self, json_str: str) -> bool:
        """Send a JSON string in 1024-byte chunks; reconnect once on failure."""
        payload = json_str.encode()
        for attempt in range(2):
            if self._sock is None and not self.connect(max_wait=2.0):
                return False
            try:
                for i in range(0, len(payload), MTU):
                    self._sock.sendall(payload[i : i + MTU])
                return True
            except OSError:
                self.close()
        return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
