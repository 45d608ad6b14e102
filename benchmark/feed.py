"""What every traffic kind shares: the scene's CPIs cut into chunks and
pushed into the runtime's two rings, in the role of the SDR driver's
callback, with the time each CPI was due.

A kind (``traffic/<kind>.py``) subclasses :class:`Feed` and gives
``window(t0, t_end)``, the traffic of the measured window. The warm-up
CPIs before it are always pushed with flow control, so set-up never loses
a sample. CPI ``k`` is the scene's CPI ``k % cpis``; the runtime takes its
windows in the same order, so the k-th CPI it serves is CPI k as long as no
ring has dropped a sample.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class Feed:
    def __init__(self, rings, scene, params: dict, n_samples: int):
        self.b1, self.b2 = rings
        self.scene = scene
        self.params = params
        self.n = n_samples
        self.chunks = int(params["chunks_per_cpi"])
        self.chunk = n_samples // self.chunks
        self.next_cpi = 0              # index of the next CPI to push
        self.due: Dict[int, float] = {}    # CPI index -> due (perf_counter)
        self.lags_ms: List[float] = []     # how late each chunk went out
        # The first CPI whose samples a ring may have dropped: a full ring
        # drops its oldest samples, up to a ring's length behind the push.
        self.drop_cpi: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def cpi_chunks(self, k: int):
        j = k % len(self.scene.x)
        x, y, c = self.scene.x[j], self.scene.y[j], self.chunk
        for i in range(self.chunks):
            yield x[i * c:(i + 1) * c], y[i * c:(i + 1) * c]

    def push_blocking(self, xb, yb) -> bool:
        """Both chunks into their rings with flow control, x first (a ring
        of two chunks or more cannot deadlock so). False once stopped or a
        ring is closed."""
        for ring, block in ((self.b1, xb), (self.b2, yb)):
            while not ring.push_wait(block, timeout=0.2):
                if self._stop.is_set() or getattr(ring, "closed", False):
                    return False
        return True

    def push_now(self, xb, yb, k: int) -> None:
        """Both chunks at once, as a driver callback does: a full ring drops
        its oldest samples, and the first CPI that may have lost any is
        recorded."""
        before = (self.b1.dropped, self.b2.dropped)
        self.b1.push(xb)
        self.b2.push(yb)
        if self.drop_cpi is None and (self.b1.dropped,
                                      self.b2.dropped) != before:
            behind = -(-self.b1.capacity // self.n) + 1
            self.drop_cpi = max(0, k - behind)

    def warmup(self, n_cpis: int) -> None:
        """Push the CPIs from the next one to ``n_cpis`` - 1 with flow
        control (blocks until they are in the rings)."""
        for k in range(self.next_cpi, n_cpis):
            for xb, yb in self.cpi_chunks(k):
                if not self.push_blocking(xb, yb):
                    return
        self.next_cpi = n_cpis

    def window(self, t0: float, t_end: float) -> None:
        raise NotImplementedError

    def start(self, t0: float, t_end: float) -> None:
        def body():
            try:
                self.window(t0, t_end)
            except BaseException as e:  # read by the harness after join
                self.error = e

        self._thread = threading.Thread(target=body, name="feed",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("the traffic generator did not stop")
        if self.error is not None:
            raise self.error

    def sleep_until(self, t: float) -> bool:
        """Wait until perf_counter reaches ``t``; False if stopped first."""
        while True:
            left = t - time.perf_counter()
            if left <= 0:
                return not self._stop.is_set()
            if self._stop.wait(min(left, 0.05)):
                return False
