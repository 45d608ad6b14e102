"""Traffic kind ``replay``: upstream's file replay (`capture/replay.py`),
the scene's CPIs looped and pushed as fast as the rings accept them. Flow
control never drops a sample, so the runtime sets the pace: what the
window measures is its capacity."""

from __future__ import annotations

from benchmark.feed import Feed


class Generator(Feed):
    def window(self, t0: float, t_end: float) -> None:
        k = self.next_cpi
        while not self._stop.is_set():
            for xb, yb in self.cpi_chunks(k):
                if not self.push_blocking(xb, yb):
                    return
            k += 1
            self.next_cpi = k
