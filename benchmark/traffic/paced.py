"""Traffic kind ``paced``: an open loop, as an SDR delivers samples. From
``t0`` on, chunk ``i`` of window CPI ``j`` is due when its last sample is:
``t0 + (j * n + (i + 1) * chunk) / rate``, ``rate_msps`` million samples a
second a channel. Each chunk is pushed at its due time whether or not the
runtime keeps up; a full ring drops its oldest samples. A CPI is due with
its last chunk, and its products' age runs from then."""

from __future__ import annotations

import time

from benchmark.feed import Feed


class Generator(Feed):
    def window(self, t0: float, t_end: float) -> None:
        rate = float(self.params["rate_msps"]) * 1e6
        first = k = self.next_cpi
        while True:
            base = t0 + (k - first) * self.n / rate
            for i, (xb, yb) in enumerate(self.cpi_chunks(k)):
                due = base + (i + 1) * self.chunk / rate
                if due > t_end or not self.sleep_until(due):
                    return
                self.push_now(xb, yb, k)
                self.lags_ms.append((time.perf_counter() - due) * 1e3)
            self.due[k] = base + self.n / rate
            k += 1
            self.next_cpi = k
