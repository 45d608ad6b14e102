"""The traffic generators: the open loop's schedule, its lag and the first
CPI a full ring may have dropped; the replay's flow control."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import manifest

ROOT = manifest.ROOT


class Ring:
    """A ring with the runtime rings' interface: ``push`` drops the oldest
    samples of a full ring, ``push_wait`` blocks until the block fits."""

    def __init__(self, capacity):
        self.capacity, self.closed, self.dropped = capacity, False, 0
        self.data = []
        self.cv = threading.Condition()

    def __len__(self):
        return len(self.data)

    def push(self, block):
        with self.cv:
            self.data.extend(block.tolist())
            over = len(self.data) - self.capacity
            if over > 0:
                del self.data[:over]
                self.dropped += over
            self.cv.notify_all()

    def push_wait(self, block, timeout=None):
        with self.cv:
            if not self.cv.wait_for(
                    lambda: self.capacity - len(self.data) >= len(block),
                    timeout):
                return False
            self.data.extend(block.tolist())
            self.cv.notify_all()
            return True

    def pop(self, n):
        with self.cv:
            self.cv.wait_for(lambda: len(self.data) >= n, 5.0)
            out, self.data[:n] = self.data[:n], []
            self.cv.notify_all()
            return out


def kind(name):
    return manifest.load_module(f"{ROOT}/benchmark/traffic/{name}.py",
                                f"test_kind_{name}")


def scene(n, cpis):
    x = [np.arange(k * n, (k + 1) * n, dtype=np.complex64)
         for k in range(cpis)]
    return SimpleNamespace(x=x, y=[-v for v in x])


def test_paced_pushes_each_chunk_at_its_due_time():
    n, rate = 8000, 1e6          # a CPI every 8 ms, chunks every 1 ms
    rings = Ring(10 * n), Ring(10 * n)
    gen = kind("paced").Generator(
        rings, scene(n, 2), {"chunks_per_cpi": 8, "rate_msps": rate / 1e6},
        n)
    gen.warmup(3)
    assert len(rings[0]) == 3 * n and gen.next_cpi == 3
    t0 = time.perf_counter() + 0.01
    gen.start(t0, t0 + 0.0505)
    gen._thread.join(2.0)
    gen.stop()
    # CPIs 3..8 are due by t0 + 50.5 ms: CPI 3 + j at t0 + (j + 1) 8 ms.
    assert sorted(gen.due) == [3, 4, 5, 6, 7, 8]
    for j, k in enumerate(sorted(gen.due)):
        assert gen.due[k] == pytest.approx(t0 + (j + 1) * n / rate)
    assert len(gen.lags_ms) == 8 * 6 + 2        # and two chunks of CPI 9
    assert all(lag >= 0.0 for lag in gen.lags_ms)
    assert np.percentile(gen.lags_ms, 50) < 20.0
    assert gen.drop_cpi is None
    # The samples went in order: CPI k is scene CPI k % 2.
    assert rings[0].data[3 * n] == 1 * n and rings[0].data[4 * n] == 0


def test_paced_records_the_first_cpi_a_full_ring_may_have_dropped():
    n = 8000
    rings = Ring(2 * n), Ring(2 * n)   # nobody pops: the rings overflow
    gen = kind("paced").Generator(
        rings, scene(n, 2), {"chunks_per_cpi": 8, "rate_msps": 4.0}, n)
    gen.warmup(2)
    t0 = time.perf_counter()
    gen.start(t0, t0 + 0.03)
    gen._thread.join(2.0)
    gen.stop()
    # The first drop comes with CPI 2's first chunk; a ring two CPIs long
    # may then have lost samples of CPI 2 - 3, so from CPI 0.
    assert gen.drop_cpi == 0
    assert rings[0].dropped > 0


def test_replay_keeps_pace_with_the_consumer_and_never_drops():
    n = 8000
    rings = Ring(2 * n), Ring(2 * n)
    gen = kind("replay").Generator(
        rings, scene(n, 3), {"chunks_per_cpi": 8}, n)
    got = []

    def consume():
        for _ in range(7):
            got.append(rings[0].pop(n)[0])
            rings[1].pop(n)

    t = threading.Thread(target=consume)
    t.start()
    gen.warmup(2)
    gen.start(time.perf_counter(), 0.0)
    t.join(10.0)
    gen.stop()
    assert not t.is_alive()
    assert got == [0, n, 2 * n, 0, n, 2 * n, 0]
    assert rings[0].dropped == 0 and rings[1].dropped == 0
