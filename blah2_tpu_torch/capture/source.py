"""Capture source abstraction and IQ recording.

Parity with reference `src/capture/Source.{h,cpp}`: an abstract device with
``start()/stop()/process()/replay()`` (`Source.h:54-71`) and timestamped
record files ``<path><YYYYmmdd-HHMMSS>.<type>.iq`` (`Source.cpp:25-63`).

Recordings use the reference's RspDuo interleaved int16 quad format
``i1,q1,i2,q2`` (`RspDuo.cpp:150-179`) — the golden-data/replay format —
regardless of source type, so recordings from any source replay everywhere.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np


class Source:
    #: Multiplier applied to samples before the int16-quad cast in
    #: :meth:`record`. Sources whose samples already are integer ADC
    #: counts (RspDuo shorts, HackRF/Kraken int8) keep 1.0; float-valued
    #: sources (USRP fc32 in [-1, 1], Synthetic unit-variance) must scale
    #: up or the unscaled cast quantises everything to {-1, 0, 1}.
    record_scale: float = 1.0

    #: record_channel backlog bound (samples per channel, ~2 s at 2 Msps):
    #: if one vendor thread stalls or dies mid-recording (HackRF/Kraken
    #: units stream independently), the other channel's pending list must
    #: not grow without limit at the full sample rate.
    record_pending_max: int = 4_000_000

    def __init__(self, type_name: str, fs: float, fc: float,
                 path: Optional[str] = None):
        self.type_name = type_name
        self.fs = float(fs)
        self.fc = float(fc)
        self.path = path
        self.stopped = False
        self._record_file = None
        self._record_lock = threading.Lock()
        # Per-channel pending blocks for record_channel (devices whose two
        # channels stream from independent vendor threads).
        self._record_pending: list = [[], []]
        #: Samples discarded from a record_channel backlog that exceeded
        #: ``record_pending_max``.
        self.n_record_desync = 0
        # Per-channel discard debt: when channel A's backlog drops N
        # samples (peer stalled), the peer owes N discards on resume so
        # the recorded pairing stays time-aligned.
        self._record_debt = [0, 0]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.stopped = False

    def stop(self) -> None:
        self.stopped = True

    def kill(self) -> None:
        """SIGTERM-path graceful stop (`Source.cpp:65-75`)."""
        self.stop()
        self.close_record_file()

    def process(self, buffer1, buffer2) -> None:
        raise NotImplementedError

    def replay(self, buffer1, buffer2, file: str, loop: bool) -> None:
        raise NotImplementedError(f"{self.type_name} does not support replay")

    def push_pair_blocking(self, buffer1, buffer2,
                           ch1: np.ndarray, ch2: np.ndarray) -> bool:
        """Push one paired block into both rings with flow control —
        never drop-oldest. Blocks until the consumer drains. Returns
        False once the source is stopped or a ring is closed.

        Why this exists: drop-oldest overflow can shed *different*
        sample counts from the two rings (pushes and pops interleave
        arbitrarily under host load), permanently desynchronising the
        channels — the cross-correlation then collapses with no way to
        recover. The reference never hits this because its per-sample
        pushes run with BOTH buffers locked in lockstep
        (`RspDuo.cpp:493-552`) and its extractor only pops full CPIs
        from both (`src/blah2.cpp:248-260`). Real SDR callbacks must
        not block (drop-oldest is correct there), but sources with no
        real-time deadline — synthetic generation, file replay — must
        flow-control to the consumer instead.

        Progress guarantees (both were real deadlocks caught in r3):
        pushes are PARTIAL — whatever currently fits is pushed
        immediately, so the producer can always fill a ring to exactly
        its capacity (a fixed push quantum deadlocks when free space can
        never reach the quantum while the consumer waits for a full CPI,
        e.g. ``buffer: 1`` ⇒ ring == one CPI) — and the two buffers are
        fed INTERLEAVED, never sequentially (pushing all of ch1 first
        deadlocks when the block exceeds the ring: buffer1 fills, the
        producer blocks on it, and the consumer waits forever for
        buffer2, which hasn't been touched)."""
        bufs = (buffer1, buffer2)
        blocks = (ch1, ch2)
        i = [0, 0]
        while i[0] < len(ch1) or i[1] < len(ch2):
            if self.stopped:
                return False
            progressed = False
            for k in (0, 1):
                buf, block = bufs[k], blocks[k]
                if i[k] >= len(block):
                    continue
                if getattr(buf, "closed", False):
                    return False
                free = getattr(buf, "capacity", len(block)) - len(buf)
                if free <= 0:
                    continue
                take = min(free, len(block) - i[k])
                # Single producer per ring: `free` cannot shrink before
                # the push, so this fits immediately.
                if buf.push_wait(block[i[k]:i[k] + take], timeout=0.2):
                    i[k] += take
                    progressed = True
            if not progressed:
                # Both unfinished rings are full: wait for the consumer
                # to pop (it pops both together), re-checking stop/close.
                k = 0 if i[0] < len(ch1) else 1
                if bufs[k].push_wait(blocks[k][i[k]:i[k] + 1], timeout=0.2):
                    i[k] += 1
        return True

    # -- recording -----------------------------------------------------------
    def open_record_file(self) -> Optional[str]:
        if not self.path:
            return None
        ts = time.strftime("%Y%m%d-%H%M%S")
        filename = os.path.join(
            self.path, f"{ts}.{self.type_name.lower()}.iq"
        )
        os.makedirs(self.path, exist_ok=True)
        with self._record_lock:
            if self._record_file is not None:
                self._record_file.close()
            self._record_file = open(filename, "ab")
            self._record_pending = [[], []]
            self._record_debt = [0, 0]
        return filename

    def close_record_file(self) -> None:
        with self._record_lock:
            if self._record_file is not None:
                self._record_file.close()
                self._record_file = None
            # Unpaired per-channel tails must not leak into the next
            # recording session (record_channel).
            self._record_pending = [[], []]
            self._record_debt = [0, 0]

    @property
    def recording(self) -> bool:
        return self._record_file is not None

    def _write_quads(self, ch1: np.ndarray, ch2: np.ndarray) -> None:
        """Append paired samples as interleaved int16 quads (record lock
        held). ``record_scale`` maps the source's sample range onto ADC
        counts before the cast."""
        n = min(len(ch1), len(ch2))
        s = self.record_scale

        def counts(v):
            return np.clip(v * s if s != 1.0 else v,
                           -32768, 32767).astype(np.int16)

        quads = np.empty((n, 4), dtype=np.int16)
        quads[:, 0] = counts(np.real(ch1[:n]))
        quads[:, 1] = counts(np.imag(ch1[:n]))
        quads[:, 2] = counts(np.real(ch2[:n]))
        quads[:, 3] = counts(np.imag(ch2[:n]))
        quads.tofile(self._record_file)

    def record(self, ch1: np.ndarray, ch2: np.ndarray) -> None:
        """Append a 2-channel block as interleaved int16 quads."""
        with self._record_lock:
            if self._record_file is None:
                return
            self._write_quads(ch1, ch2)

    def record_channel(self, idx: int, block: np.ndarray) -> None:
        """Record from per-channel vendor callbacks (HackRF/Kraken stream
        each channel from its own thread): blocks are buffered per channel
        and flushed as paired quads once both channels cover the samples.
        Pending blocks are dropped when recording is off so a toggle
        cannot pair stale history with fresh samples."""
        with self._record_lock:
            if self._record_file is None:
                if self._record_pending[0] or self._record_pending[1]:
                    self._record_pending = [[], []]
                    self._record_debt = [0, 0]
                return
            block = np.asarray(block)
            # Pay down discard debt first: these samples' pairs on the
            # other channel were already dropped (backlog cap below), so
            # discarding them keeps the recorded channels time-aligned.
            debt = self._record_debt[idx]
            if debt > 0:
                take = min(debt, len(block))
                self._record_debt[idx] -= take
                block = block[take:]
                if len(block) == 0:
                    return
            self._record_pending[idx].append(block)
            # Bound the backlog: if the *other* channel stalls, this
            # channel's pending list would grow at the full sample rate
            # for the rest of the session. Drop oldest-first past the cap,
            # count the desync, and charge the peer an equal discard debt
            # so pairing re-aligns when it resumes.
            pend = self._record_pending[idx]
            excess = sum(len(b) for b in pend) - self.record_pending_max
            while excess > 0 and pend:
                dropped = pend.pop(0)
                excess -= len(dropped)
                self.n_record_desync += len(dropped)
                self._record_debt[1 - idx] += len(dropped)
            n = min(sum(len(b) for b in self._record_pending[0]),
                    sum(len(b) for b in self._record_pending[1]))
            if n == 0:
                return
            chans = []
            for c in (0, 1):
                cat = np.concatenate(self._record_pending[c])
                chans.append(cat[:n])
                rest = cat[n:]
                self._record_pending[c] = [rest] if len(rest) else []
            self._write_quads(chans[0], chans[1])


