"""File replay source for recorded 2-channel IQ.

Reads the reference's interleaved int16 quad format ``i1,q1,i2,q2`` — the
only replay format the reference fully implements (`RspDuo.cpp:150-179`,
documented as the golden-data format in `test/unit/process/ambiguity/
TestAmbiguity.cpp:39-69`) — in large blocks, converts to complex64 on the
host, and pushes into both ring buffers.

Unlike the reference's one-sample-at-a-time fread loop, blocks are read and
converted vectorized; pacing can be real-time (fs samples/s, for live-like
operation) or unpaced (as fast as the consumer drains, for benchmarks).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from blah2_tpu_torch.capture.source import Source


class FileReplaySource(Source):
    def __init__(
        self,
        fs: float,
        fc: float,
        file: str,
        loop: bool = True,
        realtime: bool = False,
        block_samples: int = 262144,
        path: Optional[str] = None,
        type_name: str = "RspDuo",
    ):
        super().__init__(type_name, fs, fc, path)
        self.file = file
        self.loop = bool(loop)
        self.realtime = bool(realtime)
        self.block_samples = int(block_samples)

    @staticmethod
    def decode_block(raw: np.ndarray):
        """int16 quads (n,4) → (ch1, ch2) complex64 arrays."""
        f = raw.astype(np.float32)
        ch1 = (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)
        ch2 = (f[:, 2] + 1j * f[:, 3]).astype(np.complex64)
        return ch1, ch2

    def process(self, buffer1, buffer2) -> None:
        self.replay(buffer1, buffer2, self.file, self.loop)

    class _NumpyReader:
        """Fallback block reader matching NativeReplayReader's interface."""

        def __init__(self, file: str):
            self._f = open(file, "rb")

        def read(self, max_samples: int):
            raw = np.fromfile(self._f, dtype=np.int16, count=max_samples * 4)
            n = len(raw) // 4  # partial trailing quads dropped
            return FileReplaySource.decode_block(raw[: n * 4].reshape(n, 4))

        def rewind(self) -> None:
            self._f.seek(0)

        def close(self) -> None:
            self._f.close()

    def _open_reader(self, file: str):
        """Native int16-quad block reader when built, else numpy."""
        from blah2_tpu_torch import native

        if native.available():
            return native.NativeReplayReader(file)
        return self._NumpyReader(file)

    def replay(self, buffer1, buffer2, file: str, loop: bool) -> None:
        t_next = time.monotonic()
        reader = self._open_reader(file)
        try:
            while not self.stopped:
                while not self.stopped:
                    ch1, ch2 = reader.read(self.block_samples)
                    n = len(ch1)
                    if n == 0:
                        break
                    self.record(ch1, ch2)
                    # Replay pushes only when space is free
                    # (RspDuo.cpp:169-178); block until the consumer
                    # drains. Never fall back to drop-oldest: an
                    # asymmetric overflow would desynchronise the
                    # channels permanently (Source.push_pair_blocking).
                    if not self.push_pair_blocking(buffer1, buffer2,
                                                   ch1, ch2):
                        return
                    if self.realtime:
                        t_next += n / self.fs
                        dt = t_next - time.monotonic()
                        if dt > 0:
                            time.sleep(dt)
                if not loop:
                    break
                reader.rewind()
        finally:
            reader.close()
