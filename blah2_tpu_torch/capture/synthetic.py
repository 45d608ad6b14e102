"""Synthetic 2-channel IQ generation with injected targets.

The reference only sketches a functional-test tier (`test/README.md`, Types;
dirs anticipated by `CMakeLists.txt:27-29` but empty). This module provides it:
a reference channel of complex Gaussian noise and a surveillance channel
containing scaled/delayed/Doppler-shifted copies (targets), direct-path
clutter, and additive noise — targets at known delay/Doppler/SNR give golden
expectations for the ambiguity/CFAR/tracker chain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from blah2_tpu_torch.capture.source import Source


@dataclasses.dataclass
class TargetSpec:
    delay_bins: int
    doppler_hz: float
    amplitude: float


def synthetic_cpi(
    n_samples: int,
    fs: float,
    targets: Sequence[TargetSpec] = (),
    clutter_amplitude: float = 0.0,
    noise_amplitude: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate one CPI of (reference, surveillance) float64 complex samples.

    Surveillance: y[t] = Σ a·x[t−d]·exp(j2π f t/fs) + c·x[t] + noise.
    """
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)) / np.sqrt(2)
    y = np.zeros(n_samples, dtype=np.complex128)
    t = np.arange(n_samples, dtype=np.float64) / fs
    for tgt in targets:
        delayed = np.zeros_like(x)
        d = int(tgt.delay_bins)
        if d >= 0:
            delayed[d:] = x[: n_samples - d]
        else:
            delayed[:d] = x[-d:]
        y += tgt.amplitude * delayed * np.exp(2j * np.pi * tgt.doppler_hz * t)
    if clutter_amplitude:
        y += clutter_amplitude * x
    if noise_amplitude:
        y += noise_amplitude * (
            rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)
        ) / np.sqrt(2)
    return x, y


class SyntheticSource(Source):
    """Streaming capture source that emits a *phase-continuous* synthetic
    sample stream in blocks.

    Continuity matters: the consumer assembles CPI windows from arbitrary
    contiguous runs of the stream (ring overflow, overlap, chunked ingest
    all shift the alignment), so target Doppler phase must advance with the
    global sample index and delayed target copies must draw on the previous
    block's reference tail — otherwise any CPI straddling a block boundary
    sees decohered targets (a round-1 bug that surfaced as order-dependent
    runtime-test failures)."""

    #: Synthetic samples are unit-variance floats; map them onto a
    #: plausible ADC scale for the int16-quad record format (an unscaled
    #: cast would truncate the stream to {-1, 0, 1} — see
    #: Source.record_scale).
    record_scale = 1024.0

    def __init__(
        self,
        fs: float,
        fc: float,
        targets: Sequence[TargetSpec] = (),
        clutter_amplitude: float = 0.0,
        noise_amplitude: float = 1e-3,
        block_samples: int = 65536,
        seed: int = 0,
        path: Optional[str] = None,
    ):
        super().__init__("Synthetic", fs, fc, path)
        self.targets = list(targets)
        self.clutter_amplitude = clutter_amplitude
        self.noise_amplitude = noise_amplitude
        self.block_samples = int(block_samples)
        self._seed = seed
        self._block_idx = 0
        self._offset = 0  # global sample index of the next block's start
        # Reference-channel history for delayed target copies (positive
        # delays only; negative delays would need lookahead).
        self._max_delay = max(
            (int(t.delay_bins) for t in self.targets if t.delay_bins > 0),
            default=0)
        self._x_hist = np.zeros(self._max_delay, dtype=np.complex128)

    def next_block(self):
        """Generate the next contiguous (x, y) block of the stream."""
        n, fs, md = self.block_samples, self.fs, self._max_delay
        rng = np.random.default_rng(self._seed + self._block_idx)
        self._block_idx += 1
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
            / np.sqrt(2)
        xh = np.concatenate([self._x_hist, x])
        t = (self._offset + np.arange(n, dtype=np.float64)) / fs
        y = np.zeros(n, dtype=np.complex128)
        for tgt in self.targets:
            d = int(tgt.delay_bins)
            if d >= 0:
                delayed = xh[md - d:md - d + n]
            else:  # within-block only: future samples are not available
                delayed = np.zeros_like(x)
                delayed[:d] = x[-d:]
            y += tgt.amplitude * delayed * np.exp(
                2j * np.pi * tgt.doppler_hz * t)
        if self.clutter_amplitude:
            y += self.clutter_amplitude * x
        if self.noise_amplitude:
            y += self.noise_amplitude * (
                rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ) / np.sqrt(2)
        if md:
            self._x_hist = xh[-md:]
        self._offset += n
        return x, y

    def process(self, buffer1, buffer2) -> None:
        # Flow-controlled lockstep pushes (Source.push_pair_blocking): a
        # synthetic stream has no real-time deadline, so it paces to the
        # consumer rather than drop-oldest. The rings therefore never
        # overflow, the channels can never desynchronise, and every CPI
        # window sees identical stream content regardless of host load —
        # an unpaced push loop here caused order-dependent e2e failures
        # (asymmetric overflow between the two rings destroyed the
        # cross-correlation permanently).
        while not self.stopped:
            x, y = self.next_block()
            self.record(x, y)
            if not self.push_pair_blocking(
                    buffer1, buffer2,
                    x.astype(np.complex64), y.astype(np.complex64)):
                return
