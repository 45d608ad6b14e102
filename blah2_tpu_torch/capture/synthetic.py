"""Synthetic 2-channel IQ with injected targets (the port's own NumPy copy
of ``blah2_tpu/capture/synthetic.py::synthetic_cpi`` and ``TargetSpec``).

A reference channel of complex Gaussian noise and a surveillance channel of
scaled, delayed, Doppler-shifted copies (targets), direct-path clutter and
additive noise: targets at known delay, Doppler and SNR give golden
expectations for the ambiguity/CFAR chain.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


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
    """One CPI of (reference, surveillance) complex128 samples.

    Surveillance: y[t] = Σ a·x[t−d]·exp(j2π f t/fs) + c·x[t] + noise.
    """
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n_samples)
         + 1j * rng.standard_normal(n_samples)) / np.sqrt(2)
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
            rng.standard_normal(n_samples)
            + 1j * rng.standard_normal(n_samples)) / np.sqrt(2)
    return x, y
