"""Cross-ambiguity function via the batches algorithm (counterpart of
``blah2_tpu/dsp/ambiguity.py``).

Algorithm (Principles of Modern Radar vol. II ch. 17, as in the reference
`src/process/ambiguity/Ambiguity.{h,cpp}`): split the CPI into
``n_doppler_bins`` pulses of ``n_corr`` samples; per pulse, cross-correlate
surveillance against reference over the delay window via FFTs; then
transform along the pulse axis per delay column to resolve Doppler.

  - the per-pulse range stage is one batched cuFFT over a
    ``(n_doppler_bins, nfft_compute)`` array;
  - the lag window is one index select of precomputed lag columns;
  - the Doppler stage is one complex matrix product with the precomputed
    shifted-DFT matrix, which folds the reference's fftshift permutation
    (`Ambiguity.cpp:163-167`) into the operator. An FFT-plus-take path is
    kept for testing.

Derived geometry as in `Ambiguity.cpp:16-80`: n_delay_bins, doppler_middle,
n_doppler_bins from the Doppler-resolution walk, n_corr = n // n_doppler_bins,
cpi, Hamming-rounded nfft = 2·n_corr − 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from blah2_tpu_torch.device import real_dtype, resolve_device
from blah2_tpu_torch.dsp.hamming import next_fft_size, next_hamming


class AmbiguityProcessor(nn.Module):
    def __init__(
        self,
        delay_min: int,
        delay_max: int,
        doppler_min: float,
        doppler_max: float,
        fs: int,
        n_samples: int,
        round_hamming: bool = True,
        dtype: torch.dtype = torch.complex64,
        doppler_via_matmul: bool = True,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        if delay_max < delay_min:
            raise ValueError(f"delay_max ({delay_max}) < delay_min ({delay_min})")
        if doppler_max < doppler_min:
            raise ValueError(
                f"doppler_max ({doppler_max}) < doppler_min ({doppler_min})")
        self.delay_min = int(delay_min)
        self.delay_max = int(delay_max)
        self.doppler_min = float(doppler_min)
        self.doppler_max = float(doppler_max)
        self.fs = int(fs)
        self.n_samples = int(n_samples)
        self.dtype = dtype
        self.real_dtype = real_dtype(dtype)
        self.doppler_via_matmul = doppler_via_matmul

        self.n_delay_bins = self.delay_max - self.delay_min + 1
        self.doppler_middle = (self.doppler_min + self.doppler_max) / 2.0

        # Doppler bin count: symmetric walk at pre-CPI resolution fs/n.
        resolution = 1.0 / (float(self.n_samples) / float(self.fs))
        k = 1
        while self.doppler_middle + k * resolution <= self.doppler_max:
            k += 1
        half_bins = k - 1
        self.n_doppler_bins = 2 * half_bins + 1

        self.n_corr = self.n_samples // self.n_doppler_bins
        self.cpi = float(self.n_corr) * self.n_doppler_bins / self.fs
        self.doppler_resolution = 1.0 / self.cpi

        delay_axis = np.arange(self.delay_min, self.delay_max + 1,
                               dtype=np.int32)
        doppler_axis = self.doppler_middle + self.doppler_resolution * \
            np.arange(-half_bins, half_bins + 1, dtype=np.float64)

        self.nfft = 2 * self.n_corr - 1
        if round_hamming:
            self.nfft = next_hamming(self.nfft)
        if self.n_delay_bins > self.nfft:
            raise ValueError(
                f"delay window [{self.delay_min}, {self.delay_max}] asks for "
                f"{self.n_delay_bins} lags but each of the "
                f"{self.n_doppler_bins} pulses has only n_corr="
                f"{self.n_corr} samples (nfft={self.nfft}): shrink the "
                f"delay range, the Doppler span, or raise fs*cpi")
        # Any length >= 2*n_corr-1 gives the same lag values; self.nfft keeps
        # the reference's Hamming-rounded value for golden-constant parity.
        self.nfft_compute = next_fft_size(self.nfft)

        # Shifted-DFT operator for the Doppler stage:
        # out[j] = FFT(col)[sigma(j)], sigma(j) = (j + nD//2 + 1) mod nD.
        nd = self.n_doppler_bins
        sigma = (np.arange(nd) + nd // 2 + 1) % nd
        p = np.arange(nd, dtype=np.float64)
        w = np.exp(-2j * np.pi * np.outer(sigma, p) / nd)
        # Lag window: corr[j] = z[(delay_min + j) mod nfft]
        # (`Ambiguity.cpp:131-146`).
        lags = (self.delay_min + np.arange(self.n_delay_bins)) \
            % self.nfft_compute

        self.register_buffer("delay_axis", torch.from_numpy(delay_axis).to(device))
        self.register_buffer("doppler_axis",
                             torch.from_numpy(doppler_axis).to(device))
        self.register_buffer("_doppler_dft",
                             torch.from_numpy(w).to(device, dtype))
        self.register_buffer("_sigma", torch.from_numpy(sigma).to(device),
                             persistent=False)
        self.register_buffer("_lags", torch.from_numpy(lags).to(device),
                             persistent=False)

        # Doppler-middle pre-shift ramp (`Ambiguity.cpp:95-102`).
        ramp = None
        if self.doppler_middle != 0.0:
            t = np.arange(self.n_used_samples, dtype=np.float64) / self.fs
            ramp = torch.from_numpy(
                np.exp(2j * np.pi * self.doppler_middle * t)).to(device, dtype)
        self.register_buffer("_ramp", ramp)

    @property
    def n_used_samples(self) -> int:
        return self.n_doppler_bins * self.n_corr

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Complex delay-Doppler map of shape (n_doppler_bins, n_delay_bins)
        from reference ``x`` and surveillance ``y`` (each at least
        n_doppler_bins*n_corr samples); rows are Doppler."""
        nd, nc, nfft = self.n_doppler_bins, self.n_corr, self.nfft_compute
        n_used = nd * nc
        x = x[:n_used].to(self.dtype)
        y = y[:n_used].to(self.dtype)
        if self._ramp is not None:
            x = x * self._ramp

        # Range stage: batched cross-correlation per pulse.
        xf = torch.fft.fft(x.reshape(nd, nc), n=nfft, dim=1)
        yf = torch.fft.fft(y.reshape(nd, nc), n=nfft, dim=1)
        z = torch.fft.ifft(yf * torch.conj(xf), dim=1)
        c = torch.index_select(z, 1, self._lags)

        # Doppler stage: shifted DFT along the pulse axis.
        if self.doppler_via_matmul:
            return torch.matmul(self._doppler_dft, c)
        return torch.fft.fft(c, dim=0)[self._sigma]


def map_metrics(z: torch.Tensor):
    """Map metrics in dB (parity: `src/data/Map.cpp:188-206`).

    Returns (db_map, noise_power, max_power): noise_power is the mean of the
    dB map and max_power = max(0, max(db)) − noise_power (the reference's
    max accumulator starts at 0).
    """
    db = 10.0 * torch.log10(torch.abs(z))
    noise = torch.mean(db)
    raw_max = torch.clamp(torch.max(db), min=0.0)
    return db, noise, raw_max - noise


def map_partials(db: torch.Tensor, inside: Optional[torch.Tensor] = None):
    """The row-parallel half of :func:`map_metrics`: the dB sum (added in
    float64, rounded to db's type) and the max dB over the last two
    dimensions of ``db``, over the rows where ``inside`` (bool,
    broadcastable to db's leading dimensions and rows) holds."""
    total, peak = db, db
    if inside is not None:
        total = torch.where(inside[..., None], db, 0.0)
        peak = torch.where(inside[..., None], db, -torch.inf)
    return (torch.sum(total, dim=(-2, -1), dtype=torch.float64).to(db.dtype),
            torch.amax(peak, dim=(-2, -1)))


def map_finish(total: torch.Tensor, peak: torch.Tensor, n_cells: int):
    """(noise_power, max_power) of :func:`map_metrics` from the dB sum and
    max over a whole map of ``n_cells`` cells. The sum's order differs
    from ``torch.mean``'s, so noise_power may differ in its last bits."""
    noise = total / n_cells
    return noise, torch.clamp(peak, min=0.0) - noise
