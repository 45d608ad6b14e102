"""Reference-channel spectrum monitor (counterpart of
``blah2_tpu/dsp/spectrum.py``).

Parity with reference `src/process/spectrum/SpectrumAnalyser.{h,cpp}`:
decimation = n // bandwidth, n_spectrum = n // decimation, nfft =
n_spectrum · decimation (`SpectrumAnalyser.cpp:16-19`); FFT + fftshift-style
index permutation (k + nfft//2 + 1) mod nfft + stride-decimation
(`SpectrumAnalyser.cpp:41-55`).

The decimated bins are computed by polyphase folding plus one small FFT:
every `decimation`-th bin (offset r) of an nfft-point FFT equals an
n_spectrum-point FFT of the twiddle-folded sequence. The divergences of the
JAX module (centre frequency from config, the intended frequency axis) are
kept.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blah2_tpu_torch.device import resolve_device


class SpectrumAnalyser(nn.Module):
    def __init__(
        self,
        n_samples: int,
        bandwidth: float = 2000.0,
        fc: float = 204_640_000.0,
        dtype: torch.dtype = torch.complex64,
        n_spectrum: "int | None" = None,
        offset_even: "bool | None" = None,
        device=None,
    ):
        """Default geometry is the reference's: decimation = n/bandwidth,
        n_spectrum = n//decimation. ``n_spectrum`` sets the bin count
        instead (sub-CPI analysers pin it to the full-CPI analyser's, so
        every spectrum row shares one frequency axis), with decimation =
        n//n_spectrum; ``offset_even`` then lowers the decimation by one
        where its parity differs, so the half-bin frequency offset, which
        the axis keys on that parity, matches the full-CPI analyser's."""
        super().__init__()
        device = resolve_device(device)
        self.n_samples = int(n_samples)
        self.bandwidth = float(bandwidth)
        self.fc = float(fc)
        self.dtype = dtype

        if n_spectrum is None:
            self.decimation = int(self.n_samples / self.bandwidth)
            self.n_spectrum = self.n_samples // self.decimation
        else:
            self.n_spectrum = int(n_spectrum)
            self.decimation = self.n_samples // self.n_spectrum
            if offset_even is not None and \
                    (self.decimation % 2 == 0) != offset_even:
                self.decimation -= 1
            if self.decimation < 1:
                raise ValueError(
                    f"n_samples={self.n_samples} too short for "
                    f"{self.n_spectrum} spectrum bins")
        self.nfft = self.n_spectrum * self.decimation
        ns, dec, nfft = self.n_spectrum, self.decimation, self.nfft

        # Output bin k of the reference is F[(k*dec + nfft//2 + 1) mod nfft];
        # each selected index is q*dec + r with one uniform offset r.
        sel = (np.arange(ns, dtype=np.int64) * dec + nfft // 2 + 1) % nfft
        r_off = sel % dec
        if not np.all(r_off == r_off[0]):
            raise ValueError("spectrum stride offset must be uniform")
        self._r = int(r_off[0])
        perm = sel // dec
        tw = np.exp(-2j * np.pi * self._r
                    * np.arange(nfft, dtype=np.float64) / nfft)
        self.register_buffer("_perm", torch.from_numpy(perm).to(device))
        self.register_buffer("_twiddle", torch.from_numpy(
            tw.reshape(dec, ns)).to(device, dtype))

        offset = self.bandwidth / 2.0 if dec % 2 == 0 else 0.0
        idx = np.arange(-(ns // 2), ns - ns // 2, dtype=np.float64)
        self.frequency_khz = ((idx * self.bandwidth) + offset + self.fc) / 1000.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Complex decimated spectrum over the last dimension: (n_spectrum,)
        for one sequence, (k, n_spectrum) for a (k, n) batch."""
        x = x[..., : self.nfft].to(self.dtype)
        folded = torch.sum(
            x.reshape(x.shape[:-1] + (self.decimation, self.n_spectrum))
            * self._twiddle, dim=-2)
        return self.finish(folded)

    def twiddle_padded(self, pad_to: int) -> torch.Tensor:
        """Flat fold twiddle zero-extended to ``pad_to`` samples. The zero
        extension doubles as the k < nfft mask: contributions from samples
        at global index ≥ nfft vanish."""
        tw = self._twiddle.reshape(-1)
        out = tw.new_zeros(pad_to)
        out[: tw.shape[0]] = tw
        return out

    def fold_partial(self, x_loc: torch.Tensor, offset: int,
                     tw_pad: torch.Tensor, bucket_origin: int = 0
                     ) -> torch.Tensor:
        """Local contribution to the folded (n_spectrum,) vector from a
        contiguous block (last dimension; leading dimensions batch) at
        global sample ``offset``: the sharded form of the fold in
        ``forward``. Each rank folds its own time block, and the
        (n_spectrum,) partials psum over the pulse axis instead of the
        block being gathered.

        ``bucket_origin``: global sample index of fold bucket 0 (0 for the
        full-CPI spectrum, a segment's start for sub-CPI spectra)."""
        ns = self.n_spectrum
        length = x_loc.shape[-1]
        prod = x_loc.to(self.dtype) * tw_pad[offset: offset + length]
        pad = (-length) % ns
        if pad:
            prod = torch.nn.functional.pad(prod, (0, pad))
        local = torch.sum(prod.reshape(prod.shape[:-1] + (-1, ns)), dim=-2)
        # Bucket j of the fold is (offset − bucket_origin + i) mod ns for
        # local i: rotate the local sums to bucket alignment.
        return torch.roll(local, (offset - bucket_origin) % ns, dims=-1)

    def finish(self, folded: torch.Tensor) -> torch.Tensor:
        """Small n_spectrum-point FFT + reference bin permutation (over the
        last dimension)."""
        return torch.fft.fft(folded, dim=-1)[..., self._perm]

    @staticmethod
    def to_db(spectrum: torch.Tensor) -> torch.Tensor:
        return 10.0 * torch.log10(torch.abs(spectrum))
