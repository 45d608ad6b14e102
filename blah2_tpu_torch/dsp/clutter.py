"""Wiener-Hopf FIR clutter canceller (counterpart of
``blah2_tpu/dsp/clutter.py``).

Cancels direct-path/clutter returns from the surveillance channel by solving
the Wiener-Hopf normal equations over clutter lags [delay_min, delay_max] and
subtracting the FIR-filtered reference from the surveillance signal.

Parity with reference `src/process/clutter/WienerHopf.{h,cpp}`:
  - n_bins = delay_max − delay_min (reference quirk: no +1, `WienerHopf.cpp:12`)
  - reference channel shifted by delay_min (`WienerHopf.cpp:66`)
  - autocorrelation a and cross-correlation b (`WienerHopf.cpp:71-108`);
    Toeplitz matrix Hermitian with the lower triangle conjugated
    (`WienerHopf.cpp:85-97`)
  - Cholesky solve (`WienerHopf.cpp:111-122`); a failed factorization skips
    the filter for that CPI (`src/blah2.cpp:268-275`)
  - filter applied by FFT convolution and subtracted (`WienerHopf.cpp:125-160`)

Failure handling without a host sync: ``torch.linalg.cholesky_ex`` reports
a non-positive-definite matrix in ``info`` instead of raising, and
``ok = (info == 0) & all(isfinite(w))`` selects the unfiltered ``y`` on the
device, as the JAX module's NaN check and ``jnp.where`` do.
"""

from __future__ import annotations

import torch
from torch import nn

from blah2_tpu_torch.device import real_dtype, resolve_device
from blah2_tpu_torch.dsp.hamming import next_fft_size, segment_fft_size
from blah2_tpu_torch.ops.corr import _right_halo_segments, choose_segments
from blah2_tpu_torch.ops.toeplitz import hermitian_toeplitz


def solve_normal_equations(a: torch.Tensor, b: torch.Tensor,
                           diag_load: float = 0.0):
    """Wiener-Hopf weights from the lag vectors ``a`` (autocorrelation) and
    ``b`` (cross-correlation), leading dimensions batching, and the success
    flag per solve, both on the device with no host sync: ``cholesky_ex``
    reports a matrix that is not positive definite in ``info``, and w is
    zero where the solve failed."""
    mat = hermitian_toeplitz(a)
    if diag_load > 0.0:
        load = (diag_load * a[..., 0].real).to(a.dtype)[..., None, None]
        mat = mat + load * torch.eye(a.shape[-1], dtype=a.dtype,
                                     device=mat.device)
    chol, info = torch.linalg.cholesky_ex(mat)
    w = torch.cholesky_solve(b[..., None], chol)[..., 0]
    ok = (info == 0) & torch.all(torch.isfinite(w), dim=-1)
    return torch.where(ok[..., None], w, torch.zeros_like(w)), ok


class WienerHopfFilter(nn.Module):
    def __init__(
        self,
        delay_min: int,
        delay_max: int,
        n_samples: int,
        round_hamming: bool = True,
        diag_load: float = 0.0,
        dtype: torch.dtype = torch.complex64,
        mode: str = "circular",
        device=None,
    ):
        """``mode``: "circular" replicates the reference's circular
        correlations exactly; "linear" uses linear (zero-extended)
        correlations and shift. ``round_hamming=False`` keeps the
        reference's exact FFT sizes and the monolithic path."""
        super().__init__()
        if mode not in ("circular", "linear"):
            raise ValueError(f"unknown clutter mode {mode!r}")
        # No buffers; raises where there is no card.
        device_type = resolve_device(device).type
        self.mode = mode
        self.delay_min = int(delay_min)
        self.delay_max = int(delay_max)
        self.n_bins = self.delay_max - self.delay_min
        self.n_samples = int(n_samples)
        self.diag_load = float(diag_load)
        self.dtype = dtype
        self.real_dtype = real_dtype(dtype)
        self.nfft_corr = next_fft_size(self.n_samples + self.n_bins)
        self.nfft_conv = next_fft_size(self.n_samples + self.n_bins - 1) \
            if round_hamming else self.n_bins + self.n_samples + 1

        # Segmented plan: every correlation and the FIR apply decompose into
        # batched segment FFTs (ops/corr.py). 0 (no divisor of n gives
        # segments of >= 1024 samples, or round_hamming is off) keeps the
        # monolithic path.
        min_seg = -(-self.n_samples // 16384)
        self.n_seg = choose_segments(self.n_samples,
                                     min_segments=max(16, min_seg)) \
            if round_hamming else 0
        if self.n_seg and self.n_samples // self.n_seg <= self.n_bins - 1:
            self.n_seg = 0
        if self.n_seg:
            self.nfft_seg = segment_fft_size(
                self.n_samples // self.n_seg + self.n_bins - 1, device_type)

    def _shifted(self, x: torch.Tensor) -> torch.Tensor:
        """Reference channel shifted by delay_min: circularly, or with zero
        fill in linear mode."""
        s = self.delay_min
        if self.mode == "circular":
            return torch.roll(x, s)
        if s > 0:
            return torch.cat([x.new_zeros(s), x[:-s]])
        if s < 0:
            return torch.cat([x[-s:], x.new_zeros(-s)])
        return x

    def _solve(self, a: torch.Tensor, b: torch.Tensor):
        """Weights w of the normal equations and the success flag (both on
        the device; no host sync). w is zero where the solve failed."""
        return solve_normal_equations(a, b, self.diag_load)

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        """Filter one CPI.

        Args:
          x: reference channel, shape (n_samples,).
          y: surveillance channel, shape (n_samples,).
        Returns:
          (y_filtered, ok): filtered surveillance (original y when the solve
          failed) and a bool scalar success flag.
        """
        n, nb = self.n_samples, self.n_bins
        x = x[:n].to(self.dtype)
        y = y[:n].to(self.dtype)
        if self.n_seg:
            return self._forward_segmented(x, y)

        xs = self._shifted(x)
        # Circular mode: size-n transforms give the circular correlations
        # directly. Linear mode: zero-padded transforms.
        m = n if self.mode == "circular" else self.nfft_corr
        xf = torch.fft.fft(xs, n=m)
        yf = torch.fft.fft(y, n=m)
        a = torch.conj(torch.fft.ifft(xf * torch.conj(xf))[:nb])
        b = torch.fft.ifft(yf * torch.conj(xf))[:nb]
        w, ok = self._solve(a, b)

        # FIR apply: y <- y − (w * xs)[:n] by FFT convolution.
        mc = self.nfft_conv
        xcf = xf if m == mc else torch.fft.fft(xs, n=mc)
        filt = torch.fft.ifft(torch.fft.fft(w, n=mc) * xcf)[:n]
        return torch.where(ok, y - filt, y), ok

    def _forward_segmented(self, x: torch.Tensor, y: torch.Tensor):
        """Segmented path: the same correlations, solve and first-n linear
        convolution as the monolithic path, with every full-CPI transform
        replaced by batched segment FFTs, and the reference-channel segment
        spectrum computed once and shared by the autocorrelation, the
        cross-correlation and the FIR apply (overlap-add)."""
        xs = self._shifted(x)
        xf_seg = self._segment_spectra(xs)
        a, b = self._segmented_lags(xs, y, xf_seg)
        w, ok = self._solve(a, b)
        filt = self._segmented_fir(xf_seg, w)
        return torch.where(ok, y - filt, y), ok

    def _segment_spectra(self, xs: torch.Tensor) -> torch.Tensor:
        """Pass 1: plain segment spectra of the shifted reference (shared by
        the autocorrelation, the cross-correlation and the FIR apply)."""
        return torch.fft.fft(xs.reshape(self.n_seg, -1), n=self.nfft_seg,
                             dim=-1)

    def _segmented_lags(self, xs: torch.Tensor, y: torch.Tensor,
                        xf_seg: torch.Tensor):
        """Pass 2: the autocorrelation ``a`` and cross-correlation ``b`` at
        the n_bins lags, from right-halo'd xs and y segments in one batched
        transform summed over segments."""
        circ = self.mode == "circular"
        halo = self.n_bins - 1
        ext = torch.stack([
            _right_halo_segments(xs, self.n_seg, halo, circular=circ),
            _right_halo_segments(y, self.n_seg, halo, circular=circ)])
        ext_f = torch.fft.fft(ext, n=self.nfft_seg, dim=-1)
        acc = torch.sum(ext_f * torch.conj(xf_seg)[None], dim=1)
        lags = torch.fft.ifft(acc, dim=-1)[:, :self.n_bins]
        return torch.conj(lags[0]), lags[1]

    def _segmented_fir(self, xf_seg: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
        """Pass 3: the first n samples of w * xs by overlap-add on the shared
        segment spectra. Each segment's linear convolution with w fits in
        nfft_seg; its n_bins − 1 tail spills into the next segment."""
        seg, halo = self.n_samples // self.n_seg, self.n_bins - 1
        wf = torch.fft.fft(w, n=self.nfft_seg)
        conv = torch.fft.ifft(wf[None] * xf_seg, dim=-1)
        filt = conv[:, :seg].clone()
        filt[1:, :halo] += conv[:-1, seg:seg + halo]
        return filt.reshape(self.n_samples)
