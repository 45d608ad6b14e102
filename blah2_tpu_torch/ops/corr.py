"""Segmented (overlap-save) correlation and FIR ops
(counterpart of ``blah2_tpu/ops/corr.py``).

The clutter filter's full-CPI correlations and FIR convolution decompose
into batched small FFTs over contiguous time segments plus a spectral
accumulation:

  ifft(fft(y)·conj(fft(x)))[k] = Σ_i y[(i+k) mod n]·conj(x[i])

so the lag-window correlation splits into per-segment sums with an
(n_lags−1)-sample right halo, and the causal FIR convolution splits with an
(n_lags−1)-sample left halo (zero before the start: linear convolution).
"""

from __future__ import annotations

import torch

from blah2_tpu_torch.dsp.hamming import next_fft_size


def choose_segments(n: int, min_segments: int = 16,
                    multiple_of: int = 1) -> int:
    """Pick a segment count: a multiple of ``multiple_of`` dividing ``n``,
    at least ``min_segments``, with segments no shorter than 1024 samples.
    Returns 0 if none exists."""
    k = multiple_of
    while k * 1024 <= n:
        if n % k == 0 and k >= min_segments:
            return k
        k += multiple_of
    return 0


def _right_halo_segments(v: torch.Tensor, n_seg: int, halo: int,
                         circular: bool = True) -> torch.Tensor:
    """(…, n) → (…, n_seg, S+halo) with right halo.

    ``circular=True``: the last segment's halo wraps to the start.
    ``circular=False``: the last segment's halo is zero.
    """
    s = v.shape[-1] // n_seg
    segs = v.reshape(v.shape[:-1] + (n_seg, s))
    nxt = torch.roll(segs, -1, dims=-2)[..., :halo]
    if not circular:
        nxt = nxt.clone()
        nxt[..., n_seg - 1, :] = 0
    return torch.cat([segs, nxt], dim=-1)


def _left_halo_segments_linear(v: torch.Tensor, n_seg: int,
                               halo: int) -> torch.Tensor:
    """(…, n) → (…, n_seg, halo+S) with linear (zero-start) left halo."""
    s = v.shape[-1] // n_seg
    segs = v.reshape(v.shape[:-1] + (n_seg, s))
    prev = torch.roll(segs, 1, dims=-2)[..., s - halo:].clone()
    prev[..., 0, :] = 0
    return torch.cat([prev, segs], dim=-1)


def segmented_circular_corr(y: torch.Tensor, x: torch.Tensor, n_lags: int,
                            n_seg: int, circular: bool = True) -> torch.Tensor:
    """corr[k] = Σ_i y[(i+k) mod n]·conj(x[i]) for k < n_lags.

    Equivalent to ``ifft(fft(y)·conj(fft(x)))[:n_lags]`` through ``n_seg``
    batched FFTs. With ``circular=False`` the wrap-around terms are dropped
    (the linear correlation of the zero-extended signals).
    """
    n = x.shape[-1]
    s = n // n_seg
    halo = n_lags - 1
    nfft = next_fft_size(s + halo)
    y_ext = _right_halo_segments(y, n_seg, halo, circular=circular)
    x_seg = x.reshape(x.shape[:-1] + (n_seg, s))
    spec = torch.fft.fft(y_ext, n=nfft, dim=-1) * torch.conj(
        torch.fft.fft(x_seg, n=nfft, dim=-1))
    acc = torch.sum(spec, dim=-2)
    return torch.fft.ifft(acc, dim=-1)[..., :n_lags]


def segmented_fir(w: torch.Tensor, x: torch.Tensor,
                  n_seg: int) -> torch.Tensor:
    """Causal FIR: out[i] = Σ_k w[k]·x[i−k] (zeros before start), length n.

    Overlap-save with a left halo; equal to the first n samples of the
    linear convolution w*x. w has shape (…, n_lags), x has shape (…, n).
    """
    n = x.shape[-1]
    n_lags = w.shape[-1]
    s = n // n_seg
    halo = n_lags - 1
    nfft = next_fft_size(s + halo)
    x_ext = _left_halo_segments_linear(x, n_seg, halo)
    wf = torch.fft.fft(w, n=nfft, dim=-1)
    c = torch.fft.ifft(
        torch.fft.fft(x_ext, n=nfft, dim=-1) * wf[..., None, :], dim=-1)
    out = c[..., halo:halo + s]
    return out.reshape(x.shape[:-1] + (n,))
