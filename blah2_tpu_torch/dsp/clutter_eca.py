"""Alternative clutter cancellers, ECA-B and frequency-domain block NLMS, and
the clutter filter factory (counterpart of ``blah2_tpu/dsp/clutter_eca.py``).

The reference ships one canceller, the full-CPI Wiener-Hopf filter
(`src/process/clutter/WienerHopf.{h,cpp}`); these two handle clutter that
varies within the CPI (Colone et al., IEEE TAES 45(2), 2009: the ECA/ECA-B
family).

``EcaBFilter`` splits the CPI into B segments and solves the exact
covariance-method least-squares clutter projection per segment, with the
cross-boundary history drawn from the neighbouring segments (``x = 0``
outside the CPI). The Gram matrix comes from batched FFT lag correlations
and two small batched edge-correction matmuls,
``G = Toeplitz(r) + P^H·H − Q^H·T``, so it costs O(n log n); all B solves
are one batched Cholesky and two batched triangular solves. ``cholesky_ex``
reports a failed factor in ``info`` with no host sync, and a segment is good
where ``info == 0`` and its weights are finite (a factor that failed can
still give finite, wrong weights). The JAX module's (B, n_ext) gather-free
build becomes slices and pads here.

``NlmsClutterFilter`` is an overlap-save frequency-domain block NLMS
(multidelay FDAF). JAX runs its per-block recursion as one ``lax.scan``
program; here it is a Python loop of a few fixed-size FFTs and elementwise
ops per block (:func:`nlms_scan`), every input block's FFT taken before the
loop in one batched call, the power estimate updated in place, and no host
sync inside the loop: ten launches a block, about 29,500 a CPI at the
default config, from eager Python (ROADMAP: a CUDA graph of the scan).
Leading dimensions of the inputs batch, so the sharded pipeline runs every
rank's chain on one card as one scan.

The config keys ``process.clutter.filter: {wiener, eca-b, nlms}``,
``nBatches`` and ``mu`` extend the reference schema.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blah2_tpu_torch.device import real_dtype, resolve_device
from blah2_tpu_torch.dsp.clutter import WienerHopfFilter
from blah2_tpu_torch.dsp.hamming import segment_fft_size
from blah2_tpu_torch.ops.toeplitz import toeplitz_ij, toeplitz_kj


def _shift_linear(x: torch.Tensor, s: int) -> torch.Tensor:
    """Zero-filled shift of the last dimension by ``s`` = delay_min (the
    linear counterpart of `WienerHopf.cpp:66`'s circular shift)."""
    if s > 0:
        return F.pad(x[..., :-s], (s, 0))
    if s < 0:
        return F.pad(x[..., -s:], (0, -s))
    return x


def edge_mask(nb: int, device) -> torch.Tensor:
    """The ``[v < j]`` window of the head and tail Gram corrections."""
    idx = torch.arange(nb, device=device)
    return idx[:, None] < idx[None, :]


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A⁻¹·b`` from the lower Cholesky factor ``chol`` of a stack of
    matrices ``A`` (..., n, n), ``b`` (..., n, k): two triangular solves,
    as JAX's ``cho_solve``, in complex128 whatever the inputs' dtype.

    ``torch.cholesky_solve`` on a batch takes MAGMA's batched solve on a
    card, which allocates device memory on every call, and a CUDA graph's
    capture forbids that. cuBLAS's triangular solves capture, but in
    complex64 they left ECA-B's complex64 map further from its complex128
    map than MAGMA's solve had, past ``chip_smoke.py``'s limit for the
    cells away from clutter; widened to complex128 they come under it, for
    more device time than the complex64 solves (PERF.md, Findings)."""
    w = torch.linalg.solve_triangular(
        chol.mH.to(torch.complex128),
        torch.linalg.solve_triangular(chol.to(torch.complex128),
                                      b.to(torch.complex128), upper=False),
        upper=True)
    return w.to(b.dtype)


def ecab_residual(ext: torch.Tensor, seg: torch.Tensor, yb: torch.Tensor,
                  nb: int, nfft: int, diag_load: float, mask: torch.Tensor):
    """ECA-B on a stack of segments: ``ext`` (..., S, L + 2(nb−1)) the
    history- and lookahead-extended shifted reference, ``seg`` (..., S, L)
    its body, ``yb`` (..., S, L) the surveillance segments. Returns the
    residual ``yb − X·w`` and the per-segment success flag; a failed
    segment's weights are zero, so its ``yb`` passes through."""
    L, m = seg.shape[-1], nfft
    # Lag correlations c_s[d] = Σ_w s[w]·conj(ext[w+d]):
    #   r_m  = c_seg[m + nb − 1]   (the Toeplitz baseline)
    #   b[k] = c_y[nb − 1 − k]     (exact X^H y, history included)
    ext_f = torch.fft.fft(ext, n=m, dim=-1)
    c_seg = torch.conj(torch.fft.ifft(
        ext_f * torch.conj(torch.fft.fft(seg, n=m, dim=-1)), dim=-1))
    c_y = torch.conj(torch.fft.ifft(
        ext_f * torch.conj(torch.fft.fft(yb, n=m, dim=-1)), dim=-1))
    r_full = c_seg[..., :2 * nb - 1]
    b = c_y[..., :nb].flip(-1)

    # Exact Gram G = X^H X = Toeplitz(r) + P^H·H − Q^H·T with
    # P[v,k] = ext[nb−1+v−k], Q[v,k] = ext[nb−1+L+v−k] and H, T their
    # [v<j]-masked copies. Q's corner (nb−1, 0) reads one past ext; every
    # pairing of it is masked, so a zero pad serves.
    P = toeplitz_ij(ext[..., :2 * nb - 1])
    Q = toeplitz_ij(F.pad(ext, (0, 1))[..., L:L + 2 * nb - 1])
    zero = torch.zeros((), dtype=ext.dtype, device=ext.device)
    G = toeplitz_kj(r_full)
    G = G + P.mH @ torch.where(mask, P, zero)
    G = G - Q.mH @ torch.where(mask, Q, zero)
    load = (diag_load * r_full[..., nb - 1].real + 1e-30).to(ext.dtype)
    G = G + load[..., None, None] * torch.eye(nb, dtype=ext.dtype,
                                              device=ext.device)

    chol, info = torch.linalg.cholesky_ex(G)
    w = cho_solve(chol, b[..., None])[..., 0]
    ok = (info == 0) & torch.all(torch.isfinite(w), dim=-1)
    w = torch.where(ok[..., None], w, zero)

    # Overlap-save convolution of each segment's weights with its extended
    # reference: valid outputs start at lag nb − 1, so clutter spanning a
    # segment boundary is cancelled too.
    filt = torch.fft.ifft(torch.fft.fft(w, n=m, dim=-1) * ext_f,
                          dim=-1)[..., nb - 1:nb - 1 + L]
    return yb - filt, ok


def nlms_scan(X: torch.Tensor, yk: torch.Tensor, w: torch.Tensor,
              d: torch.Tensor, mu: float, beta: float, eps: float,
              constrain: bool = True):
    """The block NLMS recursion over the K blocks of ``X`` (..., K, 2L), the
    blocks' input spectra, and ``yk`` (..., K, L), from weights ``w`` and
    the update's per-bin denominator ``d`` = power + eps (..., 2L). Returns
    the error blocks (..., K, L) and the final ``(w, d)``; the caller's
    ``d`` is not changed.

    Ten launches a block: every term that does not depend on the
    recursion is taken for all blocks before the loop; the inverse FFTs
    run unscaled, their 1/(2L) folded into a multiply the step has anyway;
    the error blocks are written into one preallocated zero-padded buffer
    that the next FFT reads and that holds the output; ``d`` is updated in
    place."""
    K, L = yk.shape[-2], yk.shape[-1]
    M = 2 * L
    # Block-major, so that each step reads contiguous rows.
    Xy = (X / M).movedim(-2, 0).contiguous()        # ŷ = ifft(w·X)
    cX = (mu * torch.conj(X)).movedim(-2, 0).contiguous()
    # d_k = β·d_{k−1} + (1−β)(|X_k|² + eps): the power recursion, plus eps.
    q = ((1.0 - beta) * (torch.abs(X) ** 2 + eps)).movedim(-2, 0) \
        .contiguous()
    Y = yk.movedim(-2, 0)
    err = X.new_zeros((K,) + X.shape[:-2] + (M,))  # [0 | e] per block
    taps = X.new_zeros(X.shape[:-2] + (M,))        # [w_t | 0]
    d = d.clone()
    for k in range(K):
        yhat = torch.fft.ifft(w * Xy[k], dim=-1, norm="forward")[..., L:]
        torch.sub(Y[k], yhat, out=err[k, ..., L:])
        torch.add(q[k], d, alpha=beta, out=d)
        w = torch.addcdiv(w, cX[k] * torch.fft.fft(err[k], dim=-1), d)
        if constrain:
            # Gradient constraint: keep w an L-tap causal filter.
            torch.mul(torch.fft.ifft(w, dim=-1, norm="forward")[..., :L],
                      1.0 / M, out=taps[..., :L])
            w = torch.fft.fft(taps, dim=-1)
    return err[..., L:].movedim(0, -2), w, d


class EcaBFilter(nn.Module):
    """Extensive Cancellation Algorithm, batches variant (delay-only).

    The Wiener filter's lag window: ``n_bins = delay_max − delay_min`` taps
    on the reference channel shifted by ``delay_min``; one weight vector per
    segment, each the exact covariance-method LS solution for its segment.
    Inputs are (..., n) with leading dimensions batching.
    """

    def __init__(
        self,
        delay_min: int,
        delay_max: int,
        n_samples: int,
        n_batches: int = 8,
        diag_load: float = 1e-4,
        dtype: torch.dtype = torch.complex64,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.delay_min = int(delay_min)
        self.delay_max = int(delay_max)
        self.n_bins = self.delay_max - self.delay_min
        self.n_samples = int(n_samples)
        self.n_batches = int(n_batches)
        if self.n_batches < 1:
            raise ValueError("n_batches must be >= 1")
        self.diag_load = float(diag_load)
        self.dtype = dtype
        # Segment length: the CPI zero-padded to B equal segments.
        self.n_seg = -(-self.n_samples // self.n_batches)
        if self.n_seg <= 2 * self.n_bins:
            raise ValueError(
                f"segment length {self.n_seg} too short for {self.n_bins} "
                f"clutter lags; reduce n_batches")
        nb = self.n_bins
        # Extended segment: nb−1 history + L body + nb−1 lookahead; one FFT
        # size serves the lag correlations and the weight convolution. The
        # port's own size picker (not the JAX v5e table); the map's value
        # does not depend on it.
        self.n_ext = self.n_seg + 2 * (nb - 1)
        self.nfft = segment_fft_size(self.n_ext + nb, device.type)
        self.register_buffer("_edge_mask", edge_mask(nb, device))

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        """Filter one CPI (or a stack). Returns ``(y_filtered, ok)``: ``ok``
        is True where every segment's solve succeeded; a failed segment
        passes its slice of y through unfiltered."""
        n, nb, B, L = self.n_samples, self.n_bins, self.n_batches, self.n_seg
        x = x[..., :n].to(self.dtype)
        y = y[..., :n].to(self.dtype)
        lead = x.shape[:-1]
        pad = B * L - n
        seg = F.pad(_shift_linear(x, self.delay_min),
                    (0, pad)).reshape(lead + (B, L))
        h = nb - 1
        hist = F.pad(seg[..., :-1, L - h:], (0, 0, 1, 0))
        ahead = F.pad(seg[..., 1:, :h], (0, 0, 0, 1))
        ext = torch.cat([hist, seg, ahead], dim=-1)
        yb = F.pad(y, (0, pad)).reshape(lead + (B, L))
        res, ok = ecab_residual(ext, seg, yb, nb, self.nfft, self.diag_load,
                                self._edge_mask)
        return res.reshape(lead + (B * L,))[..., :n], torch.all(ok, dim=-1)


class NlmsClutterFilter(nn.Module):
    """Overlap-save frequency-domain block NLMS clutter canceller.

    ``n_bins`` taps on the reference channel shifted by ``delay_min`` (the
    Wiener filter's window). Weights adapt once per block of L samples (the
    taps rounded up to a power of two; FFT size 2L) with per-bin power
    normalisation, so the canceller tracks clutter whose gain drifts within
    the CPI. ``mu`` sets the adaptation bandwidth (about ``mu·fs/L/2π`` Hz),
    which must stay below the lowest target Doppler of interest, or the
    canceller cancels slow targets inside the clutter delay window.
    """

    def __init__(
        self,
        delay_min: int,
        delay_max: int,
        n_samples: int,
        mu: float = 0.1,
        power_beta: float = 0.9,
        eps: float = 1e-6,
        constrain: bool = True,
        dtype: torch.dtype = torch.complex64,
        device=None,
    ):
        super().__init__()
        resolve_device(device)  # no buffers; raises where there is no card
        self.delay_min = int(delay_min)
        self.n_bins = int(delay_max) - int(delay_min)
        self.n_samples = int(n_samples)
        self.mu = float(mu)
        self.power_beta = float(power_beta)
        self.eps = float(eps)
        self.constrain = bool(constrain)
        self.dtype = dtype
        self.block = 1 << (self.n_bins - 1).bit_length()
        self.nfft = 2 * self.block
        self.n_blocks = -(-self.n_samples // self.block)

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        """Filter one CPI (or a stack). Returns ``(y_filtered, ok)``; ok is
        always True: NLMS has no matrix solve to fail."""
        n, L, K = self.n_samples, self.block, self.n_blocks
        x = x[..., :n].to(self.dtype)
        y = y[..., :n].to(self.dtype)
        lead = x.shape[:-1]
        pad = K * L - n
        # Overlap-save input blocks: block k sees [kL − L, kL + L).
        blocks = F.pad(_shift_linear(x, self.delay_min),
                       (0, pad)).reshape(lead + (K, L))
        prev = F.pad(blocks[..., :-1, :], (0, 0, 1, 0))
        X = torch.fft.fft(torch.cat([prev, blocks], dim=-1), dim=-1)
        yk = F.pad(y, (0, pad)).reshape(lead + (K, L))
        w0 = X.new_zeros(lead + (self.nfft,))
        # The power starts at eps: the denominator at 2·eps.
        d0 = torch.full(lead + (self.nfft,), 2.0 * self.eps,
                        dtype=real_dtype(self.dtype), device=X.device)
        err, _, _ = nlms_scan(X, yk, w0, d0, self.mu, self.power_beta,
                              self.eps, self.constrain)
        return (err.reshape(lead + (K * L,))[..., :n],
                torch.ones(lead, dtype=torch.bool, device=X.device))


def make_clutter_filter(clutter_cfg, n_samples: int,
                        dtype: torch.dtype = torch.complex64,
                        mode: str = "circular", diag_load: float = 0.0,
                        device=None) -> nn.Module:
    """Factory keyed on ``process.clutter.filter``: "wiener" (reference
    algorithm, default), "eca-b", or "nlms"."""
    kind = getattr(clutter_cfg, "filter", "wiener") or "wiener"
    kind = kind.lower().replace("_", "-")
    if kind in ("wiener", "wiener-hopf", "wienerhopf"):
        return WienerHopfFilter(
            clutter_cfg.delay_min, clutter_cfg.delay_max, n_samples,
            diag_load=diag_load, dtype=dtype, mode=mode, device=device)
    if kind in ("eca-b", "ecab", "eca"):
        # The caller's diag_load wins when set; ECA-B otherwise loads by
        # 1e-4, as its per-segment estimates see B× fewer samples.
        return EcaBFilter(
            clutter_cfg.delay_min, clutter_cfg.delay_max, n_samples,
            n_batches=getattr(clutter_cfg, "n_batches", 8),
            diag_load=diag_load if diag_load > 0.0 else 1e-4, dtype=dtype,
            device=device)
    if kind == "nlms":
        return NlmsClutterFilter(
            clutter_cfg.delay_min, clutter_cfg.delay_max, n_samples,
            mu=getattr(clutter_cfg, "mu", 0.1), dtype=dtype, device=device)
    raise ValueError(f"unknown clutter filter {kind!r}")
