"""Toeplitz builds for the clutter cancellers' normal matrices
(counterpart of ``blah2_tpu/ops/toeplitz.py``).

The JAX package builds them gather-free because an index gather was slow on
the TPU (`blah2_tpu/ops/toeplitz.py:1-20`). On the GPU one gather of a
precomputable index matrix is the plain way, with the same values. Leading
dimensions of the generator batch.
"""

from __future__ import annotations

import torch


def _gather(c: torch.Tensor, sign: int) -> torch.Tensor:
    """``T[..., i, j] = c[..., nb−1 + sign·(j − i)]`` from center-indexed
    ``c`` of length ``2·nb − 1``."""
    nb = (c.shape[-1] + 1) // 2
    idx = torch.arange(nb, device=c.device)
    return c[..., (nb - 1) + sign * (idx[None, :] - idx[:, None])]


def toeplitz_kj(c: torch.Tensor) -> torch.Tensor:
    """``T[..., j, k] = c[..., nb−1 + k − j]`` from center-indexed ``c`` of
    length ``2·nb − 1``."""
    return _gather(c, 1)


def toeplitz_ij(c: torch.Tensor) -> torch.Tensor:
    """``T[..., i, j] = c[..., nb−1 + i − j]`` (the transpose of
    :func:`toeplitz_kj`)."""
    return _gather(c, -1)


def hermitian_toeplitz(a: torch.Tensor) -> torch.Tensor:
    """``A[i, j] = conj(a[i−j])`` for i>j else ``a[j−i]`` from the lag
    vector ``a`` of length nb (`WienerHopf.cpp:85-97`); leading dimensions
    of ``a`` batch."""
    # c[nb−1+d] is the value on diagonal offset d = j − i.
    return toeplitz_kj(torch.cat([torch.conj(a[..., 1:]).flip(-1), a],
                                 dim=-1))
