"""Hermitian Toeplitz build for the Wiener-Hopf normal matrix.

The JAX package builds it gather-free because an index gather was slow on
the TPU (`blah2_tpu/ops/toeplitz.py:1-20`). On the GPU one gather of a
precomputable index matrix is the plain way, with the same values.
"""

from __future__ import annotations

import torch


def hermitian_toeplitz(a: torch.Tensor) -> torch.Tensor:
    """``A[i, j] = conj(a[i−j])`` for i>j else ``a[j−i]`` from the lag
    vector ``a`` of length nb (`WienerHopf.cpp:85-97`); leading dimensions
    of ``a`` batch."""
    nb = a.shape[-1]
    # c[nb−1+d] is the value on diagonal offset d = j − i.
    c = torch.cat([torch.conj(a[..., 1:]).flip(-1), a], dim=-1)
    idx = torch.arange(nb, device=a.device)
    return c[..., (nb - 1) + idx[None, :] - idx[:, None]]
