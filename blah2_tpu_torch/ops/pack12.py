"""Packed 12-bit IQ wire format (counterpart of ``blah2_tpu/ops/pack12.py``).

The RSPduo digitises at 12 bits, so CPIs travel packed two values per three
bytes: 25 % fewer bytes than int16, lossless for in-range data. The flat
value sequence is paired ``(v[j], v[j + N/2])`` and the three bytes of each
pair are stored in planar segments, all byte0s, then all byte1s, then all
byte2s:

    u0 = v[j] + 2048, u1 = v[j + N/2] + 2048   (unsigned 12-bit)
    B0[j] = u0 >> 4
    B1[j] = ((u0 & 0xF) << 4) | (u1 >> 8)
    B2[j] = u1 & 0xFF
    packed = concat(B0, B1, B2)

Packing runs on the host in NumPy. Unpacking runs on the tensor's device as
uint8 → int32 shifts over three contiguous byte vectors.
"""

from __future__ import annotations

import numpy as np
import torch

OFFSET = 2048
MIN12, MAX12 = -2048, 2047


def pack12(values: np.ndarray) -> np.ndarray:
    """Pack an int16/int32 array (even count, each in [-2048, 2047]) into a
    planar uint8 array of 3 bytes per 2 values. Out-of-range input raises:
    packing must be lossless."""
    v = np.asarray(values).reshape(-1)
    if v.size % 2:
        raise ValueError("pack12 needs an even number of values")
    if v.size and (v.min() < MIN12 or v.max() > MAX12):
        raise ValueError(
            f"pack12 input exceeds 12-bit range [{MIN12}, {MAX12}]: "
            f"[{v.min()}, {v.max()}]")
    u = (v.astype(np.int32) + OFFSET).astype(np.uint32)
    half = v.size // 2
    u0, u1 = u[:half], u[half:]
    out = np.empty(3 * half, dtype=np.uint8)
    out[:half] = u0 >> 4
    out[half:2 * half] = ((u0 & 0xF) << 4) | (u1 >> 8)
    out[2 * half:] = u1 & 0xFF
    return out


def pack12_quads(quads: np.ndarray) -> np.ndarray:
    """Pack an (n, 4) int16 quad buffer [i1,q1,i2,q2] component-major, so
    :func:`unpack12_quads` yields each of xr/xi/yr/yi as a contiguous
    slice."""
    return pack12(np.ascontiguousarray(np.asarray(quads).T))


def pack12_planes(planes: np.ndarray) -> np.ndarray:
    """Pack an (m, 2) int16 real/imag plane block component-major."""
    return pack12(np.ascontiguousarray(np.asarray(planes).T))


def unpack12_np(packed: np.ndarray, n_values: int) -> np.ndarray:
    """NumPy reference unpack (tests, host-side tooling)."""
    if n_values % 2:
        raise ValueError("unpack12_np needs an even n_values")
    half = n_values // 2
    b = np.asarray(packed, dtype=np.uint32)
    b0, b1, b2 = b[:half], b[half:2 * half], b[2 * half:3 * half]
    u0 = (b0 << 4) | (b1 >> 4)
    u1 = ((b1 & 0xF) << 8) | b2
    return np.concatenate([u0, u1]).astype(np.int32) - OFFSET


def unpack12(packed: torch.Tensor, n_values: int) -> torch.Tensor:
    """Unpack on the tensor's device: planar uint8 (3·n/2,) → int32 (n,)."""
    if n_values % 2:
        raise ValueError("unpack12 needs an even n_values")
    if packed.dtype != torch.uint8 or packed.numel() < 3 * (n_values // 2):
        raise ValueError(
            f"unpack12 needs {3 * (n_values // 2)} uint8 bytes, got "
            f"{packed.numel()} of {packed.dtype}")
    half = n_values // 2
    b0 = packed[:half].to(torch.int32)
    b1 = packed[half:2 * half].to(torch.int32)
    b2 = packed[2 * half:3 * half].to(torch.int32)
    u0 = (b0 << 4) | (b1 >> 4)
    u1 = ((b1 & 0xF) << 8) | b2
    return torch.cat([u0, u1]) - OFFSET


def unpack12_quads(packed: torch.Tensor, n_samples: int):
    """Quad unpack → ``(xr, xi, yr, yi)`` int32 vectors of length
    ``n_samples``, all contiguous slices of one unpack."""
    v = unpack12(packed, 4 * n_samples)
    n = n_samples
    return v[:n], v[n:2 * n], v[2 * n:3 * n], v[3 * n:]


def unpack_components(chunk: torch.Tensor):
    """Decode one wire chunk to ``(re, im)`` vectors: packed-12-bit uint8
    chunks unpack; int/float (m, 2) plane chunks split by column."""
    if chunk.dtype == torch.uint8:
        v = unpack12(chunk, (chunk.numel() * 2) // 3)
        m = v.shape[0] // 2
        return v[:m], v[m:]
    return chunk[:, 0], chunk[:, 1]


def unpack_planes(chunk: torch.Tensor) -> torch.Tensor:
    """Decode one wire chunk to ``(m, 2)`` planes, for the staged-sample
    path, which takes planes: packed-12-bit uint8 chunks give int32
    planes, plane chunks pass through. The fused path uses
    :func:`unpack_components` and never interleaves."""
    if chunk.dtype == torch.uint8:
        re, im = unpack_components(chunk)
        return torch.stack([re, im], dim=-1)
    return chunk
