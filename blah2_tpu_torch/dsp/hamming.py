"""5-smooth ("Hamming number") FFT sizes.

``next_hamming`` keeps the reference's semantics
(`src/process/meta/HammingNumber.cpp:38-48`: the first Hamming number
strictly greater than the input; golden values 104→108, 3322→3375,
9965→10000). It fixes the reference geometry, e.g. the ambiguity ``nfft``.

``next_fft_size`` picks the size a transform is computed at. Any length at
or above the minimum gives the same output values (a zero-padded linear
correlation or convolution), so this only has to be a size cuFFT runs
well: cuFFT has dedicated radix-2/3/5 kernels, so the smallest 5-smooth
length at or above the request serves.
"""

from __future__ import annotations


def is_hamming(value: int) -> bool:
    """True if ``value`` has no prime factor other than 2, 3, 5."""
    if value < 1:
        return False
    for p in (2, 3, 5):
        while value % p == 0:
            value //= p
    return value == 1


def next_hamming(value: int) -> int:
    """Smallest 5-smooth number strictly greater than ``value``."""
    if value < 1:
        return 1
    best = None
    p5 = 1
    while p5 <= 5 * (value + 1):
        p35 = p5
        while p35 <= 3 * (value + 1):
            candidate = p35
            while candidate <= value:
                candidate *= 2
            if best is None or candidate < best:
                best = candidate
            p35 *= 3
        p5 *= 5
    return best


def next_fft_size(value: int) -> int:
    """Smallest 5-smooth length >= ``value`` (inclusive, unlike
    :func:`next_hamming`): the cuFFT compute size for a transform that
    needs at least ``value`` points."""
    return next_hamming(value - 1)


#: Segment FFT sizes that a card replaces, measured with
#: ``tools/torch_stage_precision.py`` on an NVIDIA H100 80GB HBM3 at 700 W:
#: at the default config's single-device segments, cuFFT's complex64
#: 16,200-point transforms (2³·3⁴·5²) put the map's clutter-lag cells 1.13 dB
#: from complex128, its 16,384-point ones 0.25 dB, for 1–2 % more clutter
#: filter device time. The sharded paths' picks (18,000 and 23,328) round no
#: worse than their power-of-two-rich rivals (18,432, 24,576) and stay.
CUDA_SEGMENT_SIZE_SWAPS = {16200: 16384}


def segment_fft_size(value: int, device_type: str) -> int:
    """The clutter filter's segment FFT size for a segment that needs at
    least ``value`` points, on a device of type ``device_type``:
    :func:`next_fft_size`, with :data:`CUDA_SEGMENT_SIZE_SWAPS` applied on
    a card (PERF.md, Findings)."""
    size = next_fft_size(value)
    if device_type == "cuda":
        return CUDA_SEGMENT_SIZE_SWAPS.get(size, size)
    return size
