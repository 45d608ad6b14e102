"""Device and dtype helpers shared by every stage of the port.

Every entry point takes a ``device``. ``None`` means the card
(``torch.device("cuda")``); with no card present that raises rather than
moving the work to the CPU. The CPU runs only when a caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch

#: complex working dtype -> its real component dtype.
REAL_OF_COMPLEX = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
}


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Raises when a CUDA device is asked for (or implied) and none is
    present: the port never falls back to the CPU on its own.
    """
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "blah2_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev


def current_stream_handle(index: int) -> int:
    """The ``cudaStream_t`` of the current stream on card ``index``, as an
    int: what ``torch.cuda.current_stream(index).cuda_stream`` gives,
    without building the ``Stream`` object (``tools/torch_halo_host.py``
    times both), for kernel wrappers that launch on every call."""
    return torch._C._cuda_getCurrentRawStream(index)


def tree_map(fn, obj):
    """``fn`` over every tensor of a (nested) NamedTuple of tensors and
    Nones, keeping its structure."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, v) for v in obj))
    return fn(obj)


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real component dtype of a complex working dtype."""
    try:
        return REAL_OF_COMPLEX[dtype]
    except KeyError:
        raise ValueError(
            f"working dtype must be complex64 or complex128, got {dtype}"
        ) from None


def as_numpy(a) -> np.ndarray:
    """A constructor argument (NumPy array or tensor) as a host array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def complex_of_parts(re: torch.Tensor, im: torch.Tensor,
                     dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Complex tensor from real and imaginary planes, widened on their own
    device (int16/int32 ADC counts or float planes; counterpart of
    ``CpiPipeline.complex_of_parts`` in the JAX package)."""
    real = real_dtype(dtype)
    return torch.complex(re.to(real), im.to(real))
