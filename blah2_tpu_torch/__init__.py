"""blah2_tpu_torch — the passive radar's per-CPI pipeline in PyTorch and CUDA.

A port of ``blah2_tpu`` (JAX, TPU) to PyTorch on an NVIDIA Hopper card. The
JAX package stays the reference that every module here is tested against;
this package imports none of it and no JAX. Module and public names follow
the JAX package, so each piece has an obvious counterpart.

The device helpers below are loaded on first use, so the host-only modules
(the standalone API, ``net/``) start without importing torch.
"""

_DEVICE_NAMES = ("complex_of_parts", "default_device", "real_dtype",
                 "resolve_device")

__all__ = list(_DEVICE_NAMES)


def __getattr__(name):
    if name in _DEVICE_NAMES:
        from blah2_tpu_torch import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
