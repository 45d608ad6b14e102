"""blah2_tpu_torch — the passive radar's per-CPI pipeline in PyTorch and CUDA.

A port of ``blah2_tpu`` (JAX, TPU) to PyTorch on an NVIDIA Hopper card. The
JAX package stays the reference that every module here is tested against;
this package imports none of it and no JAX. Module and public names follow
the JAX package, so each piece has an obvious counterpart.
"""

from blah2_tpu_torch.device import (complex_of_parts, default_device,
                                    real_dtype, resolve_device)

__all__ = ["complex_of_parts", "default_device", "real_dtype",
           "resolve_device"]
