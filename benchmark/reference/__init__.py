"""The plain reference the benchmark judges the port against: NumPy and
plain PyTorch in float64 (or rounded to bfloat16 for the control), written
from upstream blah2's definitions. It imports nothing of ``blah2_tpu_torch``
or the JAX package and takes nothing the port computed."""
