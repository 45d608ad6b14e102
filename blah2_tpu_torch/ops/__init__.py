"""Tensor ops and hand-written kernels under the DSP stages (counterparts of
``blah2_tpu/ops/``)."""
