"""Signal-processing stages of the per-CPI pipeline (counterparts of
``blah2_tpu/dsp/``)."""
