"""The (cpi, pulse)-sharded CPI pipeline over logical ranks (counterparts of
``blah2_tpu/parallel/``)."""
