"""The benchmark of ``blah2_tpu_torch``: the served radar runtime measured
from the client's side, driven by ``BENCHMARK.json``.

Run one cell with ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout on a machine with
a CUDA card. Everything a cell needs is found by name: its configuration in
``configs/<config>.yml``, its traffic in ``traffic/<mix>.json`` (whose
``kind`` names a generator in ``traffic/<kind>.py``), each per-layer metric
in ``metrics/<metric>.py`` and the cell's correctness limits in
``limits/<cell>.json``. Nothing here imports JAX or the JAX package, and
``reference/`` imports nothing of the port either.
"""
