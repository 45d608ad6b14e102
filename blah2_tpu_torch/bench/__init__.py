"""The port's measuring entry points: counterparts of the JAX package's
root scripts ``bench.py`` (:mod:`.pipeline`), ``bench_runtime.py``
(:mod:`.runtime`), ``tools/soak_runtime.py`` (:mod:`.soak`),
``bench_scaling.py`` (:mod:`.scaling`), ``bench_compare.py``
(:mod:`.compare`), ``tools/soak_supervised.py`` (:mod:`.soak_supervised`)
and ``tools/scaling_projection.py`` (:mod:`.projection`). Each runs as ``python -m blah2_tpu_torch.bench.<name>``
on the card, or on the host with ``--device cpu``, and prints its JSON
line(s) with the JAX script's ``metric`` names and top-level keys."""
