"""Mean over the window's judged CPIs of the runtime's host ingest, in ms:
the timing product's ``ring_pop + ingest_cast + ingest_pack +
ingest_copy`` (``runtime/spans.py``: popping the CPI's chunks out of the
two rings, their planes and wire cast with its check, the 12-bit packing,
the pinned copy). None where the program's timing product has no such
keys."""

from statistics import fmean

KEYS = ("ring_pop", "ingest_cast", "ingest_pack", "ingest_copy")


def read(run):
    vals = [sum(doc[k] for k in KEYS) for doc in run.timing
            if all(k in doc for k in KEYS)]
    return fmean(vals) if vals else None
