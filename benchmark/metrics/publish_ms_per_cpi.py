"""Mean over the window's judged CPIs of the timing product's ``publish``
key, in ms: the time inside the runtime's ``_emit`` for the iqdata, map,
detection and track products (the stash updates of an in-process API, or
the TCP sends to a standalone one); ``output_radar_data`` less the JSON
building. None where the program's timing product has no such key."""

from statistics import fmean


def read(run):
    vals = [doc["publish"] for doc in run.timing if "publish" in doc]
    return fmean(vals) if vals else None
