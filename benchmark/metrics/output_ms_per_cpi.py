"""Mean of the timing product's ``output_radar_data`` key over the window's
CPIs: serialising the products and handing them to the API (in process, or
the six TCP sends of a standalone API)."""

from statistics import fmean


def read(run):
    vals = [doc["output_radar_data"] for doc in run.timing
            if "output_radar_data" in doc]
    return fmean(vals) if vals else None
