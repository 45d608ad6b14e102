"""Find the highest rate an open-loop cell sustains: the cell's traffic at
each of ``--rates`` (Msamples/s a channel), one run each in one process.

    python3 -m benchmark.sweep --workload rspduo.openloop --seed 7 \\
        --seconds 10 --rates 10,15,20,25

One JSON line a rate: the CPIs due and failed, the first CPI a ring dropped
in, the age's median and 95th percentile, its median over the window's
first and last thirds (a backlog that grows shows as a rise), the
generator's lag. A rate is sustained when nothing failed or dropped and
the last third's median is within a CPI's time of the first third's.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time

from benchmark import harness, manifest, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    spec = manifest.cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = copy.deepcopy(spec["traffic"])
        traffic["rate_msps"] = rate
        res = harness.run_cell(args.workload, args.seed, args.seconds, False,
                               time.perf_counter(), traffic=traffic)
        ages = res["ages_ms"]
        third = max(1, len(ages) // 3)
        print(json.dumps({
            "rate_msps": rate, "due": res["attempted"],
            "failed": res["failed"],
            "p50_ms": stats.reported(stats.percentile(ages, 0.5)),
            "p95_ms": stats.reported(stats.percentile(ages, 0.95)),
            "first_third_p50_ms": stats.reported(statistics.median(
                ages[:third])),
            "last_third_p50_ms": stats.reported(statistics.median(
                ages[-third:])),
            "lag_p95_ms": stats.percentile(res["run"].lags_ms, 0.95),
            "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
