#!/usr/bin/env python3
"""The single-device CPI eager against its CUDA graph on one card.

    python3 tools/torch_graph_timing.py [--cpis 20] [--warmup 3]
                                        [--configs default,eca-b,nlms,os,nsub4]
                                        [--out FILE]

For each config (``chip_smoke.py`` ``GRAPH_CASES``: the default config,
ECA-B, NLMS, OS-CFAR, nSub 4) it runs ``chip_smoke.graph_case``: the
graph's capture (warm-up, capture and instantiate ms, nodes), its products
bit for bit against the eager call's on three CPIs, the detect kernel's
launches and ticket counters per replay, ms per CPI by CUDA events on each
path (``--cpis`` after ``--warmup``, eager NLMS too), the device's busy ms
and idle share from the profiler, and each path's peak memory. The smoke
runs the same at cut counts. Prints one JSON line a config and the card's
name and power limit, and writes the lines to ``--out`` where given. Needs
a card and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpis", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--configs", default="default,eca-b,nlms,os,nsub4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_graph_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from blah2_tpu_torch.ops import _build

    for name in ("detect", "halo"):
        _build.build(name)
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    timed = {k: (args.cpis, args.warmup)
             for k in ("graph", "eager", "graph_nlms", "eager_nlms")}
    lines = []
    for name in args.configs.split(","):
        alternative = chip_smoke.GRAPH_CASES[name]
        cfg = chip_smoke.alternative_config(ROOT, alternative or ("data", {}))
        line = chip_smoke.graph_case(dev, cfg, name, timed=timed)
        line.update(card=card, torch=torch.__version__)
        print(json.dumps(line), flush=True)
        lines.append(line)
    print(json.dumps({"profiler_windows": chip_smoke.PROFILE_LOG}))
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
