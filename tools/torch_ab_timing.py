#!/usr/bin/env python3
"""Two trees of the port timed on the same card in one run, in turns.

    python3 tools/torch_ab_timing.py --parent DIR [--what step|layouts]
                                     [--pairs 12] [--out FILE]

``DIR`` holds another checkout of the repository (the parent commit,
unpacked with ``git archive``); this tree is the change.

  - ``step``: the default config's 1 x 4 sharded step on one card
    (complex64, the halo kernel, the fused detector), in both Doppler
    layouts: row-sharded (``row_shard=True``, what "auto" picks at 1 x 4)
    and replicated (``row_shard=False``). One worker process a tree, each
    started from its tree's root, builds both pipelines and warms them
    up; then ``--pairs`` pairs of turns, parent then change in even pairs
    and change then parent in odd ones, so that a drift of the card or the
    host falls on both trees alike. In a turn the worker times each layout
    (the order alternating with the pair) over 20 steps after 3 by CUDA
    events, as ``chip_smoke.py`` times the step; the other worker idles.
    Reports every turn's medians, and per tree and layout the median of
    the turns' medians and the change's share of pairs faster than the
    parent's;
  - ``layouts``: the tree's ``tools/torch_multiprocess_timing.py``, layouts
    (a), (b) and (c) (four cards), one process a run in the order parent,
    change, change, parent.

Prints one JSON line with the results and the card's name and power
limit, and writes it to ``--out`` where given. Needs a card and exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEPS, WARMUP = 20, 3

# The step worker, run from a tree's root: "ready" once both layouts are
# warm, then for each line "on" or "off" on its input one JSON line of that
# layout's step times.
WORKER = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
from blah2_tpu_torch.config import load_config
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline
dev = torch.device("cuda", 0)
cfg = load_config({config!r})
quads, _ = chip_smoke.default_scene(cfg)
mesh = chip_smoke.one_card_mesh(dev, (1, 4))
steps = {{}}
for name, flag in (("on", True), ("off", False)):
    sp = ShardedCpiPipeline(cfg, mesh, halo_backend="pallas",
                            use_fused_detect=True, row_shard=flag)
    planes = sp.shard_inputs(quads[:, 0] + 1j * quads[:, 1],
                             quads[:, 2] + 1j * quads[:, 3])
    steps[name] = (lambda sp=sp, planes=planes: sp(*planes))
    chip_smoke.event_times(steps[name], 1, {warmup})
print("ready", flush=True)
for line in sys.stdin:
    t = chip_smoke.event_times(steps[line.strip()], {steps}, {warmup})
    print(json.dumps(t), flush=True)
"""


class StepWorker:
    """One tree's step worker: a process of its own, fed turns by line."""

    def __init__(self, root: str):
        code = WORKER.format(root=root, steps=STEPS, warmup=WARMUP,
                             config=os.path.join(root, "config",
                                                 "config.yml"))
        self.root = root
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)
        self._expect("ready")

    def _expect(self, prefix: str) -> str:
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"step worker in {self.root} exited "
                                   f"{self.proc.wait()}")
            if line.startswith(prefix):
                return line

    def time(self, layout: str) -> dict:
        self.proc.stdin.write(layout + "\n")
        self.proc.stdin.flush()
        return json.loads(self._expect("{"))

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def step_pairs(parent: str, pairs: int) -> dict:
    workers = {}
    try:
        workers["parent"] = StepWorker(parent)
        workers["change"] = StepWorker(ROOT)
        turns = []
        for k in range(pairs):
            order = ("parent", "change") if k % 2 == 0 else \
                ("change", "parent")
            layouts = ("on", "off") if k % 2 == 0 else ("off", "on")
            for tree in order:
                for layout in layouts:
                    t = workers[tree].time(layout)
                    turns.append({"pair": k, "tree": tree, "layout": layout,
                                  **t})
    finally:
        for w in workers.values():
            w.close()
    summary = {}
    for layout in ("on", "off"):
        med = {tree: [t["median"] for t in turns
                      if t["tree"] == tree and t["layout"] == layout]
               for tree in ("parent", "change")}
        summary[layout] = {
            "parent_median_ms": statistics.median(med["parent"]),
            "change_median_ms": statistics.median(med["change"]),
            "change_faster_pairs": sum(c < p for p, c in
                                       zip(med["parent"], med["change"])),
            "pairs": pairs}
    on = [t["median"] for t in turns if t["tree"] == "change"
          and t["layout"] == "on"]
    off = [t["median"] for t in turns if t["tree"] == "change"
           and t["layout"] == "off"]
    summary["change_on_faster_than_off_turns"] = sum(
        a < b for a, b in zip(on, off))
    return {"summary": summary, "turns": turns}


def layout_run(root: str) -> dict:
    cmd = [sys.executable,
           os.path.join(root, "tools", "torch_multiprocess_timing.py")]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:2])} in {root} exited "
                           f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError(f"no result line from {root}:\n"
                           f"{proc.stdout[-4000:]}")
    return json.loads(lines[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--what", choices=("step", "layouts"), default="step")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_timing: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    parent = os.path.abspath(args.parent)
    if args.what == "step":
        result = step_pairs(parent, args.pairs)
    else:
        result = {"runs": [{"tree": tree, "result": layout_run(root)}
                           for tree, root in (("parent", parent),
                                              ("change", ROOT),
                                              ("change", ROOT),
                                              ("parent", parent))]}
    line = json.dumps({"what": args.what, "card": chip_smoke.card_line(),
                       **result})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
