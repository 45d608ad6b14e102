"""The control of ``correct``: the plain reference put in the program's
place with every stage rounded to bfloat16, the precision below the
port's complex64, read by the same comparisons a run makes.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

For each seed: the cell's scene, each of its CPIs through the reference in
float64 and in bfloat16; the bfloat16 products served as the API serves
them (2 decimals; delays in km); the numbers of ``judge.py`` between the two.
Tracks, over three passes of the scene, a CPI every tCpi: the reference
tracker on each side's detections (``track_mismatch``), and, for the
tracker layer on its own (``track_state_mismatch``), the reference tracker
with every number it stores rounded to bfloat16 against the float64 one,
both fed the bfloat16 side's detections. One JSON line a seed. Run on the
card at the cell's own size; ``--device cpu`` for tests.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmark import harness, judge, manifest, stats
from benchmark import scene as scenes
from benchmark.reference import dsp
from benchmark.reference.tracker import MofN

PASSES = 3


def bf16_float(v: float) -> float:
    import torch

    return torch.tensor(v, dtype=torch.float64).to(torch.bfloat16).item()


def served_tracks(doc: dict) -> str:
    """A ``MofN.document()`` as the API would serve it (2 decimals)."""
    data = [dict(t, delay=round(t["delay"], 2), doppler=round(t["doppler"], 2),
                 acceleration=round(t["acceleration"], 2),
                 associated_delay=[round(v, 2) for v in t["associated_delay"]],
                 associated_doppler=[round(v, 2)
                                     for v in t["associated_doppler"]])
            for t in doc["data"]]
    return json.dumps(dict(doc, data=data))


def served_like(cpi: dsp.Cpi, g: dsp.Geometry):
    """(map document, (k, 3) detections in bins) as the API would serve
    ``cpi``'s products."""
    doc = {"noisePower": round(cpi.noise, 2),
           "maxPower": round(cpi.max_power, 2),
           "data": np.round(cpi.db_rel, 2)}
    d = cpi.detections
    dets = np.stack([np.round(d[:, 0] * g.km_per_bin, 2) / g.km_per_bin,
                     np.round(d[:, 1], 2), np.round(d[:, 2], 2)], axis=1) \
        if len(d) else d
    return doc, dets


def readings(spec: dict, seed: int, device: str, config_file=None,
             traffic=None) -> dict:
    import torch

    traffic = traffic or spec["traffic"]
    doc, _ = harness.deployment(config_file or spec["config_file"])
    g = dsp.geometry(doc)
    sc = scenes.make(traffic["scene"], g, seed, torch.device(device))
    out = {"map_gap_db": 0.0, "detection_gap_db": 0.0, "delay_gap_db": 0.0,
           "doppler_gap_db": 0.0}
    refs, ctls, ctl_raw = [], [], []
    for x, y in zip(sc.x, sc.y):
        ref = dsp.products(x, y, g, device=device)
        raw = dsp.products(x, y, g, q=dsp.bf16, device=device)
        ctl = served_like(raw, g)
        out["map_gap_db"] = max(out["map_gap_db"],
                                judge.map_gap(ctl[0], ref, g))
        for key, v in judge.detection_gaps(ctl[1], ref, g).items():
            out[key] = max(out[key], v)
        refs.append(ref)
        ctls.append(ctl[1])
        ctl_raw.append(raw.detections)
    if g.tracker:
        def tracker(q=lambda v: v):
            return MofN(g.m, g.n_of, g.n_delete, g.cpi, g.max_acc,
                        g.range_res, g.wavelength, q=q)

        sides = [tracker(), tracker()]
        layer = [tracker(), tracker(bf16_float)]
        mism = state = 0
        for k in range(PASSES * len(refs)):
            ts = int(k * g.cpi_cfg * 1000)
            j = k % len(refs)
            sides[0].process([tuple(d) for d in refs[j].detections], ts)
            sides[1].process([tuple(d) for d in ctls[j]], ts)
            served = [(round(d, 2), round(f, 2)) for d, f in sides[1].active()]
            mism += judge.track_mismatch(served, sides[0].active())
            for trk in layer:
                trk.process([tuple(d) for d in ctl_raw[j]], ts)
            state += judge.track_state_mismatch(
                served_tracks(layer[1].document()), layer[0].document())
        out["track_mismatch"] = float(mism)
        out["track_state_mismatch"] = float(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = manifest.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(spec, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **{k: min(v, stats.NEVER_MS)
                             for k, v in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
