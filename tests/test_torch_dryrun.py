"""The port's dry runs (``blah2_tpu_torch/entry.py``) on the
CPU, against ``__graft_entry__.py``'s.

``dryrun_multichip(4, devices=["cpu"] * 4)`` runs every cell of JAX's
matrix; each cell's collective traffic is held against JAX's
``commstats.summarize(commstats.collect(...))`` of the same cell on 4
virtual CPU devices. Where the collectives map one to one, the bytes per
rank are equal; where XLA fuses, elides or adds a collective, the mapping
is stated in :func:`_expected_members` and checked as stated:

  - ``permute`` ↔ ``collective-permute`` and ``psum_scatter`` ↔
    ``reduce-scatter``: one to one, equal bytes, in every cell. The
    ``pallas`` cell is held against JAX's ``ppermute`` form of the cell:
    JAX's Pallas halo is a custom call that commstats does not see, and
    the port's halo kernel records the same payloads as permutes.
  - ``psum`` and ``pmax`` ↔ ``all-reduce``: XLA fuses several psums into one
    all-reduce of a tuple; each tuple member is one of the port's calls.
    The clutter spectrum's psums carry nfft_seg complex64 a CPI with each
    package's own segment FFT size (JAX: the TPU v5e table; the port: the
    5-smooth size), compared as 2 · nfft_seg members of 8 bytes.
  - ``all_gather`` ↔ ``all-gather`` of the row-sharded detection's float32
    dB rows and its mask (``pred``): one to one.
  - Over a pulse axis of one rank (the N × 1 mesh) XLA drops the
    collectives GSPMD inserts for the row-sharded detection (the dB sum and
    maximum, the row gathers) while it keeps the explicit ``lax.psum``
    calls; the port records every call of the step, so those are left out
    of the port's side there.
  - XLA's all-gathers of int32 and complex64 arrays whose first dimension
    is the batch (the detections and the spectra) are GSPMD's gathers of
    the cpi-sharded products to a replicated layout; the port's products of
    one process need no collective, so they have no counterpart.

``dryrun_multihost(2, 2)`` runs two gloo processes on the CPU under a
deadline and holds process 0's maps against one process's.

The scaling projection (``bench/projection.py``): its designed bytes are
``tools/scaling_projection.py``'s closed forms for the same shapes, and
its model's arithmetic.
"""

from __future__ import annotations

import os
import re
import sys
import threading
from collections import Counter

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from blah2_tpu.parallel import commstats  # noqa: E402
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh  # noqa: E402
from blah2_tpu.parallel.sharded import ShardedCpiPipeline as JaxSharded  # noqa: E402,E501
from blah2_tpu_torch import entry  # noqa: E402
from blah2_tpu_torch.bench import projection  # noqa: E402
from blah2_tpu_torch.parallel.mesh import make_radar_mesh  # noqa: E402
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline  # noqa: E402

torch.set_num_threads(2)

N = 4
CELLS = entry.dryrun_cells(N)
CPU = ["--device", "cpu", "--fs", "200000", "--cpi", "0.1"]
#: Longest a projection run here may take before the test fails.
DEADLINE_S = 120.0


def _bounded(fn, *args):
    """``fn(*args)`` on a thread, failing the test past DEADLINE_S."""
    box = {}

    def target():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised on the test's thread
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(DEADLINE_S)
    assert not t.is_alive(), f"{fn} ran past {DEADLINE_S} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _cell_id(cell):
    (c, p), filt, rows, halo, fused, extra = cell
    tag = "".join(f"-{k}{v}" for k, v in extra.items())
    return f"{c}x{p}-{filt}-rows{rows}-{halo}{tag}"


@pytest.fixture(scope="module")
def port_cells():
    return entry.dryrun_multichip(N, devices=["cpu"] * N)


def test_dryrun_runs_every_cell(port_cells, capsys):
    assert len(port_cells) == len(CELLS) == 11
    for got, cell in zip(port_cells, CELLS):
        (c, p), filt, rows, halo, fused, extra = cell
        assert (got["mesh"], got["filter"], got["halo"], got["fused"],
                got["extra"]) == (f"{c}x{p}", filt, halo, fused, extra)
        assert got["launches"] == {"halo": 0, "detect": 0}  # plain on CPU
        assert got["detections"] >= 1
    # Row-shard off is off; "auto" is row-sharded at this geometry, as
    # JAX's rule decides.
    assert [g["row_shard"] for g in port_cells] == \
        [r is not False for _, _, r, _, _, _ in CELLS]


def test_halo_cell_map_is_its_twins_bits(port_cells):
    """The ``pallas`` cell's map is, bit for bit, that of the cell that
    differs only in its halo backend (the check the dry run makes)."""
    pallas = [g for g in port_cells if g["halo"] == "pallas"]
    assert len(pallas) == 1
    twin = [g for g in port_cells if g["halo"] == "ppermute" and all(
        g[k] == pallas[0][k]
        for k in ("mesh", "filter", "row_shard", "fused", "extra"))]
    assert len(twin) == 1
    assert torch.equal(pallas[0]["db_map"], twin[0]["db_map"])


def test_a_wrong_halo_fails_the_dry_run(monkeypatch):
    """A halo backend whose payloads are wrong (here halved) makes the
    ``pallas`` cell's map differ from its twin's, and the dry run
    raises."""
    from blah2_tpu_torch.parallel import halo

    orig = halo.halo_permute

    def wrong(*args, **kwargs):
        return [o * 0.5 for o in orig(*args, **kwargs)]

    monkeypatch.setattr(halo, "halo_permute", wrong)
    with pytest.raises(RuntimeError, match="the halo kernel's map differs"):
        entry.dryrun_multichip(N, devices=["cpu"] * N)


def test_dryrun_cell_line_prints_its_bytes(capsys):
    cells = entry.dryrun_multichip(2, devices=["cpu"] * 2)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("  cell ")]
    assert len(lines) == len(cells) == len(entry.dryrun_cells(2))
    for ln, cell in zip(lines, cells):
        shown = dict(re.findall(r"(\w+):(\d+)x/\d+B", ln))
        assert {k: int(v) for k, v in shown.items()} == \
            {k: v["count"] for k, v in cell["comm"].items()}
        assert ln.endswith("OK")
    assert f"dryrun_multichip(2): {len(cells)} cells" in out


def _jax_config(filt, extra):
    from __graft_entry__ import _default_config

    cfg = _default_config(fs=40_000, cpi=0.1)
    cfg.process.ambiguity.delay_min = -5
    cfg.process.ambiguity.delay_max = 40
    cfg.process.clutter.delay_min = -5
    cfg.process.clutter.delay_max = 20
    cfg.process.clutter.filter = filt
    cfg.process.spectrum.n_sub = extra.get("n_sub", 1)
    cfg.process.spectrum.bandwidth = extra.get("bandwidth", 2000.0)
    cfg.process.detection.cfar = extra.get("cfar", "ca")
    return cfg


def _expected_members(jops, n_cpi, n_pulse, nfft_jax, nfft_port):
    """JAX's collectives of one cell as the port's (kind, bytes) members,
    by the mapping of the module docstring."""
    members = []
    for op in jops:
        if op.kind == "collective-permute":
            members.append(("permute", op.bytes_per_rank))
        elif op.kind == "reduce-scatter":
            members.append(("psum_scatter", op.bytes_per_rank))
        elif op.kind == "all-reduce":
            for t in op.shapes:
                dims = [int(d) for d in re.findall(r"\d+", t.split("[")[1])]
                nbytes = commstats._shape_bytes(t)
                if t.startswith("c64[") and dims[-1] == nfft_jax:
                    nbytes = nbytes // nfft_jax * nfft_port
                members.append(("reduce", nbytes))
        elif op.kind == "all-gather":
            t = op.shapes[0]
            if t.startswith(("f32[", "pred[")):
                members.append(("all_gather", op.bytes_per_rank))
            else:
                # GSPMD's gather of a cpi-sharded product: batch first.
                assert t.startswith(("s32[", "c64[")), t
                assert int(t.split("[")[1].split(",")[0]) == n_cpi, t
        else:
            raise AssertionError(f"unmapped collective {op.kind}")
    return Counter(members)


def _port_members(cell, n_pulse):
    members = []
    for kind, dtype, nbytes in cell["ops"]:
        if n_pulse == 1 and (kind in ("pmax", "all_gather") or (
                kind == "psum" and dtype == "torch.float32")):
            continue  # the detection's GSPMD collectives XLA elides
        members.append(("reduce" if kind in ("psum", "pmax") else kind,
                        nbytes))
    return Counter(members)


@pytest.mark.parametrize("index", range(len(CELLS)),
                         ids=[_cell_id(c) for c in CELLS])
def test_dryrun_bytes_match_jax_commstats(port_cells, index):
    (c, p), filt, rows, halo, fused, extra = CELLS[index]
    got = port_cells[index]
    jcfg = _jax_config(filt, extra)
    ref = JaxSharded(jcfg, jax_mesh(c, p, devices=jax.devices()[:N]),
                     row_shard=rows, halo_backend="ppermute")
    assert ref._row_shard == got["row_shard"]
    xb, yb = entry.cell_batch(entry.cell_config(filt, extra), c)
    jops = commstats.collect(ref._fn, *ref.shard_inputs(xb, yb))
    summary = commstats.summarize(jops)
    port = ShardedCpiPipeline(entry.cell_config(filt, extra),
                              make_radar_mesh(c, p, devices=["cpu"] * N),
                              row_shard=rows)
    # One to one: per-kind bytes per rank equal commstats' summary.
    for pk, jk in (("permute", "collective-permute"),
                   ("psum_scatter", "reduce-scatter")):
        assert got["comm"].get(pk, {"count": 0, "bytes_per_rank": 0}) == {
            "count": summary.get(jk, {}).get("count", 0),
            "bytes_per_rank": summary.get(jk, {}).get("bytes_per_rank", 0)}
    # The rest by the stated mapping, member for member.
    assert _port_members(got, p) == _expected_members(
        jops, c, p, ref.nfft_seg, port.nfft_seg)


def test_dryrun_multihost_two_processes():
    diffs = entry.dryrun_multihost(2, 2, device="cpu", seconds=240)
    assert diffs == {"2x2": 0.0, "1x4": 0.0}


def test_dryrun_multihost_kills_workers_past_the_deadline():
    """Past the deadline every worker is killed and the error carries what
    each printed."""
    with pytest.raises(RuntimeError, match="ran past") as e:
        entry.dryrun_multihost(2, 2, device="cpu", seconds=0.5)
    assert "-- process 0:" in str(e.value) and "-- process 1:" in str(e.value)


def test_multihost_scene_is_the_jax_workers():
    """The scene of tests/multihost_worker.py:52-74 and its meshes."""
    from blah2_tpu.capture.synthetic import TargetSpec, synthetic_cpi

    cfg = entry.dryrun_config()
    xb, yb = entry.cell_batch(cfg, 2, first_seed=100)
    for k in range(2):
        x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                             [TargetSpec(10, -33.0, 0.1)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=100 + k)
        np.testing.assert_array_equal(xb[k], x)
        np.testing.assert_array_equal(yb[k], y)
    assert entry.multihost_meshes(8) == [(2, 4), (1, 8)]


# -- the scaling projection ---------------------------------------------------

@pytest.fixture(scope="module")
def projected():
    return _bounded(projection.main, CPU)


def test_projection_bytes_are_the_closed_forms(projected):
    """Each cell's designed bytes are ``comm_model``'s terms
    (tools/scaling_projection.py:92-125) for the same shapes: the halo
    permutes, the Doppler psum_scatter and the spectrum fold as they are;
    the clutter psum as its closed form 2 · nfft_seg · 8 with each
    package's own segment FFT size (JAX: the TPU v5e table; the port: the
    5-smooth size)."""
    import jax

    from blah2_tpu.config import config_from_dict
    from blah2_tpu.dsp.pipeline import CpiPipeline as JaxPipeline
    from blah2_tpu_torch.bench.common import default_config
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh
    from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline
    from tools.scaling_projection import comm_model

    jax.config.update("jax_platforms", "cpu")
    port_cfg = default_config(200_000, 0.1)
    jcfg = config_from_dict(_raw(port_cfg))
    jpipe = JaxPipeline(jcfg)
    rows = {r["mesh"].split()[0]: r for r in projected["cells"]}
    assert len(rows) == len(projection.CELLS) + len(projection.DCN_CELLS)
    for key, row in rows.items():
        c, p = (int(v) for v in key.split("x"))
        want = comm_model(jcfg, jpipe, c, p)
        if p == 1:
            assert want["bytes_per_rank"] == 0
            assert row["comm_bytes_per_rank"] == 0
            assert row["designed_collective_bytes"] == 0
            continue
        got = dict(row["designed_detail"])
        jd = dict(want["detail"])
        port_nfft = ShardedCpiPipeline(port_cfg, make_radar_mesh(
            1, p, devices=["cpu"] * p)).nfft_seg
        assert got.pop("clutter_psum") == 2 * port_nfft * 8
        assert jd.pop("clutter_psum") % 16 == 0
        assert got == jd, key
        # Every rank holds one CPI (B = C): the pulse axis sets the bytes.
        assert row["comm_bytes_per_rank"] == rows[f"1x{p}"][
            "comm_bytes_per_rank"]


def _raw(cfg):
    """A config as the blah2 YAML schema's dict (its windows only)."""
    p = cfg.process
    return {"capture": {"fs": cfg.capture.fs, "fc": cfg.capture.fc},
            "process": {
                "data": {"cpi": p.data.cpi, "buffer": 2},
                "ambiguity": {"delayMin": p.ambiguity.delay_min,
                              "delayMax": p.ambiguity.delay_max,
                              "dopplerMin": p.ambiguity.doppler_min,
                              "dopplerMax": p.ambiguity.doppler_max},
                "clutter": {"enable": True,
                            "delayMin": p.clutter.delay_min,
                            "delayMax": p.clutter.delay_max},
                "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                              "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                              "nCentroid": 6}}}


def test_projection_unmeasured_times_are_null(projected):
    assert projected["calibration"]["mode"].startswith("not measured")
    assert all(r["t_step_ms"] is None and r["efficiency"] is None
               for r in projected["cells"])
    assert projected["cross_check"]["ratio_to_measured_range"] is None
    assert projected["device"] == "cpu" and projected["card"] is None


def test_projection_model_arithmetic():
    """t_step = t_rank(P) + bytes/NVLink + n·latency + t_fix and
    eff = t1 / (P · t_step); a cpi axis across hosts adds the products
    over the host link, a pulse axis across hosts takes it for every
    collective."""
    comm = {"bytes_per_rank": 4.5e5, "n_collectives": 10,
            "designed_bytes": 4e5, "designed_detail": {}}
    t_rank = {1: 4.0, 4: 1.5}
    row = projection.cell_row(2, 4, comm, 1000, t_rank, 0.05, 12_000)
    t_comm = 4.5e5 / projection.NVLINK_BW + 10 * projection.NVLINK_LAT
    t_step = 1.5e-3 + t_comm + 0.05e-3
    assert row["t_comm_us"] == pytest.approx(1e6 * t_comm)
    assert row["t_step_ms"] == pytest.approx(1e3 * t_step)
    assert row["efficiency"] == pytest.approx(4e-3 / (4 * t_step))
    assert row["throughput_msps"] == pytest.approx(2 * 1000 / t_step / 1e6)
    cpi = projection.cell_row(2, 4, comm, 1000, t_rank, 0.05, 12_000, "cpi")
    assert cpi["t_comm_us"] == pytest.approx(1e6 * (
        t_comm + 12_000 / projection.DCN_BW + projection.DCN_LAT))
    pulse = projection.cell_row(1, 4, comm, 1000, t_rank, 0.05, 0, "pulse")
    assert pulse["t_comm_us"] == pytest.approx(1e6 * (
        4.5e5 / projection.DCN_BW + 10 * projection.DCN_LAT))


def test_projection_measures_rank_and_fix_on_the_device():
    """``--measure``'s two timers on the CPU, host clock (the numbers are
    not device metrics): a positive ms per P and per launch."""
    dev = torch.device("cpu")
    m = projection.measure_rank(200_000, 0.1, [1, 2], dev, 1)
    assert m["timer"] == "host clock"
    assert set(m["per_rank_ms"]) == {1, 2}
    assert all(v > 0 for v in m["per_rank_ms"].values())
    assert m["per_rank_geometry"][2]["n"] == 10_000
    assert all(len(r) == projection.ROUNDS
               for r in m["per_rank_rounds_ms"].values())
    assert projection.measure_fix(dev, reps=5) > 0
