"""Row-parallel detection on the row-sharded path
(``blah2_tpu_torch/parallel/sharded.py``): each pulse rank detects its own
Doppler rows, the detect kernel's row-block mode (its plain twin here), the
row halos of ``parallel/halo.py`` and the new collectives.

  - the row-sharded step against JAX's ``ShardedCpiPipeline(row_shard=
    True)`` on the virtual CPU mesh;
  - the row-sharded step against the gathered form: the rows of the map
    gathered and put through the unchanged single-device detectors
    (``make_cfar`` + ``CentroidFilter`` + ``PeakInterpolator``, or
    ``FusedDetector``): the dB map, the masks and the detections' indices,
    ``valid`` and ``count`` bit for bit; noise, max_power and snr within
    1e-4 dB and the interpolated delay and doppler within 1e-4 bins and
    Hz (the dB sum is added in another order, and interpolation runs on
    db − noise);
  - the scenes the split must not change: a target whose centroid window
    and interpolation straddle a row-block edge, two hits of one centroid
    window on the two sides of an edge, more hits than ``max_detections``,
    and the last rank's phantom rows;
  - ``detect_rows_plain`` against ``detect_plain`` on blocks cut from one
    map, and ``rows_from_next``/``rows_from_prev`` on both backends against
    slicing.

The port runs its logical ranks on ``cpu``."""

from __future__ import annotations

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.config import config_from_dict as jax_config
from blah2_tpu.parallel.mesh import make_radar_mesh as jax_mesh
from blah2_tpu.parallel.sharded import ShardedCpiPipeline as JaxSharded
from blah2_tpu_torch.capture.synthetic import TargetSpec, synthetic_cpi
from blah2_tpu_torch.config import config_from_dict
from blah2_tpu_torch.dsp.centroid import CentroidFilter
from blah2_tpu_torch.dsp.cfar import CfarDetections, make_cfar
from blah2_tpu_torch.dsp.interpolate import PeakInterpolator
from blah2_tpu_torch.ops import detect as tdetect
from blah2_tpu_torch.ops.detect import (FusedDetector, detect_plain,
                                        detect_rows_plain)
from blah2_tpu_torch.parallel import collectives as coll
from blah2_tpu_torch.parallel import sharded as tsharded
from blah2_tpu_torch.parallel.halo import rows_from_next, rows_from_prev
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import ShardedCpiPipeline

torch.set_num_threads(1)

# The config of tests/test_sharded.py:15-27: a 41 x 66 map.
SCENE = {
    "capture": {"fs": 80_000, "fc": 204_640_000},
    "process": {
        "data": {"cpi": 0.2, "buffer": 2},
        "ambiguity": {"delayMin": -5, "delayMax": 60,
                      "dopplerMin": -100, "dopplerMax": 100},
        "clutter": {"enable": True, "delayMin": -5, "delayMax": 30},
        "detection": {"enable": True, "pfa": 1e-5, "nGuard": 2,
                      "nTrain": 6, "minDelay": 5, "minDoppler": 15,
                      "nCentroid": 6},
    },
}
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "2x4": (2, 4)}
DETECTORS = ("ca", "os", "fused")
DTYPES = {"c64": (torch.complex64, jnp.complex64),
          "c128": (torch.complex128, jnp.complex128)}


def _config(detector, min_doppler=15):
    d = copy.deepcopy(SCENE)
    d["process"]["detection"]["minDoppler"] = min_doppler
    if detector == "os":
        d["process"]["detection"]["cfar"] = "os"
    return d


def _mesh(shape):
    return make_radar_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _pipe(shape, detector, dtype=torch.complex64, min_doppler=15, **kw):
    return ShardedCpiPipeline(config_from_dict(_config(detector,
                                                       min_doppler)),
                              _mesh(shape), dtype=dtype, row_shard=True,
                              use_fused_detect=detector == "fused", **kw)


def _batch(b, seed=0):
    cfg = config_from_dict(SCENE)
    xs, ys = [], []
    for k in range(b):
        # Doppler -44 Hz lies on map row 11.2: the first rank's block edge
        # at 1 x 4 and 2 x 4 (11 rows a rank).
        x, y = synthetic_cpi(cfg.n_samples, cfg.capture.fs,
                             [TargetSpec(20, -44.0, 0.1),
                              TargetSpec(35, 32.0, 0.05)],
                             clutter_amplitude=2.0, noise_amplitude=1e-3,
                             seed=seed + k)
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)


def _spy(monkeypatch, sp):
    """Record the step's row-sharded map and what its all-gathers return."""
    seen = {}
    detect_rows = sp._detect_rows

    def rows(zs):
        seen["zs"] = zs
        return detect_rows(zs)

    def gather(fields, mesh, axis="pulse", dim=1):
        seen["gathered"] = coll.all_gather(fields, mesh, axis, dim)
        return seen["gathered"]

    monkeypatch.setattr(sp, "_detect_rows", rows)
    monkeypatch.setattr(tsharded, "all_gather", gather)
    return seen


def _joined(sp, per_rank, nd):
    """The cpi rows' blocks joined in rank order, cut to the map's rows."""
    return torch.cat([torch.cat([per_rank[r] for r in g], dim=1)[:, :nd]
                      for g in sp.mesh.groups("pulse")])


def _gathered_form(sp, z):
    """The unchanged single-device detectors on the gathered (B, nd, nc)
    map: (db, noise, max_power, detections, mask)."""
    proc, amb = sp.config.process, sp.ambiguity
    k = sp.cfar.max_detections
    interp = PeakInterpolator(True, True, amb.doppler_resolution,
                              amb.n_doppler_bins, amb.n_delay_bins)
    if sp.fused_detector is not None:
        fd = FusedDetector.from_config(proc, amb, max_detections=k,
                                       device="cpu")
        db, noise, max_power, det = fd(z)
        mask = detect_plain(fd.kernel_input(z).contiguous(), fd._scale,
                            fd._cell_ok, fd.n_guard, fd.n_train,
                            fd.win_rows, fd.win_cols).keep > 0.0
        dets = [interp(CfarDetections(*[f[i] for f in det]),
                       db[i] - noise[i]) for i in range(z.shape[0])]
    else:
        cfar = make_cfar(proc.detection, amb.delay_axis, amb.doppler_axis,
                         max_detections=k, device="cpu")
        centroid = CentroidFilter(proc.detection.n_centroid,
                                  proc.detection.n_centroid,
                                  1.0 / proc.data.cpi)
        db = 10.0 * torch.log10(torch.abs(z))
        noise = torch.mean(db, dim=(-2, -1))
        max_power = torch.clamp(torch.amax(db, dim=(-2, -1)),
                                min=0.0) - noise
        mags = torch.abs(z).to(cfar.real_dtype)
        mask = torch.stack([cfar.hits(m * m) for m in mags])
        dets = [interp(centroid(cfar(z[i], noise[i])), db[i] - noise[i])
                for i in range(z.shape[0])]
    det = CfarDetections(*[torch.stack(f) for f in zip(*dets)])
    return db, noise, max_power, det, mask


def _assert_gathered(sp, out, seen):
    nd = sp.ambiguity.n_doppler_bins
    z = _joined(sp, seen["zs"], nd)
    db, noise, max_power, det, mask = _gathered_form(sp, z)
    assert torch.equal(out.db_map, db)
    gathered = seen["gathered"]
    got_mask = torch.cat([gathered[g[0]][1][:, :nd]
                          for g in sp.mesh.groups("pulse")])
    assert torch.equal(got_mask, mask)
    for k in ("row", "col", "valid", "count"):
        assert torch.equal(getattr(out.detections, k),
                           getattr(det, k)), k
    # Interpolation runs on db − noise, so delay, doppler and snr carry
    # noise's last bits, which depend on the order of the dB sum.
    for got, want in ((out.noise_power, noise), (out.max_power, max_power),
                      (out.detections.snr, det.snr),
                      (out.detections.delay, det.delay),
                      (out.detections.doppler, det.doppler)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(), rtol=0, atol=1e-4)
    return det


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("detector", DETECTORS)
@pytest.mark.parametrize("shape", MESHES)
def test_rowpar_step_matches_gathered_form(shape, detector, dtype,
                                           monkeypatch):
    """The whole step on two scenes' CPIs: each rank's rows against the
    single-device detectors on the gathered map."""
    sp = _pipe(MESHES[shape], detector, DTYPES[dtype][0])
    seen = _spy(monkeypatch, sp)
    xb, yb = _batch(max(2, sp.n_cpi_axis))
    out = sp(*sp.shard_inputs(xb, yb))
    det = _assert_gathered(sp, out, seen)
    assert int(det.valid.sum()) >= 2 * xb.shape[0]  # both targets, each CPI


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("detector", DETECTORS)
@pytest.mark.parametrize("shape", MESHES)
def test_rowpar_step_matches_jax(shape, detector, dtype):
    """The port's row-sharded step against JAX's: at complex128 the maps
    within 1e-6 dB (the fused detector's float32 map within the 2e-4 of
    tests/test_torch_detect.py) and the same detection sets; at complex64
    the bounds of test_torch_sharded.py's test_sharded_matches_jax."""
    tdt, jdt = DTYPES[dtype]
    d = _config(detector)
    sp = _pipe(MESHES[shape], detector, tdt)
    n = MESHES[shape][0] * MESHES[shape][1]
    ref = JaxSharded(jax_config(d), jax_mesh(*MESHES[shape],
                                             devices=jax.devices()[:n]),
                     dtype=jdt,
                     row_shard=True, use_pallas_detect=detector == "fused")
    xb, yb = _batch(max(2, sp.n_cpi_axis), seed=4)
    out = sp(*sp.shard_inputs(xb, yb))
    jout = ref(*ref.shard_inputs(xb, yb))
    db, jdb = out.db_map.numpy(), np.asarray(jout.db_map)
    assert db.shape == jdb.shape == (xb.shape[0], 41, 66)
    noise, jnoise = out.noise_power.numpy(), np.asarray(jout.noise_power)
    maxp, jmaxp = out.max_power.numpy(), np.asarray(jout.max_power)
    if dtype == "c128":
        atol = 2e-4 if detector == "fused" else 1e-6
        np.testing.assert_allclose(db, jdb, rtol=0, atol=atol)
        np.testing.assert_allclose(noise, jnoise, rtol=0, atol=atol)
        np.testing.assert_allclose(maxp, jmaxp, rtol=0, atol=atol)
        for i in range(xb.shape[0]):
            v, jv = out.detections.valid[i].numpy(), \
                np.asarray(jout.detections.valid)[i]
            assert set(zip(out.detections.row[i].numpy()[v].tolist(),
                           out.detections.col[i].numpy()[v].tolist())) == \
                set(zip(np.asarray(jout.detections.row)[i][jv].tolist(),
                        np.asarray(jout.detections.col)[i][jv].tolist()))
    else:
        np.testing.assert_allclose(db, jdb, rtol=0, atol=0.05)
        np.testing.assert_allclose(noise, jnoise, rtol=0, atol=1e-3)
        np.testing.assert_allclose(maxp, jmaxp, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_rowpar_fused_with_no_row_halo(shape, monkeypatch):
    """nCentroid 1: the centroid window holds one row, so the fused
    detector takes no row halo (no shift) and still gives the gathered
    form's products."""
    d = _config("fused")
    d["process"]["detection"]["nCentroid"] = 1
    sp = ShardedCpiPipeline(config_from_dict(d), _mesh(MESHES[shape]),
                            row_shard=True, use_fused_detect=True)
    assert sp.fused_detector.win_rows == 0
    seen = _spy(monkeypatch, sp)
    xb, yb = _batch(max(2, sp.n_cpi_axis), seed=2)
    planes = sp.shard_inputs(xb, yb)
    with coll.count_bytes(sp.mesh) as ops:
        out = sp(*planes)
    assert sum(op.kind == "permute" for op in ops) == 4  # the clutter's
    _assert_gathered(sp, out, seen)


# -- scenes at the row-block edges ---------------------------------------------

def _scene_map(sp, scene, seed):
    """A (B, nd, nc) complex map of unit noise with peaks by scene, and the
    rows the scene puts at the edge of the first row block."""
    nd, nc = sp.ambiguity.n_doppler_bins, sp.ambiguity.n_delay_bins
    r_len = sp.nd_rows_pad // sp.n_pulse_axis
    rng = np.random.default_rng(seed)
    b = sp.n_cpi_axis
    z = rng.standard_normal((b, nd, nc)) + 1j * rng.standard_normal((b, nd, nc))
    e = r_len  # the first row of rank 1's block
    if scene == "straddle":
        # A 3 x 3 bump centred on the edge row: its centroid window and its
        # interpolation reach into both blocks.
        for dr, dc, a in ((0, 0, 60.0), (-1, 0, 30.0), (1, 0, 25.0),
                          (0, -1, 28.0), (0, 1, 20.0)):
            z[:, e + dr, 30 + dc] += a
    elif scene == "suppress":
        # Two hits of one centroid window, one in each block: the weaker
        # goes, whichever rank holds it.
        z[0, e - 2, 40] += 45.0
        z[0, e + 1, 41] += 60.0
        z[-1, e - 1, 20] += 70.0
        z[-1, e + 2, 22] += 50.0
    elif scene == "overflow":
        # 16 separated peaks for a capacity of 8: the first 8 in raster
        # order, across the blocks.
        for r in (3, 15, 27, 38):
            for c in (12, 25, 40, 55):
                z[:, r, c] += 40.0
    elif scene == "phantom":
        # Peaks on the map's last rows, next to the last rank's phantom
        # rows, which hold garbage the map does not have.
        z[:, nd - 2, 33] += 50.0
        z[:, nd - 1, 50] += 45.0
    return z, e


def _rank_blocks(sp, z, phantom=0.0):
    """The per-rank (b, R, nc) row blocks of map z, its phantom rows set to
    ``phantom``."""
    nd = sp.ambiguity.n_doppler_bins
    r_len = sp.nd_rows_pad // sp.n_pulse_axis
    b = z.shape[0] // sp.n_cpi_axis
    pad = np.full((z.shape[0], sp.nd_rows_pad - nd, z.shape[2]), phantom,
                  dtype=z.dtype)
    full = torch.from_numpy(np.concatenate([z, pad], axis=1))
    zs = [None] * sp.mesh.size
    for r in range(sp.mesh.size):
        c, p = sp.mesh.coords(r)
        zs[r] = full[c * b:(c + 1) * b, p * r_len:(p + 1) * r_len]
    return zs


def _wide_window_config(detector):
    """nCentroid 13: the centroid window spans 12 rows each way, more than
    a rank's 11 rows at 1 x 4."""
    d = _config(detector)
    d["process"]["detection"]["nCentroid"] = 13
    return config_from_dict(d)


@pytest.mark.parametrize("detector", ["ca", "fused"])
def test_auto_layout_where_the_window_passes_a_rank(detector):
    """"auto" picks the replicated layout where the fused detector's
    centroid window reaches past the neighbouring rank's rows (the plain
    detectors need no row halo and stay row-sharded), and the step runs
    there with the explicit replicated layout's bits; an explicit
    ``row_shard=True`` refuses such a window."""
    cfg, mesh = _wide_window_config(detector), _mesh((1, 4))
    fused = detector == "fused"
    sp = ShardedCpiPipeline(cfg, mesh, row_shard="auto",
                            use_fused_detect=fused)
    assert sp._row_shard is not fused
    if not fused:
        return
    assert sp.fused_detector.win_rows == 12
    with pytest.raises(ValueError, match="centroid window"):
        ShardedCpiPipeline(cfg, mesh, row_shard=True, use_fused_detect=True)
    ref = ShardedCpiPipeline(cfg, mesh, row_shard=False,
                             use_fused_detect=True)
    xb, yb = _batch(2, seed=3)
    out, want = sp(*sp.shard_inputs(xb, yb)), ref(*ref.shard_inputs(xb, yb))
    for g, e in zip(tsharded._fields(out), tsharded._fields(want)):
        assert (g is None and e is None) or torch.equal(g, e)


def test_calibrate_keeps_replicated_where_the_window_passes_a_rank():
    """calibrate_row_shard times only the replicated layout where the row
    blocks cannot hold the fused detector's window, and picks it."""
    cal = tsharded.calibrate_row_shard(_wide_window_config("fused"),
                                       _mesh((1, 4)), n_trials=1,
                                       use_fused_detect=True)
    assert cal["ms_on"] is None and cal["ms_off"] > 0.0
    assert cal["row_shard"] is False and not cal["pipeline"]._row_shard


@pytest.mark.parametrize("scene", ["straddle", "suppress", "overflow",
                                   "phantom"])
@pytest.mark.parametrize("detector", DETECTORS)
@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_rowpar_scenes_match_gathered_form(shape, detector, scene,
                                           monkeypatch):
    # minDoppler 0: at 2 x 2 the block edge is the zero-Doppler row 21.
    sp = _pipe(MESHES[shape], detector, max_detections=8, min_doppler=0)
    z, edge = _scene_map(sp, scene, seed=len(scene))
    phantom = 1e3 + 1e3j if scene == "phantom" else 0.0
    seen = _spy(monkeypatch, sp)
    zs = [t.to(torch.complex64) for t in _rank_blocks(sp, z, phantom)]
    db, noise, max_power, det = sp._detect_rows(zs)
    out = SimpleNamespace(db_map=db, noise_power=noise, max_power=max_power,
                          detections=det)
    want = _assert_gathered(sp, out, seen)
    cells = [set(zip(want.row[i][want.valid[i]].tolist(),
                     want.col[i][want.valid[i]].tolist()))
             for i in range(z.shape[0])]
    if scene == "straddle":
        # Kept on the edge row, its Doppler moved off the bin by the
        # neighbours across the edge.
        for i, c in enumerate(cells):
            assert (edge, 30) in c
            k = int(((want.row[i] == edge) & want.valid[i]).nonzero()[0, 0])
            assert float(want.doppler[i, k]) != float(
                sp.ambiguity.doppler_axis[edge])
    elif scene == "suppress":
        assert (edge + 1, 41) in cells[0] and (edge - 2, 40) not in cells[0]
        assert (edge - 1, 20) in cells[-1] and (edge + 2, 22) not in cells[-1]
    elif scene == "overflow":
        nd = sp.ambiguity.n_doppler_bins
        hits = torch.cat([seen["gathered"][g[0]][1][:, :nd]
                          for g in sp.mesh.groups("pulse")])
        assert all(int(h.sum()) >= 16 for h in hits)
        for c in cells:
            assert {(3, 12), (3, 25), (3, 40), (3, 55)} <= c
            assert not any(r == 38 for r, _ in c)
    else:
        # The peak next to the phantom rows survives their garbage.
        nd = sp.ambiguity.n_doppler_bins
        assert all((nd - 2, 33) in c for c in cells)


# -- the kernel's row-block mode (its plain twin) -------------------------------

def _detector(nr, nc, n_centroid=6):
    delay_axis = np.arange(-10, nc - 10)
    doppler_axis = 2.0 * (np.arange(nr) - nr // 2)
    return FusedDetector(1e-3, 2, 6, 5, 6.0, n_centroid, n_centroid, 2.0,
                         delay_axis, doppler_axis, device="cpu")


@pytest.mark.parametrize("kind", ["complex64", "float32"])
@pytest.mark.parametrize("n_ranks", [3, 4])
def test_detect_rows_plain_matches_map_mode(n_ranks, kind):
    """Blocks cut from one map, the first, middle and last blocks with halo
    rows past the map's edges and phantom rows past its end: db and keep
    are the map mode's bits row for row, the sums and maxima its rows'."""
    nr, nc = 37, 53
    fd = _detector(nr, nc)
    wr = fd.win_rows
    rng = np.random.default_rng(n_ranks)
    z = (rng.standard_normal((nr, nc))
         + 1j * rng.standard_normal((nr, nc))).astype(np.complex64)
    r_len = -(-nr // n_ranks)
    for r in range(0, nr, 5):
        z[r, (7 * r) % nc] += 30.0
        z[min(r + 1, nr - 1), (7 * r + 2) % nc] += 25.0  # window partners
    zt = torch.from_numpy(z)
    m = zt if kind == "complex64" else (zt.real ** 2 + zt.imag ** 2)
    whole = detect_plain(m, fd._scale, fd._cell_ok, fd.n_guard, fd.n_train,
                         wr, fd.win_cols)
    padded = torch.cat([m.new_zeros((wr, nc)), m,
                        m.new_full((n_ranks * r_len - nr + wr, nc), 7.0)])
    blocks = torch.stack([padded[d * r_len:d * r_len + r_len + 2 * wr]
                          for d in range(n_ranks)])
    first = [d * r_len for d in range(n_ranks)]
    got = detect_rows_plain(blocks, first, nr, fd._scale, fd._cell_ok,
                            fd.n_guard, fd.n_train, wr, fd.win_cols)
    assert got.db.shape == got.keep.shape == (n_ranks, r_len, nc)
    db = got.db.reshape(-1, nc)
    assert torch.equal(db[:nr], whole.db)
    assert bool(torch.isneginf(db[nr:]).all())
    keep = got.keep.reshape(-1, nc)
    assert torch.equal(keep[:nr], whole.keep)
    assert not bool(keep[nr:].any())
    assert int(whole.keep.sum()) > 2
    for d in range(n_ranks):
        rows = whole.db[d * r_len:min(nr, (d + 1) * r_len)]
        np.testing.assert_allclose(float(got.sums[d]),
                                   float(rows.double().sum()), rtol=1e-6)
        assert float(got.maxes[d]) == max(0.0, float(rows.max()))
    np.testing.assert_allclose(float(got.sums.double().sum()) / (nr * nc),
                               float(whole.noise), atol=1e-5)
    # The wrapper on CPU parts: the plain twin on the parts joined, no
    # launch.
    launches = tdetect.detect.launches
    parts = [(b[:wr], b[wr:wr + r_len], b[wr + r_len:]) for b in blocks]
    again = fd.rows(parts, first)
    assert tdetect.detect.launches == launches
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_detect_rows_wrapper_checks_what_the_kernel_takes():
    fd = _detector(20, 30)
    wr = fd.win_rows
    ok = torch.zeros((wr, 30)), torch.zeros((8, 30)), torch.zeros((wr, 30))
    from blah2_tpu_torch.ops.detect import _check_rows

    args = (fd._scale, fd._cell_ok, torch.device("cpu"), fd.n_guard,
            fd.n_train, wr, fd.win_cols)
    _check_rows([ok], [0], 20, *args)
    with pytest.raises(ValueError, match="first rows"):
        _check_rows([ok], [0, 8], 20, *args)
    with pytest.raises(ValueError, match="contiguous rows"):
        wide = torch.zeros((8, 60))[:, :30]
        _check_rows([(ok[0], wide, ok[2])], [0], 20, *args)
    with pytest.raises(TypeError, match="complex64"):
        _check_rows([tuple(t.double() for t in ok)], [0], 20, *args)
    with pytest.raises(ValueError, match="cell_ok"):
        _check_rows([ok], [0], 21, *args)


# -- row halos and the new collectives ------------------------------------------

@pytest.mark.parametrize("backend", ["ppermute", "pallas"])
@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_row_halos_match_slicing(shape, backend):
    """The first / last rows of the next / previous rank's (B, R, n) block
    (a narrow view of one tensor, as the Doppler psum_scatter leaves it);
    zeros at the ring's edges."""
    mesh = _mesh(MESHES[shape])
    n_p = mesh.shape["pulse"]
    whole = torch.randn((2, 3 * n_p * 7, 5), dtype=torch.complex64)
    vs = [whole[:, mesh.axis_index(r, "pulse") * 7:
                (mesh.axis_index(r, "pulse") + 1) * 7] for r in range(mesh.size)]
    nxt = rows_from_next(vs, 3, mesh, backend=backend, collective_id=5)
    prv = rows_from_prev(vs, 2, mesh, backend=backend, collective_id=6)
    for r in range(mesh.size):
        p = mesh.axis_index(r, "pulse")
        assert nxt[r].shape == (2, 3, 5) and prv[r].shape == (2, 2, 5)
        want_n = vs[r + 1][:, :3] if p < n_p - 1 else torch.zeros(2, 3, 5)
        want_p = vs[r - 1][:, -2:] if p > 0 else torch.zeros(2, 2, 5)
        assert torch.equal(nxt[r], want_n.to(torch.complex64))
        assert torch.equal(prv[r], want_p.to(torch.complex64))
    with pytest.raises(ValueError, match="row halo"):
        rows_from_next(vs, 0, mesh, backend=backend)


def test_pmax_and_all_gather_on_one_process():
    mesh = _mesh((2, 2))
    xs = [torch.tensor([float(r), -float(r)]) for r in range(4)]
    first = coll.pmax(xs, mesh)
    assert first[1] is None and first[3] is None
    assert first[0].tolist() == [1.0, 0.0] and first[2].tolist() == [3.0, -2.0]
    sums = coll.psum(xs, mesh, first_only=True)
    assert sums[1] is None and sums[2].tolist() == [5.0, -5.0]
    a = [torch.full((1, 2, 3), float(r)) for r in range(4)]
    b = [torch.full((1, 2, 3), r % 2 == 0) for r in range(4)]
    with coll.count_bytes(mesh) as ops:
        out = coll.all_gather([a, b], mesh, dim=1)
    assert out[1] is None and out[3] is None
    for first, (ga, gb) in ((0, out[0]), (2, out[2])):
        assert torch.equal(ga, torch.cat([a[first], a[first + 1]], dim=1))
        assert torch.equal(gb, torch.cat([b[first], b[first + 1]], dim=1))
    assert [(op.kind, op.shape, op.bytes_per_rank) for op in ops] == [
        ("all_gather", (1, 4, 3), 48), ("all_gather", (1, 4, 3), 12)]
