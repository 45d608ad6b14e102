"""The (cpi, pulse)-sharded CPI pipeline over logical ranks (counterpart of
``blah2_tpu/parallel/sharded.py``).

One process runs every rank of a :class:`RadarMesh`, as JAX's
``shard_map`` is single-controller; a sharded value is a list with one
tensor per rank, and the collectives of ``parallel/collectives.py`` join
the lists. The layout is the JAX module's:

  - input IQ ``(B, n_pad)``: the CPI batch split over ``cpi`` (each rank row
    holds B / n_cpi CPIs, the vmap of the JAX step written out as a batch
    dimension); each CPI's time axis split in contiguous pulse blocks over
    ``pulse``;
  - clutter filter: per-rank segmented correlations with an (nb−1)-sample
    right halo from the next rank, partial spectra psum'd over ``pulse``,
    the small Toeplitz/Cholesky solve replicated (computed once per device
    and cpi row: ranks on one device share it), the FIR apply local with an
    (nb−1)-sample left halo (overlap-save);
  - ambiguity: per-rank batched range FFTs; the Doppler stage multiplies
    each rank's pulse block by its column block of the shifted-DFT operator
    and reduces over ``pulse`` (psum_scatter of Doppler row blocks when
    row-sharded, else psum);
  - spectrum: local fold per rank, (n_spectrum,) partials psum'd;
  - detection on the map gathered per CPI in rank order, outside the ranks.
    JAX lets GSPMD partition that per-row work; the gather computes the same
    function.

Clutter correlations are linear (zero-extended), as in the JAX module: the
sharded pipeline matches the single-device ``CpiPipeline`` in
``clutter_mode="linear"``. The pulse count is zero-padded to a multiple of
the pulse-axis size with phantom pulses whose DFT columns are zero.
Constants and outputs live on rank 0's device.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from blah2_tpu_torch.config import Config
from blah2_tpu_torch.device import complex_of_parts
from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor
from blah2_tpu_torch.dsp.centroid import CentroidFilter
from blah2_tpu_torch.dsp.cfar import CfarDetections, make_cfar
from blah2_tpu_torch.dsp.clutter import solve_normal_equations
from blah2_tpu_torch.dsp.hamming import segment_fft_size
from blah2_tpu_torch.dsp.interpolate import PeakInterpolator
from blah2_tpu_torch.dsp.pipeline import CpiOutputs
from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser
from blah2_tpu_torch.ops.detect import FusedDetector
from blah2_tpu_torch.ops.halo import halo_permute
from blah2_tpu_torch.parallel.collectives import psum, psum_scatter
from blah2_tpu_torch.parallel.halo import (BACKENDS, shift_from_next,
                                           shift_from_prev)
from blah2_tpu_torch.parallel.mesh import RadarMesh

Ranks = List[torch.Tensor]


def pick_local_segments(block_len: int, n_lags: int,
                        target: int = 16384) -> int:
    """Number of overlap-save segments per rank block: a divisor of
    ``block_len`` giving segments ≥ max(4·n_lags, 1024), near ``target``."""
    floor = max(4 * n_lags, 1024)
    best = 1
    for k in range(1, block_len + 1):
        if k * k > block_len * 4:
            break
        if block_len % k == 0:
            s = block_len // k
            if s >= floor and abs(s - target) < abs(block_len // best - target):
                best = k
    return best


def _stack_detections(dets: List[CfarDetections]) -> CfarDetections:
    return CfarDetections(*[torch.stack(f) for f in zip(*dets)])


class ShardedCpiPipeline(nn.Module):
    """The CPI processor for one config on a (cpi, pulse) mesh.

    ``halo_backend``: "ppermute" (collectives' open-chain permute) or
    "pallas" (the CUDA halo kernel on a card, its plain twin on the CPU).
    ``use_fused_detect``: the fused detector (``csrc/detect.cu`` on a card)
    on the whole (B, nr, nc) batch in one call; off by default, as JAX's
    ``use_pallas_detect``.
    """

    def __init__(
        self,
        config: Config,
        mesh: RadarMesh,
        max_detections: int = 128,
        dtype: torch.dtype = torch.complex64,
        spectrum_bandwidth: Optional[float] = None,
        diag_load: float = 0.0,
        halo_backend: str = "ppermute",
        use_fused_detect: bool = False,
        row_shard="auto",
    ):
        super().__init__()
        if halo_backend not in BACKENDS:
            raise ValueError(f"unknown halo backend {halo_backend!r}")
        self.config = config
        self.mesh = mesh
        self.dtype = dtype
        self.halo_backend = halo_backend
        self.device = device = mesh.devices[0]
        self.n_pulse_axis = mesh.shape["pulse"]
        self.n_cpi_axis = mesh.shape["cpi"]
        proc, cap = config.process, config.capture
        self.n_samples = n = config.n_samples

        amb = AmbiguityProcessor(
            proc.ambiguity.delay_min, proc.ambiguity.delay_max,
            proc.ambiguity.doppler_min, proc.ambiguity.doppler_max,
            cap.fs, n, round_hamming=True, dtype=dtype, device=device)
        self.ambiguity = amb

        # Pad the pulse axis to a multiple of the pulse-axis size, and far
        # enough that n_pad = nd_pad·n_corr covers all n input samples.
        nd = amb.n_doppler_bins
        min_pulses = max(nd, -(-n // amb.n_corr))
        self.nd_pad = -(-min_pulses // self.n_pulse_axis) * self.n_pulse_axis
        self.n_pad = self.nd_pad * amb.n_corr
        self.block_len = self.n_pad // self.n_pulse_axis
        # Row-sharded Doppler output: the Doppler reduction becomes a
        # psum_scatter of row blocks (the JAX module's crossover: at least 8
        # rows a rank, or one rank on the axis).
        if row_shard == "auto":
            self._row_shard = (nd // self.n_pulse_axis) >= 8 or \
                self.n_pulse_axis == 1
        else:
            self._row_shard = bool(row_shard)
        self.nd_rows_pad = -(-nd // self.n_pulse_axis) * self.n_pulse_axis \
            if self._row_shard else nd
        w_pad = torch.zeros((self.nd_rows_pad, self.nd_pad), dtype=dtype,
                            device=device)
        w_pad[:nd, :nd] = amb._doppler_dft
        self.register_buffer("_w_pad", w_pad)
        ramp_pad = None
        if amb._ramp is not None:
            ramp_pad = torch.zeros(self.n_pad, dtype=dtype, device=device)
            ramp_pad[: amb.n_used_samples] = amb._ramp
        self.register_buffer("_ramp_pad", ramp_pad)

        if spectrum_bandwidth is None:
            spectrum_bandwidth = proc.spectrum.bandwidth
        self.spectrum = SpectrumAnalyser(n, spectrum_bandwidth, cap.fc,
                                         dtype=dtype, device=device)
        # Fold twiddle padded to the sharded time axis: each rank folds its
        # block and the (n_spectrum,) partials psum.
        self.register_buffer("_spec_tw_pad",
                             self.spectrum.twiddle_padded(self.n_pad))
        if int(proc.spectrum.n_sub or 1) > 1:
            raise NotImplementedError(
                "process.spectrum.nSub > 1 in mesh mode is not ported to "
                "blah2_tpu_torch yet (ROADMAP.md queue 1: 'The rest of "
                "multi-device', mesh-mode nSub > 1)")

        self.clutter_enabled = proc.clutter.enable
        kind = (getattr(proc.clutter, "filter", "wiener") or "wiener").lower()
        kind = kind.replace("_", "-")
        if kind in ("eca-b", "ecab", "eca", "nlms"):
            self.clutter_kind = "nlms" if kind == "nlms" else "eca-b"
            if self.clutter_enabled:
                raise NotImplementedError(
                    f"the sharded {self.clutter_kind} clutter filter is not "
                    f"ported to blah2_tpu_torch yet (ROADMAP.md queue 1: "
                    f"'The rest of multi-device', after 'Alternative "
                    f"algorithms')")
        else:
            self.clutter_kind = "wiener"
            if self.clutter_enabled and kind not in (
                    "wiener", "wiener-hopf", "wienerhopf"):
                warnings.warn(
                    f"process.clutter.filter={kind!r} is not supported in "
                    "mesh mode; falling back to the sharded Wiener-Hopf "
                    "canceller", stacklevel=2)
        if self.clutter_enabled:
            self.nb = proc.clutter.delay_max - proc.clutter.delay_min
            self.clutter_delay_min = proc.clutter.delay_min
            if self.nb - 1 > self.block_len:
                raise ValueError(
                    "clutter lag window exceeds per-device block; reduce the "
                    "pulse-axis size")
            self.n_seg_local = pick_local_segments(self.block_len, self.nb)
            self.seg_len = self.block_len // self.n_seg_local
            # The port's own size picker (not the JAX v5e table); the map's
            # value does not depend on it.
            self.nfft_seg = segment_fft_size(self.seg_len + self.nb - 1,
                                             device.type)
            self.diag_load = diag_load

        self.detection_enabled = proc.detection.enable
        self.fused_detector = None
        if self.detection_enabled:
            self.cfar = make_cfar(
                proc.detection, amb.delay_axis, amb.doppler_axis,
                max_detections=max_detections, device=device)
            self.centroid = CentroidFilter(
                proc.detection.n_centroid, proc.detection.n_centroid,
                1.0 / proc.data.cpi)
            self.interpolate = PeakInterpolator(
                True, True, amb.doppler_resolution, amb.n_doppler_bins,
                amb.n_delay_bins)
            if use_fused_detect:
                self.fused_detector = FusedDetector.from_config(
                    proc, amb, max_detections=max_detections, device=device)

    # -- per-rank stages ----------------------------------------------------
    def _const(self, name: str, dev: torch.device) -> torch.Tensor:
        """A state constant on ``dev`` (a copy where it is not rank 0's)."""
        return getattr(self, name).to(dev)

    def _shift(self, vs: Ranks, count: int, from_next: bool,
               cid: int) -> Ranks:
        fn = shift_from_next if from_next else shift_from_prev
        return fn(vs, count, self.mesh, "pulse", backend=self.halo_backend,
                  collective_id=cid)

    def _segments_right_halo(self, vs: Ranks, cid: int = 0) -> Ranks:
        """(B, block_len) → (B, n_seg_local, seg_len + nb − 1) with halo;
        the last segment's halo comes from the next rank (zeros at the
        global end)."""
        h = self.nb - 1
        halo_next = self._shift(vs, h, True, cid)
        out = []
        for v, nxt in zip(vs, halo_next):
            main = v.reshape(v.shape[0], self.n_seg_local, self.seg_len)
            tails = nxt[:, None, :]
            if self.n_seg_local > 1:
                tails = torch.cat([main[:, 1:, :h], tails], dim=1)
            out.append(torch.cat([main, tails], dim=-1))
        return out

    def _clutter_block(self, xs: Ranks, ys: Ranks):
        """Per-rank Wiener-Hopf: (filtered y, ok) per rank."""
        mesh = self.mesh
        nb, f = self.nb, self.nfft_seg
        s = self.clutter_delay_min

        # Linear shift: xs[i] = x[i − s] with zero extension at the ends.
        if s < 0:
            inc = self._shift(xs, -s, True, 2)
            xs_loc = [torch.cat([x[..., -s:], i], dim=-1)
                      for x, i in zip(xs, inc)]
        elif s > 0:
            inc = self._shift(xs, s, False, 2)
            xs_loc = [torch.cat([i, x[..., :-s]], dim=-1)
                      for x, i in zip(xs, inc)]
        else:
            xs_loc = xs

        xs_ext = self._segments_right_halo(xs_loc, cid=0)
        y_ext = self._segments_right_halo(ys, cid=1)
        xs_seg = [x.reshape(x.shape[0], self.n_seg_local, self.seg_len)
                  for x in xs_loc]
        spec_a, spec_b = [], []
        for xe, ye, xg in zip(xs_ext, y_ext, xs_seg):
            xf_seg = torch.conj(torch.fft.fft(xg, n=f, dim=-1))
            ext_f = torch.fft.fft(torch.stack([xe, ye]), n=f, dim=-1)
            acc = torch.sum(ext_f * xf_seg[None], dim=-2)
            spec_a.append(acc[0])
            spec_b.append(acc[1])
        spec_a = psum(spec_a, mesh, "pulse")
        spec_b = psum(spec_b, mesh, "pulse")

        # Replicated Toeplitz solve, once per device and cpi row.
        solved: dict = {}
        weights, oks = [], []
        for r in range(mesh.size):
            key = (mesh.axis_index(r, "cpi"), spec_a[r].device)
            if key not in solved:
                a = torch.conj(torch.fft.ifft(spec_a[r], dim=-1)[..., :nb])
                b = torch.fft.ifft(spec_b[r], dim=-1)[..., :nb]
                solved[key] = solve_normal_equations(a, b, self.diag_load)
            w, ok = solved[key]
            weights.append(w)
            oks.append(ok)

        # Overlap-save FIR: left halo from the previous rank.
        h = nb - 1
        halo_prev = self._shift(xs_loc, h, False, 3)
        out = []
        for y, xg, hp, w, ok in zip(ys, xs_seg, halo_prev, weights, oks):
            heads = hp[:, None, :]
            if self.n_seg_local > 1:
                heads = torch.cat([heads, xg[:, :-1, self.seg_len - h:]],
                                  dim=1)
            ext = torch.cat([heads, xg], dim=-1)
            wf = torch.fft.fft(w, n=f, dim=-1)
            conv = torch.fft.ifft(torch.fft.fft(ext, n=f, dim=-1)
                                  * wf[:, None, :], dim=-1)
            filt = conv[..., h:h + self.seg_len].reshape(y.shape)
            out.append(torch.where(ok[:, None], y - filt, y))
        return out, oks

    def _ambiguity_block(self, xs: Ranks, ys: Ranks) -> Ranks:
        """Per-rank range and Doppler stages, reduced over pulse: the full
        map (psum) or the rank's Doppler row block (psum_scatter)."""
        amb = self.ambiguity
        nc, nfft = amb.n_corr, amb.nfft_compute
        ndp_l = self.nd_pad // self.n_pulse_axis
        partials = []
        for r, (x, y) in enumerate(zip(xs, ys)):
            d = self.mesh.axis_index(r, "pulse")
            dev = x.device
            if self._ramp_pad is not None:
                ramp = self._const("_ramp_pad", dev)
                x = x * ramp[d * self.block_len:(d + 1) * self.block_len]
            bl = x.shape[0]
            xf = torch.fft.fft(x.reshape(bl, ndp_l, nc), n=nfft, dim=-1)
            yf = torch.fft.fft(y.reshape(bl, ndp_l, nc), n=nfft, dim=-1)
            z = torch.fft.ifft(yf * torch.conj(xf), dim=-1)
            c = torch.index_select(z, 2, amb._lags.to(dev))
            w_blk = self._const("_w_pad", dev)[:, d * ndp_l:(d + 1) * ndp_l]
            partials.append(torch.matmul(w_blk, c))
        if self._row_shard:
            return psum_scatter(partials, self.mesh, "pulse", dim=1)
        return psum(partials, self.mesh, "pulse")

    # -- the step --------------------------------------------------------------
    def forward(self, xbp: Ranks, ybp: Ranks) -> CpiOutputs:
        """One step on the per-rank (B / n_cpi, block_len, 2) real/imag
        planes that :meth:`shard_inputs` makes. Products have the whole
        batch B as their leading dimension, on rank 0's device."""
        mesh, home = self.mesh, self.device
        xs = [complex_of_parts(p[..., 0], p[..., 1], self.dtype) for p in xbp]
        ys = [complex_of_parts(p[..., 0], p[..., 1], self.dtype) for p in ybp]
        if self.clutter_enabled:
            ys, oks = self._clutter_block(xs, ys)
        else:
            oks = [torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
                   for x in xs]
        zs = self._ambiguity_block(xs, ys)
        folds = psum([
            self.spectrum.fold_partial(
                x, mesh.axis_index(r, "pulse") * self.block_len,
                self._const("_spec_tw_pad", x.device))
            for r, x in enumerate(xs)], mesh, "pulse")

        # Gather per cpi row, in rank order, onto rank 0's device.
        nd = self.ambiguity.n_doppler_bins
        z_rows, ok_rows, fold_rows = [], [], []
        for group in mesh.groups("pulse"):
            if self._row_shard:
                z = torch.cat([zs[r].to(home) for r in group], dim=1)[:, :nd]
            else:
                z = zs[group[0]].to(home)
            z_rows.append(z)
            ok_rows.append(oks[group[0]].to(home))
            fold_rows.append(folds[group[0]].to(home))
        z = torch.cat(z_rows)
        clutter_ok = torch.cat(ok_rows)
        spec_db = SpectrumAnalyser.to_db(
            self.spectrum.finish(torch.cat(fold_rows)))
        db, noise, max_power, det = self._detect(z)
        return CpiOutputs(db_map=db, noise_power=noise, max_power=max_power,
                          spectrum_db=spec_db, clutter_ok=clutter_ok,
                          detections=det)

    def _detect(self, z: torch.Tensor):
        """Map metrics and detections of the (B, nr, nc) batch."""
        batch = z.shape[0]
        if self.detection_enabled and self.fused_detector is not None:
            db, noise, max_power, det = self.fused_detector(z)
            dets = [self.interpolate(CfarDetections(*[f[i] for f in det]),
                                     db[i] - noise[i]) for i in range(batch)]
            return db, noise, max_power, _stack_detections(dets)
        db = 10.0 * torch.log10(torch.abs(z))
        noise = torch.mean(db, dim=(-2, -1))
        max_power = torch.clamp(torch.amax(db, dim=(-2, -1)), min=0.0) - noise
        if self.detection_enabled:
            dets = []
            for i in range(batch):
                d = self.centroid(self.cfar(z[i], noise[i]))
                dets.append(self.interpolate(d, db[i] - noise[i]))
            return db, noise, max_power, _stack_detections(dets)
        f32 = torch.zeros((batch, 0), dtype=torch.float32, device=z.device)
        i64 = torch.zeros((batch, 0), dtype=torch.int64, device=z.device)
        det = CfarDetections(
            row=i64, col=i64, delay=f32, doppler=f32, snr=f32,
            valid=torch.zeros((batch, 0), dtype=torch.bool, device=z.device),
            count=torch.zeros(batch, dtype=torch.int32, device=z.device))
        return db, noise, max_power, det

    # -- public ----------------------------------------------------------------
    def shard_inputs(self, xb, yb):
        """Pad (B, n_samples) complex arrays (NumPy or tensors) to n_pad and
        split them over the ranks: per rank (B / n_cpi, block_len, 2) real
        and imaginary planes on the rank's device, float32 (float64 for a
        complex128 pipeline)."""
        def host(a):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            return np.asarray(a)

        xb, yb = host(xb), host(yb)
        if xb.ndim == 1:
            xb, yb = xb[None], yb[None]
        if xb.shape[0] % self.n_cpi_axis:
            raise ValueError(
                f"batch {xb.shape[0]} not divisible by cpi axis "
                f"{self.n_cpi_axis}")
        pad = self.n_pad - xb.shape[1]
        if pad < 0:
            xb, yb = xb[:, : self.n_pad], yb[:, : self.n_pad]
        elif pad > 0:
            xb = np.pad(xb, ((0, 0), (0, pad)))
            yb = np.pad(yb, ((0, 0), (0, pad)))
        plane = np.float64 if self.dtype == torch.complex128 else np.float32
        b_loc = xb.shape[0] // self.n_cpi_axis

        def place(a):
            planes = np.stack([a.real, a.imag], axis=-1).astype(plane)
            out = []
            for r, dev in enumerate(self.mesh.devices):
                c, p = self.mesh.coords(r)
                blk = planes[c * b_loc:(c + 1) * b_loc,
                             p * self.block_len:(p + 1) * self.block_len]
                out.append(torch.from_numpy(np.ascontiguousarray(blk)).to(dev))
            return out

        return place(xb), place(yb)


def calibrate_row_shard(config: Config, mesh: RadarMesh, n_trials: int = 3,
                        **pipeline_kw) -> dict:
    """Measure both Doppler-output layouts on THIS mesh and pick the winner
    (the single-process form of the JAX function).

    Runs one step per layout per trial on random planes (the first call
    excluded; best of ``n_trials``) and returns ``{"row_shard": bool,
    "ms_on": .., "ms_off": .., "pipeline": <the winning pipeline>}``. The
    small fetch that ends each step is where the halo kernel's error word
    is read."""
    rng = np.random.default_rng(0)
    b = mesh.shape["cpi"]
    ms: dict = {}
    pipes: dict = {}
    for name, flag in (("ms_on", True), ("ms_off", False)):
        pipe = ShardedCpiPipeline(config, mesh, row_shard=flag,
                                  **pipeline_kw)
        pipes[flag] = pipe
        n = config.n_samples
        xb = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        yb = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        xp, yp = pipe.shard_inputs(xb, yb)
        pipe(xp, yp).noise_power.cpu()  # first call: plans and kernel builds
        best = float("inf")
        for _ in range(n_trials):
            t0 = time.perf_counter()
            pipe(xp, yp).noise_power.cpu()
            best = min(best, 1e3 * (time.perf_counter() - t0))
        ms[name] = best
    halo_permute.check()
    ms["row_shard"] = ms["ms_on"] <= ms["ms_off"]
    ms["pipeline"] = pipes[ms["row_shard"]]
    return ms
