"""The (cpi, pulse)-sharded CPI pipeline over logical ranks (counterpart of
``blah2_tpu/parallel/sharded.py``).

One process runs every rank of a :class:`RadarMesh` that it owns, as JAX's
``shard_map`` runs every device of a process; a sharded value is a list
with one tensor per rank (None at the ranks of another process, where the
mesh spans a job of several), and the collectives of
``parallel/collectives.py`` join the lists. The layout is the JAX
module's:

  - input IQ ``(B, n_pad)``: the CPI batch split over ``cpi`` (each rank row
    holds B / n_cpi CPIs, the vmap of the JAX step written out as a batch
    dimension); each CPI's time axis split in contiguous pulse blocks over
    ``pulse``;
  - clutter filter: per-rank segmented correlations with an (nb−1)-sample
    right halo from the next rank, partial spectra psum'd over ``pulse``,
    the small Toeplitz/Cholesky solve replicated (computed once per device
    and cpi row: ranks on one device share it), the FIR apply local with an
    (nb−1)-sample left halo (overlap-save). ECA-B solves every segment of a
    rank's block locally, from (nb−1)-sample history and lookahead halos;
    NLMS runs its block recursion per rank, warm-started over the previous
    rank's last blocks (a halo), the ranks of one device as one batched
    scan;
  - ambiguity: per-rank batched range FFTs; the Doppler stage multiplies
    each rank's pulse block by its column block of the shifted-DFT operator
    and reduces over ``pulse`` (psum_scatter of Doppler row blocks when
    row-sharded, else psum);
  - spectrum: local fold per rank, (n_spectrum,) partials psum'd; sub-CPI
    spectra (``process.spectrum.nSub`` > 1) the same with one masked fold
    per segment, psum'd as a (k, n_spectrum) stack;
  - detection, row-sharded (the default at 1 × 4 and 2 × 2): each pulse
    rank detects its own Doppler rows, as JAX's GSPMD partitions that
    per-row work (`blah2_tpu/parallel/sharded.py:124-133, 651-690`). A
    rank forms the dB rows, the partial dB sum and max over its rows inside
    the map (the last rank's phantom rows are outside it), and the mask:
    CFAR hits (CFAR runs along delay only, so a rank needs no other rows)
    or, with the fused detector, the centroid keep of the detect kernel's
    row-block mode, whose window reaches ``win_rows`` rows into each
    neighbour's block (row halos, cids 5 and 6, through the halo backend).
    The partials are psum'd and pmax'd over ``pulse`` into noise and
    rawmax; the float32 dB rows and the one-byte mask are all-gathered over
    the row, 5 B a cell where the complex map was 8; the detection list
    (raster-order extraction, centroid, interpolation) is formed on the
    gathered rows, once per cpi row on the process that owns its first
    rank. The products are those of the single-device detectors on the
    gathered map, bit for bit but for noise_power and max_power, whose dB
    sum is added in another order, and snr, delay and doppler, which
    interpolation forms on db − noise. Replicated (``row_shard`` off):
    the psum'd map of the row's first rank, detected there whole. The
    fused detector, when asked for, runs whatever the CFAR kind, as the
    JAX module's ``use_pallas_detect`` does
    (`blah2_tpu/parallel/sharded.py:669`): it computes CA-CFAR.

On cards the step runs as a CUDA graph, as JAX runs it as one compiled
program on any mesh (``blah2_tpu/parallel/sharded.py:315``): one graph per
input layout (per-rank plane shapes and dtypes, the batch), captured at its
first call by ``dsp/graph.py``'s ``StaticCall`` and replayed after, both
kernels inside it. Where this process's ranks lie on several cards the
graph spans them (one capture stream a card); in a job whose payloads go
by NCCL (every process on cards of its own) each process captures its own
segment of the step, its payload collectives inside the capture, and
every process captures at the same call and replays in step. Over gloo
(processes that share a card, or the CPU) the step stays eager
(:func:`graph_mode` says why).

Clutter correlations are linear (zero-extended), as in the JAX module: the
sharded pipeline matches the single-device ``CpiPipeline`` in
``clutter_mode="linear"``. The pulse count is zero-padded to a multiple of
the pulse-axis size with phantom pulses whose DFT columns are zero.
Constants and outputs live on the device of this process's first rank; over
several processes every process ends a step with the whole batch's
products, gathered over the processes as JAX's ``process_allgather``
(``blah2_tpu/runtime/radar.py:798-815``) gives them.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from blah2_tpu_torch.config import Config
from blah2_tpu_torch.device import complex_of_parts, real_dtype
from blah2_tpu_torch.dsp.ambiguity import (AmbiguityProcessor, map_finish,
                                           map_partials)
from blah2_tpu_torch.dsp.centroid import CentroidFilter
from blah2_tpu_torch.dsp.cfar import CfarDetections, make_cfar
from blah2_tpu_torch.dsp.clutter import solve_normal_equations
from blah2_tpu_torch.dsp.clutter_eca import ecab_residual, edge_mask, nlms_scan
from blah2_tpu_torch.dsp.graph import StaticCall
from blah2_tpu_torch.dsp.hamming import segment_fft_size
from blah2_tpu_torch.dsp.interpolate import PeakInterpolator
from blah2_tpu_torch.dsp.pipeline import CpiOutputs
from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser
from blah2_tpu_torch.ops.detect import FusedDetector
from blah2_tpu_torch.ops.halo import halo_permute
from blah2_tpu_torch.parallel import distributed
from blah2_tpu_torch.parallel.collectives import (all_gather, pmax, psum,
                                                  psum_scatter)
from blah2_tpu_torch.parallel.halo import (BACKENDS, rows_from_next,
                                           rows_from_prev, shift_from_next,
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


def rows_fit_window(fused_detector, rows: int) -> bool:
    """Whether row blocks of ``rows`` rows hold the fused detector's
    centroid halo (``win_rows`` rows, taken from the neighbouring rank
    alone); always without the fused detector."""
    return fused_detector is None or fused_detector.win_rows <= rows


def graph_mode(mesh: RadarMesh, graph="auto") -> Tuple[bool, str]:
    """Whether the sharded step on ``mesh`` runs as a CUDA graph, and why
    or why not, from the mesh's layout alone (so every process of a job
    decides the same). ``graph``: "auto" captures where this process's
    ranks lie on cards, on one or several, and the job's payloads travel
    by NCCL; it runs eagerly over gloo (processes that share a card or
    compute on the host: the payloads travel through host memory) and on
    the CPU; False runs eagerly; True captures and raises ``ValueError``
    where it cannot."""
    if graph is False:
        return False, "graph=False"
    cards = mesh.distinct_devices()
    job = distributed.job()
    if mesh.process_count > 1 and (job is None or job.backend != "nccl"):
        # parallel/distributed.py _wire: gloo takes host tensors.
        why = (f"the mesh spans {mesh.process_count} processes over gloo "
               f"({job.reason if job else 'no job'}): the payloads travel "
               f"through host memory, a host call in every step")
    elif any(d.type != "cuda" for d in cards):
        why = f"the ranks are on {cards[0]}: a CUDA graph needs a card"
    else:
        where = (f"every rank of this process on "
                 f"{', '.join(str(d) for d in cards)}")
        if mesh.process_count > 1:
            return True, (f"{where}, process {mesh.process_index} of "
                          f"{mesh.process_count}: the NCCL payloads "
                          f"captured")
        return True, f"{where}, one process"
    if graph == "auto":
        return False, why
    raise ValueError(f"graph=True: {why}")


def _stack_detections(dets: List[CfarDetections]) -> CfarDetections:
    return CfarDetections(*[torch.stack(f) for f in zip(*dets)])


def _fields(out: CpiOutputs) -> list:
    """The products' tensors in a fixed order (the detections' fields in
    place of the tuple; an absent sub_spectra_db as None)."""
    return [out.db_map, out.noise_power, out.max_power, out.spectrum_db,
            out.clutter_ok, *out.detections, out.sub_spectra_db]


def _outputs(fields: list) -> CpiOutputs:
    n = len(CfarDetections._fields)
    return CpiOutputs(*fields[:5], detections=CfarDetections(*fields[5:5 + n]),
                      sub_spectra_db=fields[5 + n])


def _gather_products(out: Optional[CpiOutputs], counts: List[int],
                     spec: list, home: torch.device) -> CpiOutputs:
    """Every process's products of the CPIs it detected (``counts[p]`` of
    them in process p, in row order), joined in process order: one
    all-gather of the fields as bytes, each CPI's bytes of a field padded
    to 8 and each field given room for the most CPIs a process holds.
    ``spec`` gives each field's per-CPI shape and dtype (None: absent)."""
    most = max(counts)
    nbytes = [0 if f is None else
              int(np.prod(f[0], dtype=np.int64)) * f[1].itemsize
              for f in spec]
    room = [-(-n // 8) * 8 for n in nbytes]
    buf = torch.zeros(most * sum(room), dtype=torch.uint8, device=home)
    off = 0
    for k, t in enumerate(_fields(out) if out is not None else spec):
        if out is not None and nbytes[k]:
            n = t.shape[0]
            buf[off:off + n * room[k]].view(n, room[k])[:, :nbytes[k]] = \
                t.contiguous().view(n, -1).view(torch.uint8)
        off += most * room[k]
    parts = distributed.all_gather(buf)
    joined = []
    off = 0
    for k, f in enumerate(spec):
        if f is None:
            joined.append(None)
            continue
        shape, dtype = f
        per = []
        for part, n in zip(parts, counts):
            if n == 0:
                continue
            raw = part[off:off + n * room[k]].view(n, room[k])[:, :nbytes[k]]
            per.append(raw.contiguous().view(dtype).reshape(
                (n,) + tuple(shape)) if nbytes[k] else
                torch.empty((n,) + tuple(shape), dtype=dtype, device=home))
        joined.append(torch.cat(per))
        off += most * room[k]
    return _outputs(joined)


class ShardedCpiPipeline(nn.Module):
    """The CPI processor for one config on a (cpi, pulse) mesh.

    ``halo_backend``: "ppermute" (collectives' open-chain permute) or
    "pallas" (the CUDA halo kernel on a card, its plain twin on the CPU).
    ``use_fused_detect``: the fused detector (``csrc/detect.cu`` on a card):
    row-sharded, its row-block mode on every row block of a card in one
    launch; replicated, the whole (B, nr, nc) batch in one call. Off by
    default, as JAX's ``use_pallas_detect``.
    ``graph``: "auto", True or False (:func:`graph_mode`); ``graph_reason``
    says why the step is captured or not. ``graphs`` holds the captured
    steps (:class:`~blah2_tpu_torch.dsp.graph.StaticCall`) by layout;
    ``before_capture``, where set, is called before each capture (the
    runtime drains its other device thread there).
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
        graph: "str | bool" = "auto",
    ):
        super().__init__()
        if halo_backend not in BACKENDS:
            raise ValueError(f"unknown halo backend {halo_backend!r}")
        self.graph, self.graph_reason = graph_mode(mesh, graph)
        self.graphs: dict = {}
        self.before_capture = None
        self.config = config
        self.mesh = mesh
        self.dtype = dtype
        self.halo_backend = halo_backend
        self.device = device = mesh.device
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

        # Row-sharded Doppler output: the Doppler reduction becomes a
        # psum_scatter of row blocks (the JAX module's crossover: at least 8
        # rows a rank, or one rank on the axis). The fused detector's row
        # blocks take their centroid halo from the neighbouring rank alone,
        # so "auto" keeps the replicated layout where the window reaches
        # past it.
        rows = -(-nd // self.n_pulse_axis)
        if row_shard == "auto":
            self._row_shard = (rows_fit_window(self.fused_detector, rows)
                               and (nd // self.n_pulse_axis >= 8
                                    or self.n_pulse_axis == 1))
        else:
            self._row_shard = bool(row_shard)
            if self._row_shard and not rows_fit_window(self.fused_detector,
                                                       rows):
                raise ValueError(
                    f"the centroid window's {self.fused_detector.win_rows}"
                    f" rows reach past the neighbouring rank's {rows}: "
                    f"use fewer pulse ranks or row_shard=False")
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
        # Sub-CPI spectra (process.spectrum.nSub, the single-device
        # pipeline's pinned bin geometry): one zero-padded fold twiddle row
        # per segment (the zeros outside the segment are its mask), each
        # folded per rank and psum'd.
        self.spectrum_sub = None
        self.n_spectrum_sub = k_sub = int(proc.spectrum.n_sub or 1)
        if k_sub > 1:
            n_seg = n // k_sub
            if n_seg < 2 * self.spectrum.n_spectrum:
                raise ValueError(
                    f"process.spectrum.nSub={k_sub} leaves segments of "
                    f"{n_seg} samples — need at least "
                    f"2x{self.spectrum.n_spectrum} for the shared "
                    f"spectrum-bin geometry")
            self.spectrum_sub = SpectrumAnalyser(
                n_seg, spectrum_bandwidth, cap.fc, dtype=dtype,
                n_spectrum=self.spectrum.n_spectrum,
                offset_even=self.spectrum.decimation % 2 == 0, device=device)
            tw = self.spectrum_sub._twiddle.reshape(-1)
            rows = torch.zeros((k_sub, self.n_pad), dtype=tw.dtype,
                               device=device)
            for s in range(k_sub):
                rows[s, s * n_seg:s * n_seg + tw.shape[0]] = tw
            self.register_buffer("_sub_tw_pad", rows)
            self._sub_seg_len = n_seg

        self.clutter_enabled = proc.clutter.enable
        kind = (getattr(proc.clutter, "filter", "wiener") or "wiener").lower()
        kind = kind.replace("_", "-")
        if kind in ("eca-b", "ecab", "eca"):
            self.clutter_kind = "eca-b"
        elif kind == "nlms":
            # The single-device canceller restarts its weights at every
            # CPI; here they restart at every rank block, warm-started over
            # the previous rank's last nlms_W blocks, so the rank enters
            # converged. The divergence from the single-device filter is
            # those restarts (`tests/test_sharded.py`, nlms drift tests).
            self.clutter_kind = "nlms"
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
        if self.clutter_enabled and self.clutter_kind == "eca-b":
            # Per-segment exact LS over segments of the padded CPI: nBatches
            # rounded to the nearest divisor count of block_len per rank, so
            # every segment's solve is rank-local. The segment grid
            # (multiples of n_pad/(P·S)) differs from the single-device
            # filter's ceil(n/B) grid, as in the JAX module.
            nb = self.nb
            want_local = max(1, round(proc.clutter.n_batches /
                                      self.n_pulse_axis))
            divisors = [k for k in range(1, self.block_len + 1)
                        if self.block_len % k == 0
                        and self.block_len // k > 2 * nb]
            if not divisors:
                raise ValueError(
                    "no valid ECA-B segmentation: clutter lag window too "
                    "large for the per-device block")
            self.n_seg_eca = min(divisors, key=lambda k: abs(k - want_local))
            self.seg_len_eca = self.block_len // self.n_seg_eca
            self.n_batches_eca = self.n_seg_eca * self.n_pulse_axis
            self.nfft_eca = segment_fft_size(
                self.seg_len_eca + 2 * (nb - 1) + nb, device.type)
            self.register_buffer("_eca_edge_mask", edge_mask(nb, device))
            self.diag_load_eca = diag_load if diag_load > 0.0 else 1e-4
        if self.clutter_enabled and self.clutter_kind == "nlms":
            # NlmsClutterFilter's block geometry: L taps rounded up to a
            # power of two, 2L-point FFTs, weights adapt once per L.
            nb = self.nb
            self.nlms_L = 1 << (nb - 1).bit_length()
            self.nlms_M = 2 * self.nlms_L
            if self.nlms_L > self.block_len:
                raise ValueError(
                    "NLMS block (next pow2 of the clutter lag window) "
                    "exceeds the per-device block; reduce the pulse-axis "
                    "size")
            self.nlms_K = -(-self.block_len // self.nlms_L)
            self.nlms_mu = float(getattr(proc.clutter, "mu", 0.1))
            self.nlms_beta = 0.9
            self.nlms_eps = 1e-6
            # Warm-start replay over the previous rank's last W blocks: W
            # covers the convergence time (about 1/mu blocks) when the
            # block affords it.
            self.nlms_W = max(0, min(round(2.0 / self.nlms_mu), 32,
                                     self.block_len // self.nlms_L - 1))
        # The ranks of one device run the NLMS recursion as one batched
        # scan (False: each rank's in turn; the same arithmetic).
        self.nlms_batch_ranks = True
        # Over several processes: the per-CPI fields of the products, by
        # (CPIs a row, CPIs per process).
        self._product_spec: dict = {}
        # Row-sharded detection: the map rows of each device's row blocks.
        self._block_rows: dict = {}

    # -- per-rank stages ----------------------------------------------------
    def _const(self, name: str, dev: torch.device) -> torch.Tensor:
        """A state constant on ``dev`` (a copy where it is not rank 0's)."""
        return getattr(self, name).to(dev)

    def _per_rank(self, fn, *lists) -> list:
        """``fn(rank, *its values)`` at this process's ranks, None at the
        others'."""
        out: list = [None] * self.mesh.size
        for r in self.mesh.local_ranks:
            out[r] = fn(r, *(v[r] for v in lists))
        return out

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

        def one(r, v, nxt):
            main = v.reshape(v.shape[0], self.n_seg_local, self.seg_len)
            tails = nxt[:, None, :]
            if self.n_seg_local > 1:
                tails = torch.cat([main[:, 1:, :h], tails], dim=1)
            return torch.cat([main, tails], dim=-1)

        return self._per_rank(one, vs, halo_next)

    def _linear_shift(self, xs: Ranks) -> Ranks:
        """xs[i] = x[i − delay_min] with zero extension at the CPI's ends;
        the samples that cross a rank boundary come by halo (cid 2)."""
        s = self.clutter_delay_min
        if s < 0:
            inc = self._shift(xs, -s, True, 2)
            return self._per_rank(
                lambda r, x, i: torch.cat([x[..., -s:], i], dim=-1), xs, inc)
        if s > 0:
            inc = self._shift(xs, s, False, 2)
            return self._per_rank(
                lambda r, x, i: torch.cat([i, x[..., :-s]], dim=-1), xs, inc)
        return xs

    def _grouped(self, fn, batch: bool, *inputs: Ranks) -> list:
        """``fn`` on every rank's inputs: with ``batch``, once per device on
        the inputs of its ranks stacked on a new leading dimension (one
        launch of each op for the device's ranks), else once per rank.
        Returns, per rank, ``fn``'s outputs."""
        groups: dict = {}
        for r in self.mesh.local_ranks:
            groups.setdefault(inputs[0][r].device if batch else r,
                              []).append(r)
        out: list = [None] * len(inputs[0])
        for ranks in groups.values():
            res = fn(*[torch.stack([v[r] for r in ranks]) for v in inputs])
            for i, r in enumerate(ranks):
                out[r] = tuple(t[i] for t in res)
        return out

    def _clutter_block(self, xs: Ranks, ys: Ranks):
        """Per-rank Wiener-Hopf: (filtered y, ok) per rank."""
        mesh = self.mesh
        nb, f = self.nb, self.nfft_seg
        xs_loc = self._linear_shift(xs)

        xs_ext = self._segments_right_halo(xs_loc, cid=0)
        y_ext = self._segments_right_halo(ys, cid=1)
        xs_seg = self._per_rank(
            lambda r, x: x.reshape(x.shape[0], self.n_seg_local,
                                   self.seg_len), xs_loc)

        def spectra(r, xe, ye, xg):
            xf_seg = torch.conj(torch.fft.fft(xg, n=f, dim=-1))
            ext_f = torch.fft.fft(torch.stack([xe, ye]), n=f, dim=-1)
            return torch.sum(ext_f * xf_seg[None], dim=-2)

        acc = self._per_rank(spectra, xs_ext, y_ext, xs_seg)
        spec_a = psum(self._per_rank(lambda r, a: a[0], acc), mesh, "pulse")
        spec_b = psum(self._per_rank(lambda r, a: a[1], acc), mesh, "pulse")

        # Replicated Toeplitz solve, once per device and cpi row.
        solved: dict = {}

        def solve(r, sa, sb):
            key = (mesh.axis_index(r, "cpi"), sa.device)
            if key not in solved:
                a = torch.conj(torch.fft.ifft(sa, dim=-1)[..., :nb])
                b = torch.fft.ifft(sb, dim=-1)[..., :nb]
                solved[key] = solve_normal_equations(a, b, self.diag_load)
            return solved[key]

        sols = self._per_rank(solve, spec_a, spec_b)
        oks = self._per_rank(lambda r, wo: wo[1], sols)

        # Overlap-save FIR: left halo from the previous rank.
        h = nb - 1
        halo_prev = self._shift(xs_loc, h, False, 3)

        def fir(r, y, xg, hp, wo):
            w, ok = wo
            heads = hp[:, None, :]
            if self.n_seg_local > 1:
                heads = torch.cat([heads, xg[:, :-1, self.seg_len - h:]],
                                  dim=1)
            ext = torch.cat([heads, xg], dim=-1)
            wf = torch.fft.fft(w, n=f, dim=-1)
            conv = torch.fft.ifft(torch.fft.fft(ext, n=f, dim=-1)
                                  * wf[:, None, :], dim=-1)
            filt = conv[..., h:h + self.seg_len].reshape(y.shape)
            return torch.where(ok[:, None], y - filt, y)

        return self._per_rank(fir, ys, xs_seg, halo_prev, sols), oks

    def _clutter_block_ecab(self, xs: Ranks, ys: Ranks):
        """Per-rank ECA-B (the sharded form of ``EcaBFilter``): every
        segment of a rank's block is solved locally; only the (nb−1)-sample
        history (cid 1) and lookahead (cid 0) halos cross ranks. ``ok`` is
        the psum of the ranks' failures over ``pulse``, as in JAX."""
        nb, S, L = self.nb, self.n_seg_eca, self.seg_len_eca
        h = nb - 1
        xs_loc = self._linear_shift(xs)
        halo_next = self._shift(xs_loc, h, True, 0)
        halo_prev = self._shift(xs_loc, h, False, 1)
        segs = self._per_rank(lambda r, x: x.reshape(x.shape[0], S, L),
                              xs_loc)
        ybs = self._per_rank(lambda r, y: y.reshape(y.shape[0], S, L), ys)

        def extend(r, main, nxt, prv):
            tails, heads = nxt[:, None], prv[:, None]
            if S > 1:
                tails = torch.cat([main[:, 1:, :h], tails], dim=1)
                heads = torch.cat([heads, main[:, :-1, L - h:]], dim=1)
            return torch.cat([heads, main, tails], dim=-1)

        exts = self._per_rank(extend, segs, halo_next, halo_prev)

        def solve(ext, seg, yb):
            res, ok = ecab_residual(
                ext, seg, yb, nb, self.nfft_eca, self.diag_load_eca,
                self._const("_eca_edge_mask", ext.device))
            return res.reshape(res.shape[:-2] + (S * L,)), ok.all(-1)

        out = self._grouped(solve, True, exts, segs, ybs)
        fails = psum(self._per_rank(lambda r, o: (~o[1]).to(torch.int32),
                                    out), self.mesh, "pulse")
        return (self._per_rank(lambda r, o: o[0], out),
                self._per_rank(lambda r, f: f == 0, fails))

    def _clutter_block_nlms(self, xs: Ranks, ys: Ranks):
        """Per-rank block NLMS (the rank-local form of
        ``NlmsClutterFilter``, gradient constraint on). The weights restart
        at each rank and are warm-started by replaying the previous rank's
        last ``nlms_W`` blocks, which arrive by halo (cids 3 and 4) with the
        first block's overlap-save history; rank 0 replays zeros, a no-op,
        like the single-device CPI start. The chains are independent, so
        the ranks of one device run as one scan (``nlms_batch_ranks``)."""
        L, M, K, W = self.nlms_L, self.nlms_M, self.nlms_K, self.nlms_W
        n, blk = self.n_samples, self.block_len
        xs_loc = self._linear_shift(xs)
        halo_x = self._shift(xs_loc, (W + 1) * L, False, 3)
        halo_y = self._shift(ys, W * L, False, 4) if W > 0 else None
        pad = K * L - blk
        inputs = {k: [None] * self.mesh.size for k in ("X", "yk", "Xw", "yw")}
        for r in self.mesh.local_ranks:
            x, y, hx = xs_loc[r], ys[r], halo_x[r]
            b = x.shape[0]
            body = torch.nn.functional.pad(x, (0, pad))
            lead = torch.cat([hx[:, -L:], body[:, :-L]], dim=-1)
            inputs["X"][r] = torch.fft.fft(torch.cat(
                [lead.reshape(b, K, L), body.reshape(b, K, L)], dim=-1),
                dim=-1)
            inputs["yk"][r] = torch.nn.functional.pad(
                y, (0, pad)).reshape(b, K, L)
            if W > 0:
                inputs["Xw"][r] = torch.fft.fft(torch.cat(
                    [hx[:, :-L].reshape(b, W, L),
                     hx[:, L:].reshape(b, W, L)], dim=-1), dim=-1)
                inputs["yw"][r] = halo_y[r].reshape(b, W, L)
        rd = real_dtype(self.dtype)
        consts = (self.nlms_mu, self.nlms_beta, self.nlms_eps)

        def scan(X, yk, *warm):
            w = X.new_zeros(X.shape[:-2] + (M,))
            # The power starts at eps: the denominator at 2·eps.
            d = torch.full(X.shape[:-2] + (M,), 2.0 * self.nlms_eps,
                           dtype=rd, device=X.device)
            if warm:
                # The replay's errors are discarded; only the converged
                # (w, d) carry into the rank's own blocks.
                _, w, d = nlms_scan(warm[0], warm[1], w, d, *consts)
            err, _, _ = nlms_scan(X, yk, w, d, *consts)
            return (err.reshape(err.shape[:-2] + (K * L,))[..., :blk],)

        names = ("X", "yk", "Xw", "yw") if W > 0 else ("X", "yk")
        out = self._grouped(scan, self.nlms_batch_ranks,
                            *[inputs[k] for k in names])
        # The CPI's pad region stays zero (the other filters output w·xs = 0
        # there; NLMS's −ŷ is not zero where a block straddles the edge).
        def trim(r, o):
            e = o[0]
            start = self.mesh.axis_index(r, "pulse") * blk
            keep = max(0, min(blk, n - start))
            if keep < blk:
                e = torch.cat([e[:, :keep], e.new_zeros(
                    (e.shape[0], blk - keep))], dim=-1)
            return e

        return self._per_rank(trim, out), self._per_rank(
            lambda r, y: torch.ones(y.shape[0], dtype=torch.bool,
                                    device=y.device), ys)

    def _ambiguity_block(self, xs: Ranks, ys: Ranks) -> Ranks:
        """Per-rank range and Doppler stages, reduced over pulse: the full
        map (psum) or the rank's Doppler row block (psum_scatter)."""
        amb = self.ambiguity
        nc, nfft = amb.n_corr, amb.nfft_compute
        ndp_l = self.nd_pad // self.n_pulse_axis

        def partial(r, x, y):
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
            return torch.matmul(w_blk, c)

        partials = self._per_rank(partial, xs, ys)
        if self._row_shard:
            return psum_scatter(partials, self.mesh, "pulse", dim=1)
        return psum(partials, self.mesh, "pulse")

    # -- the step --------------------------------------------------------------
    def forward(self, xbp: Ranks, ybp: Ranks) -> CpiOutputs:
        """One step on the per-rank (B / n_cpi, block_len, 2) real/imag
        planes that :meth:`shard_inputs` makes: eagerly, or through the
        CUDA graph of the planes' layout, captured at its first call (which
        returns the warm-up's products) and replayed after. Products have
        the whole batch B as their leading dimension, on the device of this
        process's first rank."""
        if not self.graph:
            return self._step(xbp, ybp)
        planes = [*xbp, *ybp]
        key = self._layout([None if t is None else (tuple(t.shape), t.dtype)
                            for t in planes])
        call = self.graphs.get(key)
        if call is None:
            return self._capture(planes, key)
        return call(*planes)

    def _layout(self, specs: list) -> tuple:
        """A graph's key: the planes' (shape, dtype), None at other
        processes' ranks, and the switches the step reads."""
        return self.halo_backend, self.nlms_batch_ranks, tuple(specs)

    def _capture(self, planes: list, key: tuple) -> CpiOutputs:
        """Capture the step on ``planes`` (the x planes, then the y planes,
        per rank) as the graph of layout ``key``; the warm-up's
        products."""
        if self.before_capture is not None:
            self.before_capture()
        # In a job, NCCL's watchdog thread queries its events while the
        # capture runs: the capture holds only this thread to its rules,
        # so another thread's call cannot fail it.
        mode = ("thread_local" if self.mesh.process_count > 1
                else "global")
        call = StaticCall(self._flat_step, planes, self.device,
                          name="sharded step", meshes=(self.mesh,),
                          capture_error_mode=mode)
        if self.mesh.process_count > 1:
            distributed.at_shutdown(call.release)
        out = call.capture(*planes)
        self.graphs[key] = call
        return out

    def _flat_step(self, *planes) -> CpiOutputs:
        """:meth:`_step` on the x planes, then the y planes, per rank: the
        body of the step's graph."""
        n = self.mesh.size
        return self._step(list(planes[:n]), list(planes[n:]))

    def _step(self, xbp: Ranks, ybp: Ranks) -> CpiOutputs:
        """The eager body of :meth:`forward` (JAX's ``_step``)."""
        mesh, home = self.mesh, self.device
        xs = self._per_rank(lambda r, p: complex_of_parts(
            p[..., 0], p[..., 1], self.dtype), xbp)
        ys = self._per_rank(lambda r, p: complex_of_parts(
            p[..., 0], p[..., 1], self.dtype), ybp)
        if self.clutter_enabled:
            block = {"eca-b": self._clutter_block_ecab,
                     "nlms": self._clutter_block_nlms}.get(
                         self.clutter_kind, self._clutter_block)
            ys, oks = block(xs, ys)
        else:
            oks = self._per_rank(lambda r, x: torch.ones(
                x.shape[0], dtype=torch.bool, device=x.device), xs)
        zs = self._ambiguity_block(xs, ys)
        folds = psum(self._per_rank(
            lambda r, x: self.spectrum.fold_partial(
                x, mesh.axis_index(r, "pulse") * self.block_len,
                self._const("_spec_tw_pad", x.device)), xs), mesh, "pulse")
        subs = None
        if self.spectrum_sub is not None:
            seg = self._sub_seg_len

            def sub_folds(r, x):
                off = mesh.axis_index(r, "pulse") * self.block_len
                tw = self._const("_sub_tw_pad", x.device)
                return torch.stack([
                    self.spectrum_sub.fold_partial(
                        x, off, tw[s], bucket_origin=s * seg)
                    for s in range(self.n_spectrum_sub)], dim=1)

            subs = psum(self._per_rank(sub_folds, xs), mesh, "pulse")

        # Row-sharded: each rank detects its rows (collectives, so every
        # process takes part). Then per cpi row whose first rank is here,
        # onto this process's first rank's device: the products of the
        # row's CPIs (replicated: the psum'd map of the row's first rank,
        # detected here).
        detected = self._detect_rows(zs) if self._row_shard else None
        rows = [g for g in mesh.groups("pulse") if mesh.is_local(g[0])]
        out = None
        if rows:
            ok_rows, fold_rows, sub_rows = [], [], []
            for group in rows:
                ok_rows.append(oks[group[0]].to(home))
                fold_rows.append(folds[group[0]].to(home))
                if subs is not None:
                    sub_rows.append(subs[group[0]].to(home))
            clutter_ok = torch.cat(ok_rows)
            spec_db = SpectrumAnalyser.to_db(
                self.spectrum.finish(torch.cat(fold_rows)))
            sub_db = None
            if subs is not None:
                sub_db = SpectrumAnalyser.to_db(
                    self.spectrum_sub.finish(torch.cat(sub_rows)))
            if detected is None:
                detected = self._detect(
                    torch.cat([zs[g[0]].to(home) for g in rows]))
            db, noise, max_power, det = detected
            out = CpiOutputs(db_map=db, noise_power=noise,
                             max_power=max_power, spectrum_db=spec_db,
                             clutter_ok=clutter_ok, detections=det,
                             sub_spectra_db=sub_db)
        if mesh.process_count == 1:
            return out
        return self._gather_over_processes(
            out, xbp[mesh.local_ranks[0]].shape[0])

    def _gather_over_processes(self, out: Optional[CpiOutputs],
                               b_loc: int) -> CpiOutputs:
        """The whole batch's products in every process, from the rows each
        process detected (``b_loc`` CPIs a row)."""
        mesh = self.mesh
        counts = [0] * mesh.process_count
        for group in mesh.groups("pulse"):
            counts[mesh.process_of(group[0])] += b_loc
        key = (b_loc, tuple(counts))
        if self._product_spec.get(key) is None:
            # Process 0 always holds row 0; its products give the fields'
            # shapes and types to the processes that hold no row.
            spec = None if out is None else [
                None if t is None else (tuple(t.shape[1:]), t.dtype)
                for t in _fields(out)]
            self._product_spec[key] = distributed.broadcast_object(spec, 0)
        return _gather_products(out, counts, self._product_spec[key],
                                self.device)

    def _rows_halo(self, ms: Ranks, count: int, from_next: bool,
                   cid: int) -> Ranks:
        """``count`` rows of each rank's block from its neighbour (none
        where ``count`` is 0)."""
        if count == 0:
            return self._per_rank(lambda r, m: m[:, :0], ms)
        fn = rows_from_next if from_next else rows_from_prev
        return fn(ms, count, self.mesh, "pulse", backend=self.halo_backend,
                  collective_id=cid)

    def _rows_of(self, dev: torch.device, first: tuple) -> torch.Tensor:
        """The map rows of row blocks that start at ``first``: (n, 1, R)
        int64 on ``dev``."""
        key = (dev, first)
        if key not in self._block_rows:
            r = self.nd_rows_pad // self.n_pulse_axis
            # Copied without a wait: a graph's warm-up fills this cache
            # under its check for host syncs, and its capture finds it
            # filled.
            self._block_rows[key] = (
                torch.tensor(first)[:, None, None].to(dev, non_blocking=True)
                + torch.arange(r, device=dev))
        return self._block_rows[key]

    def _detect_rows(self, zs: Ranks):
        """Row-parallel detection of the row-sharded map ``zs`` (each
        rank's (b, R, nc) Doppler rows; the module docstring says how).
        Returns ``(db, noise, max_power, detections)`` of the CPIs of the
        cpi rows whose first rank is in this process, in row order, on this
        process's first rank's device; None where it holds no such rank.
        Every process calls it."""
        mesh = self.mesh
        nd, nc = self.ambiguity.n_doppler_bins, self.ambiguity.n_delay_bins
        r_len = self.nd_rows_pad // self.n_pulse_axis
        fused = self.detection_enabled and self.fused_detector is not None
        if fused:
            ms = self._per_rank(
                lambda r, z: FusedDetector.kernel_input(z), zs)
            wr = self.fused_detector.win_rows
            above = self._rows_halo(ms, wr, False, 6)
            below = self._rows_halo(ms, wr, True, 5)
        by_dev: dict = {}
        for r in mesh.local_ranks:
            by_dev.setdefault(zs[r].device, []).append(r)
        dbs, masks, totals, peaks = ([None] * mesh.size for _ in range(4))
        for dev, ranks in by_dev.items():
            first = tuple(mesh.axis_index(r, "pulse") * r_len for r in ranks)
            b = zs[ranks[0]].shape[0]
            if fused:
                # One launch for every row block of the card.
                got = self.fused_detector.rows(
                    [(above[r][j], ms[r][j], below[r][j]) for r in ranks
                     for j in range(b)], [f for f in first for _ in range(b)])
                lead = (len(ranks), b)
                db = got.db.view(lead + (r_len, nc))
                mask = (got.keep > 0.0).view(lead + (r_len, nc))
                total, peak = got.sums.view(lead), got.maxes.view(lead)
            else:
                rows = self._rows_of(dev, first)
                mag = torch.abs(torch.stack([zs[r] for r in ranks]))
                db = 10.0 * torch.log10(mag)
                total, peak = map_partials(db, rows < nd)
                mask = None
                if self.detection_enabled:
                    m = mag.to(self.cfar.real_dtype)
                    mask = self.cfar.hits(m * m, rows)
            for i, r in enumerate(ranks):
                dbs[r], totals[r], peaks[r] = db[i], total[i], peak[i]
                masks[r] = None if mask is None else mask[i]
        # Read at each row's first rank only.
        total = psum(totals, mesh, "pulse", first_only=True)
        peak = pmax(peaks, mesh, "pulse")
        fields = [dbs, masks] if self.detection_enabled else [dbs]
        gathered = all_gather(fields, mesh, "pulse", dim=1)
        owned = [g[0] for g in mesh.groups("pulse") if mesh.is_local(g[0])]
        if not owned:
            return None
        home = self.device

        def joined(values):
            return torch.cat([v.to(home) for v in values])

        db = joined(gathered[r][0][:, :nd] for r in owned)
        noise, max_power = map_finish(joined(total[r] for r in owned),
                                      joined(peak[r] for r in owned),
                                      nd * nc)
        batch = db.shape[0]
        if not self.detection_enabled:
            return db, noise, max_power, self._no_detections(batch)
        mask = joined(gathered[r][1][:, :nd] for r in owned)
        if fused:
            det = self.fused_detector.detections(mask, db, noise)
            dets = [self.interpolate(CfarDetections(*[f[i] for f in det]),
                                     db[i] - noise[i]) for i in range(batch)]
        else:
            dets = [self.interpolate(self.centroid(self.cfar.extract(
                mask[i], db[i], noise[i])), db[i] - noise[i])
                for i in range(batch)]
        return db, noise, max_power, _stack_detections(dets)

    def _no_detections(self, batch: int) -> CfarDetections:
        dev = self.device
        f32 = torch.zeros((batch, 0), dtype=torch.float32, device=dev)
        i64 = torch.zeros((batch, 0), dtype=torch.int64, device=dev)
        return CfarDetections(
            row=i64, col=i64, delay=f32, doppler=f32, snr=f32,
            valid=torch.zeros((batch, 0), dtype=torch.bool, device=dev),
            count=torch.zeros(batch, dtype=torch.int32, device=dev))

    def _detect(self, z: torch.Tensor):
        """Map metrics and detections of the whole (B, nr, nc) batch (the
        replicated layout)."""
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
        return db, noise, max_power, self._no_detections(batch)

    # -- public ----------------------------------------------------------------
    def shard_inputs(self, xb, yb):
        """Pad (B, n_samples) complex arrays (NumPy or tensors) to n_pad and
        split them over the ranks: per rank (B / n_cpi, block_len, 2) real
        and imaginary planes on the rank's device, float32 (float64 for a
        complex128 pipeline). Over several processes every process holds
        the same full host batch and places only its own ranks' blocks
        (None at the others'), as JAX's ``make_array_from_callback``. Each
        rank's planes are filled in one pass from its block of the batch,
        zero past n_samples: no padded or stacked copy of the batch."""
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
        plane = np.float64 if self.dtype == torch.complex128 else np.float32
        b_loc = xb.shape[0] // self.n_cpi_axis

        def place(a):
            out = [None] * self.mesh.size
            for r in self.mesh.local_ranks:
                c, p = self.mesh.coords(r)
                blk = a[c * b_loc:(c + 1) * b_loc,
                        p * self.block_len:(p + 1) * self.block_len]
                planes = np.zeros((b_loc, self.block_len, 2), plane)
                planes[:, :blk.shape[1], 0] = blk.real
                planes[:, :blk.shape[1], 1] = blk.imag
                out[r] = torch.from_numpy(planes).to(self.mesh.devices[r])
            return out

        return place(xb), place(yb)


def calibrate_row_shard(config: Config, mesh: RadarMesh, n_trials: int = 3,
                        **pipeline_kw) -> dict:
    """Measure both Doppler-output layouts on THIS mesh and pick the winner:
    row-sharded (each rank detects its own rows) or replicated.

    Runs one step per layout per trial on random planes (the first call
    excluded; best of ``n_trials``), each layout as it will run: where the
    pipelines capture (``graph`` in ``pipeline_kw``, :func:`graph_mode`),
    the first call captures the step and the trials replay it. Returns
    ``{"row_shard": bool, "ms_on": .., "ms_off": .., "pipeline": <the
    winning pipeline>}``
    (``ms_on`` None, and replicated, where the row blocks cannot hold the
    fused detector's centroid window: :func:`rows_fit_window`). Each
    process times its local completion by the small fetch that ends each
    step; over several processes every process takes process 0's decision
    (per-process timings can disagree), so all run the same program. The
    halo kernel's error word is read after the trials."""
    rng = np.random.default_rng(0)
    b = mesh.shape["cpi"]
    ms: dict = {"ms_on": None}
    pipes: dict = {}
    off = ShardedCpiPipeline(config, mesh, row_shard=False, **pipeline_kw)
    rows = -(-off.ambiguity.n_doppler_bins // off.n_pulse_axis)
    layouts = [("ms_off", False, off)]
    if rows_fit_window(off.fused_detector, rows):
        layouts.insert(0, ("ms_on", True, ShardedCpiPipeline(
            config, mesh, row_shard=True, **pipeline_kw)))
    for name, flag, pipe in layouts:
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
    ms["row_shard"] = ms["ms_on"] is not None and ms["ms_on"] <= ms["ms_off"]
    if mesh.process_count > 1:
        ms["row_shard"] = bool(distributed.broadcast_object(ms["row_shard"]))
    ms["pipeline"] = pipes[ms["row_shard"]]
    return ms
