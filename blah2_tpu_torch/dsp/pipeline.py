"""The per-CPI processing pipeline (counterpart of
``blah2_tpu/dsp/pipeline.py``).

One CPI runs: wire decode → spectrum (and sub-CPI spectra when
``process.spectrum.nSub`` > 1) → clutter filter (Wiener-Hopf, ECA-B or
NLMS) → cross-ambiguity → fused detection (map metrics, CA-CFAR, centroid)
→ fixed-capacity extraction → peak interpolation. OS-CFAR runs the unfused
chain (map metrics → OS-CFAR → centroid): the fused kernel computes CA. Every stage runs on
``device``; the caller receives small products (dB map, spectrum,
fixed-capacity detections) as tensors there. ``call_staged`` runs the same
CPI as four stages, each waited for, so that the runtime can time them
under the reference's stage names.

On a card each entry (``__call__``, ``call_quad``, ``call_quad12``,
``call_chunks``) is captured as a CUDA graph the first time it meets a new
input layout (``dsp/graph.py``): the counterpart of the JAX package's
per-layout ``jax.jit`` programs and per-chunk-count cache
(``blah2_tpu/dsp/pipeline.py:205-226,339-361``). ``graph=False`` keeps the
eager path; ``call_staged`` is always eager.

``stage_marks``, where the runtime sets it (``runtime/spans.py``
``StageMarks``), marks the start of each entry's body (mark 0) and the
boundaries of the fused CPI's four stages in ``forward`` (marks 1-5):
spectrum | clutter filter | ambiguity | detection. On a card its marks are
timing CUDA events that a capture turns into event-record nodes of the
graph.

The tracker stays on the host, as in the JAX package.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from blah2_tpu_torch.config import Config
from blah2_tpu_torch.device import complex_of_parts, resolve_device
from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor, map_metrics
from blah2_tpu_torch.dsp.centroid import CentroidFilter
from blah2_tpu_torch.dsp.cfar import CfarDetections, CfarDetector, make_cfar
from blah2_tpu_torch.dsp.clutter_eca import make_clutter_filter
from blah2_tpu_torch.dsp.graph import StaticCall, as_tensor
from blah2_tpu_torch.dsp.interpolate import PeakInterpolator
from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser
from blah2_tpu_torch.ops.detect import FusedDetector
from blah2_tpu_torch.ops.pack12 import unpack12_quads, unpack_components


#: host plane dtype -> torch dtype (``CpiPipeline.to_planes`` on tensors).
_TORCH_REAL = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}


class CpiOutputs(NamedTuple):
    db_map: torch.Tensor        # (n_doppler_bins, n_delay_bins) absolute dB
    noise_power: torch.Tensor   # scalar dB
    max_power: torch.Tensor     # scalar dB (max − noise)
    spectrum_db: torch.Tensor   # (n_spectrum,) dB
    clutter_ok: torch.Tensor    # bool scalar
    detections: Optional[CfarDetections]
    # Sub-CPI spectra (process.spectrum.nSub > 1): (k, n_spectrum) dB,
    # None when disabled.
    sub_spectra_db: Optional[torch.Tensor] = None


def _empty_detections(device) -> CfarDetections:
    z = torch.zeros((0,), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int64, device=device)
    return CfarDetections(
        row=zi, col=zi, delay=z, doppler=z, snr=z,
        valid=torch.zeros((0,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


class CpiPipeline(nn.Module):
    """The full CPI processor for one config, on one device.

    ``fused_detect``: "auto" takes the fused detector on a CUDA device (its
    CUDA kernel) and the unfused chain (map metrics → CFAR → centroid)
    elsewhere; True or False choose explicitly. On the CPU the fused
    detector runs the kernel's plain twin. The fused detector computes
    CA-CFAR, so a config with ``cfar: os`` runs the unfused chain whatever
    ``fused_detect`` says.

    ``graph``: "auto" captures each entry as a CUDA graph on a card and
    runs eagerly elsewhere; False runs eagerly everywhere; True asks for
    graphs and raises on the CPU. The first call of an entry with a new
    input layout runs it eagerly on the graph's static buffers, returns
    those products and captures the graph; later calls copy their inputs
    into the buffers and replay it. ``graphs`` holds the captured entries
    (:class:`~blah2_tpu_torch.dsp.graph.StaticCall`) by (entry, layout).
    ``before_capture``, where set, is called before each capture (the
    runtime drains its other device thread there: a capture in the global
    mode forbids other threads' unsafe CUDA calls).
    """

    def __init__(
        self,
        config: Config,
        max_detections: int = 128,
        dtype: torch.dtype = torch.complex64,
        spectrum_bandwidth: Optional[float] = None,
        diag_load: float = 0.0,
        clutter_mode: str = "circular",
        fused_detect: "str | bool" = "auto",
        graph: "str | bool" = "auto",
        device=None,
    ):
        super().__init__()
        self.device = device = resolve_device(device)
        if graph == "auto":
            graph = device.type == "cuda"
        elif graph and device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device: CUDA graphs "
                             f"do not run on {device}")
        self.graph = bool(graph)
        self.graphs: dict = {}
        self.before_capture = None
        self.stage_marks = None
        self.config = config
        self.dtype = dtype
        cap, proc = config.capture, config.process
        self.n_samples = n = config.n_samples
        if spectrum_bandwidth is None:
            spectrum_bandwidth = proc.spectrum.bandwidth
        self._plane_dtype = np.float64 if dtype == torch.complex128 \
            else np.float32

        self.ambiguity = AmbiguityProcessor(
            proc.ambiguity.delay_min, proc.ambiguity.delay_max,
            proc.ambiguity.doppler_min, proc.ambiguity.doppler_max,
            cap.fs, n, round_hamming=True, dtype=dtype, device=device)
        self.clutter = None
        if proc.clutter.enable:
            self.clutter = make_clutter_filter(
                proc.clutter, n, dtype=dtype, mode=clutter_mode,
                diag_load=diag_load, device=device)
        self.spectrum = SpectrumAnalyser(n, spectrum_bandwidth, cap.fc,
                                         dtype=dtype, device=device)
        # Sub-CPI spectra: k segments of n//k samples. The sub analyser's
        # bin count and offset parity are pinned to the full-CPI
        # analyser's, so every waterfall row shares the one emitted
        # frequency axis (at n = 1.5e6 and nSub = 4 a free-running sub
        # geometry gives 2005 bins against 2000).
        self.spectrum_sub = None
        self.n_spectrum_sub = int(proc.spectrum.n_sub or 1)
        if self.n_spectrum_sub > 1:
            n_seg = n // self.n_spectrum_sub
            if n_seg < 2 * self.spectrum.n_spectrum:
                raise ValueError(
                    f"process.spectrum.nSub={self.n_spectrum_sub} leaves "
                    f"segments of {n_seg} samples — need at least "
                    f"2x{self.spectrum.n_spectrum} for the shared "
                    f"spectrum-bin geometry")
            self.spectrum_sub = SpectrumAnalyser(
                n_seg, spectrum_bandwidth, cap.fc, dtype=dtype,
                n_spectrum=self.spectrum.n_spectrum,
                offset_even=self.spectrum.decimation % 2 == 0, device=device)

        self.detection_enabled = proc.detection.enable
        if fused_detect == "auto":
            fused_detect = device.type == "cuda"
        self.fused_detect = bool(fused_detect)
        self.cfar = self.centroid = self.interpolate = None
        self.fused_detector = None
        if self.detection_enabled:
            amb = self.ambiguity
            self.cfar = make_cfar(
                proc.detection, amb.delay_axis, amb.doppler_axis,
                max_detections=max_detections, device=device)
            # Centroid Doppler window uses the configured CPI (1/tCpi), as
            # in `src/blah2.cpp:186`; interpolation uses the map's true-CPI
            # Doppler resolution.
            self.centroid = CentroidFilter(
                proc.detection.n_centroid, proc.detection.n_centroid,
                1.0 / proc.data.cpi)
            self.interpolate = PeakInterpolator(
                True, True, amb.doppler_resolution, amb.n_doppler_bins,
                amb.n_delay_bins)
            if self.fused_detect and isinstance(self.cfar, CfarDetector):
                self.fused_detector = FusedDetector.from_config(
                    proc, amb, max_detections=max_detections, device=device)

    # -- the pipeline on complex samples ---------------------------------
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> CpiOutputs:
        """One CPI from complex reference ``x`` and surveillance ``y`` that
        already lie on ``self.device``."""
        self._mark(1)
        spec_db = SpectrumAnalyser.to_db(self.spectrum(x))
        sub_db = None if self.spectrum_sub is None \
            else self._sub_spectra_db(x)
        self._mark(2)
        z, clutter_ok = self.cross_map(x, y)
        self._mark(4)
        if not self.detection_enabled:
            db, noise, max_power = map_metrics(z)
            det = _empty_detections(self.device)
        elif self.fused_detector is not None:
            db, noise, max_power, det = self.fused_detector(z)
            det = self.interpolate(det, db - noise)
        else:
            db, noise, max_power = map_metrics(z)
            det = self.centroid(self.cfar(z, noise))
            det = self.interpolate(det, db - noise)
        self._mark(5)
        return CpiOutputs(db_map=db, noise_power=noise, max_power=max_power,
                          spectrum_db=spec_db, clutter_ok=clutter_ok,
                          detections=det, sub_spectra_db=sub_db)

    def _mark(self, i: int) -> None:
        if self.stage_marks is not None:
            self.stage_marks.mark(i)

    def _sub_spectra_db(self, x: torch.Tensor) -> torch.Tensor:
        """(k, n_spectrum) dB sub-CPI spectra of the complex CPI: one
        batched call of the sub analyser over the k segments."""
        k, n_seg = self.n_spectrum_sub, self.spectrum_sub.n_samples
        return SpectrumAnalyser.to_db(
            self.spectrum_sub(x[: k * n_seg].reshape(k, n_seg)))

    def cross_map(self, x: torch.Tensor, y: torch.Tensor):
        """The complex cross-ambiguity map of one CPI after the clutter
        filter, and the filter's success flag (stages 3 and 4 of
        ``forward``)."""
        if self.clutter is not None:
            y, clutter_ok = self.clutter(x, y)
        else:
            clutter_ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._mark(3)
        return self.ambiguity(x, y), clutter_ok

    # -- staged mode: the CPI as four stages the runtime times under the
    # reference's keys (spectrum / clutter_filter / ambiguity_processing /
    # detector, `src/blah2.cpp:261-337`); intermediates stay on the device.
    def stage_spectrum(self, xp) -> torch.Tensor:
        return SpectrumAnalyser.to_db(self.spectrum(self._complex(xp)))

    def stage_clutter(self, xp, yp):
        x, y = self._complex(xp), self._complex(yp)
        if self.clutter is None:
            return x, y, torch.ones((), dtype=torch.bool, device=self.device)
        y2, ok = self.clutter(x, y)
        return x, y2, ok

    def stage_ambiguity(self, x: torch.Tensor, y: torch.Tensor):
        z = self.ambiguity(x, y)
        db, noise, max_power = map_metrics(z)
        return z, db, noise, max_power

    def stage_detect(self, z: torch.Tensor, db: torch.Tensor,
                     noise: torch.Tensor) -> CfarDetections:
        if not self.detection_enabled:
            return _empty_detections(self.device)
        if self.fused_detector is not None:
            # Time the production path: the fused detector (its kernel on
            # a card), map metrics recomputed inside it as in the fused CPI.
            db_f, noise_f, _, det = self.fused_detector(z)
            return self.interpolate(det, db_f - noise_f)
        det = self.centroid(self.cfar(z, noise))
        return self.interpolate(det, db - noise)

    @property
    def sub_spectra_fn(self):
        """(k, n_spectrum) dB sub-CPI spectra of one CPI's planes, or None
        when ``nSub`` is 1 (staged samples compute them outside their timed
        stages; the fused CPI computes them inline)."""
        if self.spectrum_sub is None:
            return None
        return lambda xp: self._sub_spectra_db(self._complex(xp))

    def call_staged(self, x, y, timer=None) -> CpiOutputs:
        """Run the CPI as four stages, each one waited for before
        ``timer.stage`` (a ``StageTimer``) records it under the reference
        names. The products equal the fused call's but for
        ``sub_spectra_db``, which stays None here."""
        on_card = self.device.type == "cuda"

        def mark(name):
            # A mark that did not wait would time the enqueue, not the
            # stage: eager PyTorch returns before the card has finished.
            if timer is not None:
                if on_card:
                    torch.cuda.synchronize(self.device)
                timer.stage(name)

        xp = self._tensor(self.to_planes(x, self._plane_dtype))
        yp = self._tensor(self.to_planes(y, self._plane_dtype))
        spec_db = self.stage_spectrum(xp)
        mark("spectrum")
        xc, yc, clutter_ok = self.stage_clutter(xp, yp)
        mark("clutter_filter")
        z, db, noise, max_power = self.stage_ambiguity(xc, yc)
        mark("ambiguity_processing")
        det = self.stage_detect(z, db, noise)
        mark("detector")
        return CpiOutputs(db_map=db, noise_power=noise, max_power=max_power,
                          spectrum_db=spec_db, clutter_ok=clutter_ok,
                          detections=det)

    @staticmethod
    def to_planes(x, plane_dtype=np.float32):
        """Complex samples as (n, 2) real/imag planes of ``plane_dtype``
        (zero-copy for complex64 NumPy at float32). Integer planes (ADC
        counts) pass through: they widen on the device."""
        if isinstance(x, torch.Tensor):
            if x.is_complex():
                x = torch.view_as_real(x)
            elif not x.is_floating_point():
                return x
            return x.to(_TORCH_REAL[np.dtype(plane_dtype)])
        x = np.asarray(x)
        if x.dtype == np.complex64 and plane_dtype == np.float32:
            return np.ascontiguousarray(x).view(np.float32).reshape(-1, 2)
        if np.iscomplexobj(x):
            return np.stack([x.real, x.imag], axis=-1).astype(plane_dtype)
        if np.issubdtype(x.dtype, np.integer):
            return x
        return x.astype(plane_dtype, copy=False)

    # -- entries -----------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        """A NumPy array or tensor on ``self.device``."""
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _complex(self, a) -> torch.Tensor:
        """Complex samples, or (n, 2) real/imag planes (int or float),
        as the working complex dtype on ``self.device``."""
        t = self._tensor(a)
        if t.is_complex():
            return t.to(self.dtype)
        if t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"expected complex samples or (n, 2) planes, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")
        return complex_of_parts(t[:, 0], t[:, 1], self.dtype)

    def _entry(self, name: str, body, inputs) -> CpiOutputs:
        """``body(*inputs)``: eagerly, or through the CUDA graph of
        (``name``, the inputs' layout), captured at its first call."""
        if not self.graph:
            return body(*inputs)
        inputs = [as_tensor(a) for a in inputs]
        key = (name, tuple((tuple(t.shape), t.dtype) for t in inputs))
        call = self.graphs.get(key)
        if call is not None:
            return call(*inputs)
        if self.before_capture is not None:
            self.before_capture()
        call = StaticCall(body, inputs, self.device, name=name)
        out = call.capture(*inputs)
        self.graphs[key] = call
        return out

    def __call__(self, x, y) -> CpiOutputs:
        """One CPI from complex IQ arrays or (n, 2) planes, NumPy or torch."""
        return self._entry("planes", self.run_planes, (x, y))

    def run_planes(self, x, y) -> CpiOutputs:
        """The eager body of :meth:`__call__`."""
        self._mark(0)
        return super().__call__(self._complex(x), self._complex(y))

    def call_quad(self, quads) -> CpiOutputs:
        """One CPI from interleaved (n, 4) int16 [i1,q1,i2,q2] samples (the
        SDR/replay record layout), moved to the device in one copy."""
        shape = tuple(np.shape(quads))
        if len(shape) != 2 or shape[1] != 4:
            raise ValueError(f"call_quad expects (n, 4) samples, got shape "
                             f"{shape}")
        return self._entry("quad", self.run_quad, (quads,))

    def run_quad(self, quads) -> CpiOutputs:
        """The eager body of :meth:`call_quad`."""
        self._mark(0)
        q = self._tensor(quads)
        return super().__call__(
            complex_of_parts(q[:, 0], q[:, 1], self.dtype),
            complex_of_parts(q[:, 2], q[:, 3], self.dtype))

    def call_quad12(self, packed) -> CpiOutputs:
        """One CPI from a packed-12-bit quad buffer (``pack12_quads`` of the
        (n, 4) int16 quads): 6 bytes a sample instead of 8."""
        return self._entry("quad12", self.run_quad12, (packed,))

    def run_quad12(self, packed) -> CpiOutputs:
        """The eager body of :meth:`call_quad12`."""
        self._mark(0)
        return super().__call__(*self.decode_quad12(packed))

    def decode_quad12(self, packed):
        """Complex ``(x, y)`` on ``self.device`` from a packed-12-bit quad
        buffer: the wire decode of :meth:`call_quad12`."""
        xr, xi, yr, yi = unpack12_quads(self._tensor(packed), self.n_samples)
        return (complex_of_parts(xr, xi, self.dtype),
                complex_of_parts(yr, yi, self.dtype))

    def call_chunks(self, x_chunks, y_chunks) -> CpiOutputs:
        """One CPI delivered as equal-size chunks per channel: packed-12
        uint8 chunks or (c, 2) plane chunks, concatenated on the device.
        One graph per chunk count and layout."""
        n_x = len(x_chunks)
        # Weakly, as StaticCall holds a bound method: the graph and this
        # pipeline form no cycle.
        run = weakref.WeakMethod(self.run_chunks)
        return self._entry(
            f"chunks{n_x}", lambda *ch: run()(ch[:n_x], ch[n_x:]),
            (*x_chunks, *y_chunks))

    def run_chunks(self, x_chunks, y_chunks) -> CpiOutputs:
        """The eager body of :meth:`call_chunks`."""
        self._mark(0)

        def cat(chunks):
            parts = [unpack_components(self._tensor(ch)) for ch in chunks]
            return complex_of_parts(torch.cat([p[0] for p in parts]),
                                    torch.cat([p[1] for p in parts]),
                                    self.dtype)

        return super().__call__(cat(x_chunks), cat(y_chunks))


def entry(device=None):
    """``(callable, example_args)`` for one CPI at the default config
    (fs 2 MHz, tCpi 0.75 s: 1.5 Msample CPIs, a 301×411 map), with float32
    (n, 2) real/imag planes on ``device`` as the example inputs."""
    pipe = CpiPipeline(Config(), device=device)
    rng = np.random.default_rng(0)
    n = pipe.n_samples
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    return pipe, (x.to(pipe.device), y.to(pipe.device))
