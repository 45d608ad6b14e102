"""The per-CPI processing pipeline (counterpart of
``blah2_tpu/dsp/pipeline.py``).

One CPI runs: wire decode → spectrum → Wiener-Hopf clutter filter →
cross-ambiguity → fused detection (map metrics, CA-CFAR, centroid) →
fixed-capacity extraction → peak interpolation. Every stage runs on
``device``; the caller receives small products (dB map, spectrum,
fixed-capacity detections) as tensors there.

The tracker stays on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from blah2_tpu_torch.config import Config
from blah2_tpu_torch.device import complex_of_parts, resolve_device
from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor, map_metrics
from blah2_tpu_torch.dsp.centroid import CentroidFilter
from blah2_tpu_torch.dsp.cfar import CfarDetections, make_cfar
from blah2_tpu_torch.dsp.clutter_eca import make_clutter_filter
from blah2_tpu_torch.dsp.interpolate import PeakInterpolator
from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser
from blah2_tpu_torch.ops.detect import FusedDetector
from blah2_tpu_torch.ops.pack12 import unpack12_quads, unpack_components


class CpiOutputs(NamedTuple):
    db_map: torch.Tensor        # (n_doppler_bins, n_delay_bins) absolute dB
    noise_power: torch.Tensor   # scalar dB
    max_power: torch.Tensor     # scalar dB (max − noise)
    spectrum_db: torch.Tensor   # (n_spectrum,) dB
    clutter_ok: torch.Tensor    # bool scalar
    detections: Optional[CfarDetections]


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
    detector runs the kernel's plain twin.
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
        device=None,
    ):
        super().__init__()
        self.device = device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        cap, proc = config.capture, config.process
        self.n_samples = n = config.n_samples
        if spectrum_bandwidth is None:
            spectrum_bandwidth = proc.spectrum.bandwidth
        if int(proc.spectrum.n_sub or 1) > 1:
            raise NotImplementedError(
                "process.spectrum.nSub > 1 (sub-CPI spectra) is not ported to "
                "blah2_tpu_torch yet (ROADMAP.md queue 1: 'call_staged and "
                "sub-CPI spectra')")

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
            if self.fused_detect:
                self.fused_detector = FusedDetector.from_config(
                    proc, amb, max_detections=max_detections, device=device)

    # -- the pipeline on complex samples ---------------------------------
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> CpiOutputs:
        """One CPI from complex reference ``x`` and surveillance ``y`` that
        already lie on ``self.device``."""
        spec_db = SpectrumAnalyser.to_db(self.spectrum(x))
        z, clutter_ok = self.cross_map(x, y)
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
        return CpiOutputs(db_map=db, noise_power=noise, max_power=max_power,
                          spectrum_db=spec_db, clutter_ok=clutter_ok,
                          detections=det)

    def cross_map(self, x: torch.Tensor, y: torch.Tensor):
        """The complex cross-ambiguity map of one CPI after the clutter
        filter, and the filter's success flag (stages 3 and 4 of
        ``forward``)."""
        if self.clutter is not None:
            y, clutter_ok = self.clutter(x, y)
        else:
            clutter_ok = torch.ones((), dtype=torch.bool, device=self.device)
        return self.ambiguity(x, y), clutter_ok

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

    def __call__(self, x, y) -> CpiOutputs:
        """One CPI from complex IQ arrays or (n, 2) planes, NumPy or torch."""
        return super().__call__(self._complex(x), self._complex(y))

    def call_quad(self, quads) -> CpiOutputs:
        """One CPI from interleaved (n, 4) int16 [i1,q1,i2,q2] samples (the
        SDR/replay record layout), moved to the device in one copy."""
        q = self._tensor(quads)
        if q.dim() != 2 or q.shape[1] != 4:
            raise ValueError(f"call_quad expects (n, 4) samples, got shape "
                             f"{tuple(q.shape)}")
        return super().__call__(
            complex_of_parts(q[:, 0], q[:, 1], self.dtype),
            complex_of_parts(q[:, 2], q[:, 3], self.dtype))

    def call_quad12(self, packed) -> CpiOutputs:
        """One CPI from a packed-12-bit quad buffer (``pack12_quads`` of the
        (n, 4) int16 quads): 6 bytes a sample instead of 8."""
        return super().__call__(*self.decode_quad12(packed))

    def decode_quad12(self, packed):
        """Complex ``(x, y)`` on ``self.device`` from a packed-12-bit quad
        buffer: the wire decode of :meth:`call_quad12`."""
        xr, xi, yr, yi = unpack12_quads(self._tensor(packed), self.n_samples)
        return (complex_of_parts(xr, xi, self.dtype),
                complex_of_parts(yr, yi, self.dtype))

    def call_chunks(self, x_chunks, y_chunks) -> CpiOutputs:
        """One CPI delivered as equal-size chunks per channel: packed-12
        uint8 chunks or (c, 2) plane chunks, concatenated on the device."""
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
