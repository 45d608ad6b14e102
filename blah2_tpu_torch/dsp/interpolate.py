"""Quadratic (3-point parabolic) peak interpolation in delay and Doppler
(counterpart of ``blah2_tpu/dsp/interpolate.py``).

Parity with reference `src/process/detection/Interpolate.{h,cpp}`:
  - interpolates on the dB-minus-noise map;
  - a detection on the map boundary, or whose cell is not a local SNR peak
    against its two neighbours, is dropped (`Interpolate.cpp:43-82`);
  - peak offset δ = (s₀−s₂)/(2(s₀−2s₁+s₂)), interpolated SNR
    s₁ − (s₀−s₂)·δ/4; the Doppler offset is scaled by the Doppler resolution.

Intentional divergence, as in the JAX module: the reference's Doppler branch
stores its SNR into the delay SNR variable (`Interpolate.cpp:77`); both are
kept here and the reported SNR is max(snr_delay, snr_doppler, snr_original)
(`Interpolate.cpp:85`). A flat 3-point neighbourhood gives δ = 0, not inf.
"""

from __future__ import annotations

import torch
from torch import nn

from blah2_tpu_torch.dsp.cfar import CfarDetections


class PeakInterpolator(nn.Module):
    def __init__(self, do_delay: bool, do_doppler: bool,
                 doppler_resolution: float, n_rows: int, n_cols: int):
        super().__init__()
        self.do_delay = bool(do_delay)
        self.do_doppler = bool(do_doppler)
        self.doppler_resolution = float(doppler_resolution)
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)

    @staticmethod
    def _parabolic(s0, s1, s2):
        den = 2.0 * (s0 - 2.0 * s1 + s2)
        delta = torch.where(den != 0.0, (s0 - s2) / den, 0.0)
        snr = s1 - ((s0 - s2) * delta) / 4.0
        return delta, snr

    def forward(self, det: CfarDetections,
                db_rel: torch.Tensor) -> CfarDetections:
        """Interpolate detections on the dB-minus-noise map ``db_rel``."""
        r, c = det.row, det.col
        delay, doppler, snr, valid = det.delay, det.doppler, det.snr, det.valid
        new_delay, new_doppler = delay, doppler
        snr_delay = snr_doppler = snr

        if self.do_delay:
            cm = torch.clamp(c - 1, 0, self.n_cols - 1)
            cp = torch.clamp(c + 1, 0, self.n_cols - 1)
            s0, s1, s2 = db_rel[r, cm], db_rel[r, c], db_rel[r, cp]
            boundary = (c == 0) | (c == self.n_cols - 1)
            not_peak = (s1 < s0) | (s1 < s2)
            delta, snr_delay = self._parabolic(s0, s1, s2)
            new_delay = delay + delta
            valid = valid & ~boundary & ~not_peak

        if self.do_doppler:
            rm = torch.clamp(r - 1, 0, self.n_rows - 1)
            rp = torch.clamp(r + 1, 0, self.n_rows - 1)
            s0, s1, s2 = db_rel[rm, c], db_rel[r, c], db_rel[rp, c]
            boundary = (r == 0) | (r == self.n_rows - 1)
            not_peak = (s1 < s0) | (s1 < s2)
            delta, snr_doppler = self._parabolic(s0, s1, s2)
            new_doppler = doppler + self.doppler_resolution * delta
            valid = valid & ~boundary & ~not_peak

        new_snr = torch.maximum(torch.maximum(snr_delay, snr_doppler), snr)
        return det._replace(
            delay=new_delay,
            doppler=new_doppler,
            snr=new_snr,
            valid=valid,
            count=torch.sum(valid).to(torch.int32),
        )
