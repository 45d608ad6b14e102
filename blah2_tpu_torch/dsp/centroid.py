"""Detection centroiding, duplicate suppression (counterpart of
``blah2_tpu/dsp/centroid.py``).

Keeps a detection iff no higher-SNR detection lies within a window of
±n_delay bins × ±(n_doppler · doppler_resolution) Hz — the reference's O(n²)
pairwise scan (`src/process/detection/Centroid.cpp:34-69`) as one masked
(K × K) comparison over the fixed-capacity detection set.

Intentional divergence, as in the JAX module: the reference stores the
window bounds in uint16, so a detection with delay < n_delay wraps negative
bounds to ~65k and never suppresses its neighbourhood
(`Centroid.cpp:36-38`); the window here is signed. Window comparisons are
strict (>, <) as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from blah2_tpu_torch.dsp.cfar import CfarDetections


class CentroidFilter(nn.Module):
    def __init__(self, n_delay: int, n_doppler: int,
                 doppler_resolution: float):
        super().__init__()
        self.n_delay = int(n_delay)
        self.n_doppler = int(n_doppler)
        self.doppler_resolution = float(doppler_resolution)

    def forward(self, det: CfarDetections) -> CfarDetections:
        delay, doppler, snr, valid = det.delay, det.doppler, det.snr, det.valid

        # Window centred on detection i ((int)delay as in Centroid.cpp:36).
        d_int = torch.floor(delay)
        d_lo = d_int - self.n_delay
        d_hi = d_int + self.n_delay
        f_half = self.n_doppler * self.doppler_resolution
        f_lo = doppler - f_half
        f_hi = doppler + f_half

        close = ((delay[None, :] > d_lo[:, None])
                 & (delay[None, :] < d_hi[:, None])
                 & (doppler[None, :] > f_lo[:, None])
                 & (doppler[None, :] < f_hi[:, None]))
        not_self = ~torch.eye(delay.shape[0], dtype=torch.bool,
                              device=delay.device)
        beaten = close & not_self & valid[None, :] & (
            snr[:, None] < snr[None, :])
        keep = valid & ~torch.any(beaten, dim=1)
        return det._replace(valid=keep,
                            count=torch.sum(keep).to(torch.int32))
