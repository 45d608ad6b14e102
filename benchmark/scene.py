"""The seeded scene a cell's traffic replays: ``cpis`` distinct CPIs of the
two channels, as a two-channel 12-bit front end delivers them.

The reference channel is complex Gaussian noise of unit power. The
surveillance channel holds the direct path at ``direct`` times the
reference, zero-Doppler clutter echoes at a few small delays (``clutter``:
[delay bins, amplitude], each with a phase drawn from the seed), the
targets, and receiver noise of ``noise`` relative amplitude. A target
(``delay`` bins, ``doppler`` Hz, ``amplitude``) is a circularly delayed,
Doppler-shifted copy of the reference; with ``move`` its delay advances each
CPI by ``doppler * tCpi * lambda / (c / fs)`` bins, as a target of that
Doppler moves, so the tracker can follow it. Both channels are scaled by
``adc_scale``, rounded and clipped to 12 bits, and handed over as complex64
ADC counts, the form the port's rings hold.

Everything is drawn on ``device`` from one ``torch.Generator`` seeded with
the run's seed, in a few large calls: the same seed gives the same samples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from benchmark.reference.dsp import Geometry

ADC_MAX = 2047


@dataclasses.dataclass
class Scene:
    x: List[np.ndarray]        # per scene CPI: reference channel, complex64
    y: List[np.ndarray]        # per scene CPI: surveillance channel
    truth: List[list]          # per scene CPI: [delay bins, Doppler Hz]


def make(spec: dict, g: Geometry, seed: int, device) -> Scene:
    n, k = g.n, int(spec["cpis"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    shape = (k, n)

    def cnormal(*s):
        parts = torch.randn((2,) + s, generator=gen, device=dev,
                            dtype=torch.float64)
        return torch.complex(parts[0], parts[1]) / math.sqrt(2.0)

    x = cnormal(*shape)
    noise = cnormal(*shape)
    phases = torch.rand((max(1, len(spec["clutter"])),), generator=gen,
                        device=dev, dtype=torch.float64)
    y = spec["direct"] * x + spec["noise"] * noise
    for (delay, amp), ph in zip(spec["clutter"], phases):
        y = y + amp * torch.exp(2j * math.pi * ph) * torch.roll(
            x, int(delay), dims=1)
    xf = torch.fft.fft(x, dim=1)
    nu = torch.fft.fftfreq(n, device=dev, dtype=torch.float64) * n
    t = torch.arange(n, device=dev, dtype=torch.float64) / g.fs
    step = g.cpi_cfg * g.wavelength / g.range_res
    truth = [[] for _ in range(k)]
    for tgt in spec["targets"]:
        f = float(tgt["doppler"])
        d = float(tgt["delay"]) + (step * f * torch.arange(
            k, device=dev, dtype=torch.float64) if spec.get("move")
            else torch.zeros(k, device=dev, dtype=torch.float64))
        delayed = torch.fft.ifft(xf * torch.exp(
            -2j * math.pi * nu[None, :] * d[:, None] / n), dim=1)
        y = y + tgt["amplitude"] * delayed * torch.exp(2j * math.pi * f * t)
        for j, dj in enumerate(d.tolist()):
            truth[j].append([dj, f])

    def adc(v):
        s = float(spec["adc_scale"])
        re = torch.clamp(torch.round(v.real * s), -ADC_MAX, ADC_MAX)
        im = torch.clamp(torch.round(v.imag * s), -ADC_MAX, ADC_MAX)
        return torch.complex(re, im).to(torch.complex64).cpu().numpy()

    xs, ys = adc(x), adc(y)
    return Scene(x=list(xs), y=list(ys), truth=truth)
