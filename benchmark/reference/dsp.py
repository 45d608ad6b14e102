"""Upstream blah2's per-CPI products, written plainly in float64.

From the two channels' samples of one CPI and the deployment's YAML:

  - Wiener-Hopf clutter filter (`WienerHopf.cpp`): the reference channel
    shifted circularly by the lag window's start; circular auto- and
    cross-correlations at ``delayMax - delayMin`` lags; the Hermitian
    Toeplitz system solved by Cholesky (a failed solve leaves the CPI
    unfiltered, `blah2.cpp:268-275`); the filter's linear convolution with
    the shifted reference, first n samples, subtracted.
  - Cross-ambiguity by the batches algorithm (`Ambiguity.cpp`): the CPI cut
    into one pulse per Doppler bin, a linear cross-correlation per pulse,
    the delay window's lags, a DFT across pulses in fftshift order.
  - Map metrics (`Map.cpp:188-206`): dB = 10 log10 |z|, noise the mean dB,
    maxPower = max(0, max dB) - noise; the served map is dB - noise.
  - CA-CFAR across delay per Doppler row (`CfarDetector1D.cpp`), with its
    k > 0 quirk on the left train cells; centroid suppression over the hit
    list (`Centroid.cpp`, the window signed); 3-point interpolation in delay
    and Doppler (`Interpolate.cpp`), the SNR the largest of the three.

``q`` is applied to every stage's output: the identity for the reference,
:func:`bf16` for the control (the same arithmetic with every intermediate
stored in bfloat16, the precision below the port's complex64).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0


@dataclasses.dataclass
class Geometry:
    """The sizes one deployment's YAML fixes (upstream key names)."""
    fs: int
    fc: int
    cpi_cfg: float
    n: int
    delay_min: int
    delay_max: int
    doppler_middle: float
    clutter: bool
    clutter_min: int
    clutter_max: int
    pfa: float
    n_guard: int
    n_train: int
    min_delay: int
    min_doppler: float
    n_centroid: int
    tracker: bool
    m: int
    n_of: int
    max_acc: float
    n_delete: int
    doppler_max: float
    nd: int = 0
    nc: int = 0
    half: int = 0
    cpi: float = 0.0
    res: float = 0.0

    def __post_init__(self):
        # Doppler bins: a symmetric walk at the resolution fs / n; pulses of
        # n // nd samples; the map's CPI and resolution follow from them.
        resolution = self.fs / self.n
        k = 1
        while self.doppler_middle + k * resolution <= self.doppler_max:
            k += 1
        self.half = k - 1
        self.nd = 2 * self.half + 1
        self.nc = self.n // self.nd
        self.cpi = self.nc * self.nd / self.fs
        self.res = 1.0 / self.cpi

    @property
    def delay_axis(self) -> np.ndarray:
        return np.arange(self.delay_min, self.delay_max + 1)

    @property
    def doppler_axis(self) -> np.ndarray:
        return self.doppler_middle + self.res * np.arange(
            -self.half, self.half + 1, dtype=np.float64)

    @property
    def km_per_bin(self) -> float:
        return SPEED_OF_LIGHT / self.fs / 1000.0

    @property
    def range_res(self) -> float:
        return SPEED_OF_LIGHT / self.fs

    @property
    def wavelength(self) -> float:
        return SPEED_OF_LIGHT / self.fc


def geometry(doc: dict) -> Geometry:
    """The geometry of an upstream YAML document."""
    cap, proc = doc["capture"], doc["process"]
    amb, clu = proc["ambiguity"], proc["clutter"]
    det, trk = proc["detection"], proc["tracker"]
    fs = int(cap["fs"])
    cpi = float(proc["data"]["cpi"])
    return Geometry(
        fs=fs, fc=int(cap["fc"]), cpi_cfg=cpi, n=int(fs * cpi),
        delay_min=int(amb["delayMin"]), delay_max=int(amb["delayMax"]),
        doppler_middle=(float(amb["dopplerMin"])
                        + float(amb["dopplerMax"])) / 2.0,
        doppler_max=float(amb["dopplerMax"]),
        clutter=bool(clu["enable"]), clutter_min=int(clu["delayMin"]),
        clutter_max=int(clu["delayMax"]),
        pfa=float(det["pfa"]), n_guard=int(det["nGuard"]),
        n_train=int(det["nTrain"]), min_delay=int(det["minDelay"]),
        min_doppler=float(det["minDoppler"]),
        n_centroid=int(det["nCentroid"]),
        tracker=bool(trk["enable"]), m=int(trk["initiate"]["M"]),
        n_of=int(trk["initiate"]["N"]),
        max_acc=float(trk["initiate"]["maxAcc"]),
        n_delete=int(trk["delete"]))


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (each part of a complex tensor), in its own
    dtype."""
    if t.is_complex():
        return torch.complex(bf16(t.real), bf16(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


def _pow2(v: int) -> int:
    return 1 << (int(v) - 1).bit_length()


def clutter_filter(x, y, g: Geometry, q: Callable = identity):
    """(filtered y, solve succeeded) of one CPI (complex128 tensors)."""
    n, nb, s = g.n, g.clutter_max - g.clutter_min, g.clutter_min
    x, y = x[:n], y[:n]
    xs = torch.roll(x, s)
    xf = q(torch.fft.fft(xs))
    yf = q(torch.fft.fft(y))
    a = torch.conj(q(torch.fft.ifft(xf * torch.conj(xf)))[:nb])
    b = q(torch.fft.ifft(yf * torch.conj(xf)))[:nb]
    i = torch.arange(nb, device=x.device)
    d = i[None, :] - i[:, None]
    mat = torch.where(d >= 0, a[d.clamp(min=0)],
                      torch.conj(a[(-d).clamp(min=0)]))
    chol, info = torch.linalg.cholesky_ex(mat)
    if int(info) != 0:
        return y, False
    w = q(torch.cholesky_solve(b[:, None], chol)[:, 0])
    if not bool(torch.all(torch.isfinite(w))):
        return y, False
    m = _pow2(n + nb - 1)
    filt = q(torch.fft.ifft(torch.fft.fft(w, m) * torch.fft.fft(xs, m))[:n])
    return q(y - filt), True


def ambiguity(x, y, g: Geometry, q: Callable = identity):
    """The complex (nd, n_delay) delay-Doppler map, rows in Doppler order."""
    nd, nc = g.nd, g.nc
    x, y = x[:nd * nc], y[:nd * nc]
    if g.doppler_middle != 0.0:
        t = torch.arange(nd * nc, device=x.device, dtype=torch.float64) / g.fs
        x = x * torch.exp(2j * math.pi * g.doppler_middle * t)
    m = _pow2(2 * nc - 1)
    xf = q(torch.fft.fft(x.reshape(nd, nc), n=m, dim=1))
    yf = q(torch.fft.fft(y.reshape(nd, nc), n=m, dim=1))
    corr = q(torch.fft.ifft(yf * torch.conj(xf), dim=1))
    lags = torch.arange(g.delay_min, g.delay_max + 1, device=x.device) % m
    return q(torch.fft.fftshift(torch.fft.fft(corr[:, lags], dim=0), dim=0))


@dataclasses.dataclass
class Cpi:
    """The reference's products of one CPI, and what the detection margins
    are read from (host arrays, float64)."""
    db_rel: np.ndarray        # the served map: dB - noise
    noise: float
    max_power: float
    power: np.ndarray         # |z|^2
    threshold: np.ndarray     # CFAR threshold on power (inf: no train cell)
    cell_ok: np.ndarray       # row and column kept by the geometry
    hit: np.ndarray
    detections: np.ndarray    # (k, 3): delay bins, Doppler Hz, SNR dB
    cells: list               # (row, col) of each detection
    clutter_ok: bool


def cfar(power: np.ndarray, g: Geometry):
    """(threshold, cell_ok) of CA-CFAR across delay on ``power``."""
    nr, ncol = power.shape
    train = np.zeros_like(power)
    cnt = np.zeros(ncol)
    cols = np.arange(ncol)
    for o in range(g.n_guard + 1, g.n_guard + g.n_train + 1):
        left = cols - o > 0                 # upstream's k > 0 quirk
        right = cols + o < ncol
        train[:, left] += power[:, cols[left] - o]
        train[:, right] += power[:, cols[right] + o]
        cnt += left
        cnt += right
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = cnt * (g.pfa ** (-1.0 / np.maximum(cnt, 1)) - 1.0)
        scale = np.where(cnt > 0, alpha / np.maximum(cnt, 1), np.inf)
    thr = scale[None, :] * train
    thr[:, cnt == 0] = np.inf
    row_ok = np.abs(g.doppler_axis) >= g.min_doppler
    col_ok = g.delay_axis >= g.min_delay
    return thr, row_ok[:, None] & col_ok[None, :]


def _window(g: Geometry):
    """Half-extents of the centroid window in columns and rows: |delay|
    strictly under nCentroid bins, |Doppler| strictly under nCentroid / tCpi
    Hz (the configured CPI, `blah2.cpp:186`)."""
    wc = g.n_centroid - 1
    bound = g.n_centroid / g.cpi_cfg
    wr = int(math.ceil(bound / g.res - 1e-9)) - 1
    return wc, wr


def centroid_margin(db_rel, hit, r, c, g: Geometry) -> float:
    """SNR of cell (r, c) less the best SNR of another hit in its window
    (inf where there is none): it survives centroiding iff this is >= 0."""
    wc, wr = _window(g)
    r0, r1 = max(0, r - wr), min(hit.shape[0], r + wr + 1)
    c0, c1 = max(0, c - wc), min(hit.shape[1], c + wc + 1)
    win = np.where(hit[r0:r1, c0:c1], db_rel[r0:r1, c0:c1], -np.inf)
    win[r - r0, c - c0] = -np.inf
    best = win.max()
    return math.inf if best == -np.inf else float(db_rel[r, c] - best)


def interpolate(db_rel, r, c, g: Geometry) -> Optional[tuple]:
    """(delay bins, Doppler Hz, SNR) of a kept cell, or None where it lies on
    the map's edge or is not a peak of its delay or Doppler neighbours."""
    nr, ncol = db_rel.shape
    if r in (0, nr - 1) or c in (0, ncol - 1):
        return None
    s1 = db_rel[r, c]
    out = []
    for s0, s2 in ((db_rel[r, c - 1], db_rel[r, c + 1]),
                   (db_rel[r - 1, c], db_rel[r + 1, c])):
        if s1 < s0 or s1 < s2:
            return None
        den = 2.0 * (s0 - 2.0 * s1 + s2)
        delta = (s0 - s2) / den if den != 0.0 else 0.0
        out.append((delta, s1 - (s0 - s2) * delta / 4.0))
    (dd, snr_d), (df, snr_f) = out
    return (float(g.delay_axis[c] + dd),
            float(g.doppler_axis[r] + g.res * df),
            float(max(snr_d, snr_f, s1)))


def products(x: np.ndarray, y: np.ndarray, g: Geometry,
             q: Callable = identity, device="cpu") -> Cpi:
    """The reference's products of one CPI of complex samples."""
    xt = torch.from_numpy(np.asarray(x)).to(device, torch.complex128)
    yt = torch.from_numpy(np.asarray(y)).to(device, torch.complex128)
    ok = True
    if g.clutter:
        yt, ok = clutter_filter(xt, yt, g, q)
    z = ambiguity(xt, yt, g, q)
    power = q(z.real * z.real + z.imag * z.imag)
    db = q(5.0 * torch.log10(power)).cpu().numpy()
    power = power.cpu().numpy()
    noise = float(db.mean())
    max_power = max(0.0, float(db.max())) - noise
    db_rel = db - noise
    thr, cell_ok = cfar(power, g)
    hit = (power > thr) & cell_ok
    dets, cells = [], []
    for r, c in zip(*np.nonzero(hit)):
        if centroid_margin(db_rel, hit, r, c, g) < 0.0:
            continue
        d = interpolate(db_rel, r, c, g)
        if d is not None:
            dets.append(d)
            cells.append((int(r), int(c)))
    return Cpi(db_rel=db_rel, noise=noise, max_power=max_power, power=power,
               threshold=thr, cell_ok=cell_ok, hit=hit,
               detections=np.asarray(dets, dtype=np.float64).reshape(-1, 3),
               cells=cells, clutter_ok=ok)


def margins(ref: Cpi, r: int, c: int, g: Geometry) -> dict:
    """Each test that decides whether cell (r, c) is a detection, with its
    margin in dB (>= 0 passes; inf for a test that no rounding can flip)."""
    nr, ncol = ref.db_rel.shape
    inside = 0 <= r < nr and 0 <= c < ncol
    if not inside or not ref.cell_ok[r, c] or r in (0, nr - 1) \
            or c in (0, ncol - 1):
        return {"geometry": -math.inf}
    s = ref.db_rel
    with np.errstate(divide="ignore"):
        cfar_db = float(10.0 * np.log10(ref.power[r, c] / ref.threshold[r, c]))
    return {
        "cfar": cfar_db,
        "centroid": centroid_margin(s, ref.hit, r, c, g),
        "peak_delay": float(min(s[r, c] - s[r, c - 1], s[r, c] - s[r, c + 1])),
        "peak_doppler": float(min(s[r, c] - s[r - 1, c],
                                  s[r, c] - s[r + 1, c])),
    }
