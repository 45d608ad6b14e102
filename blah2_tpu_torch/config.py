"""YAML configuration schema (the port's own copy of ``blah2_tpu/config.py``).

The schema mirrors the reference config exactly (`config/config.yml:1-86` in
the blah2 reference) so that unmodified blah2 config files load unchanged:
sections ``capture`` / ``process`` / ``network`` / ``truth`` / ``location`` /
``save``. Device-specific capture fields vary per SDR (RspDuo / Usrp / HackRF
/ Kraken, parity: `config/config-*.yml`) and are kept as a raw mapping.

The port keeps this copy instead of importing the JAX package's module, so
that ``blah2_tpu_torch`` never loads ``blah2_tpu``; the tests hold the two
copies equal on every file under ``config/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import yaml


@dataclasses.dataclass
class ReplayConfig:
    state: bool = False
    loop: bool = True
    file: str = ""


@dataclasses.dataclass
class CaptureConfig:
    fs: int = 2_000_000
    fc: int = 204_640_000
    device_type: str = "RspDuo"
    device: Dict[str, Any] = dataclasses.field(default_factory=dict)
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)


@dataclasses.dataclass
class AmbiguityConfig:
    delay_min: int = -10
    delay_max: int = 400
    doppler_min: int = -200
    doppler_max: int = 200


@dataclasses.dataclass
class ClutterConfig:
    enable: bool = True
    delay_min: int = -10
    delay_max: int = 400
    # Extensions over the reference schema (`config/config.yml:29-32`):
    # canceller selection ("wiener" = reference algorithm, "eca-b", "nlms"),
    # the ECA-B segment count, and the NLMS adaptation step size.
    filter: str = "wiener"
    n_batches: int = 8
    mu: float = 0.1


@dataclasses.dataclass
class SpectrumConfig:
    # The reference hardcodes the analyser bandwidth to 2 kHz
    # (`src/blah2.cpp:198`); schema extension exposing it.
    bandwidth: float = 2000.0
    #: Sub-CPI spectra (schema extension implementing the reference's
    #: `SpectrumAnalyser.h:6` TODO "create k spectrum plots from
    #: sub-CPIs"): with nSub=k>1 the CPI splits into k equal segments and
    #: the IQ product carries a (k, n_spectrum) `subSpectra` waterfall
    #: alongside the full-CPI spectrum (single-chip and mesh pipelines).
    n_sub: int = 1


@dataclasses.dataclass
class DetectionConfig:
    enable: bool = True
    pfa: float = 1e-5
    n_guard: int = 2
    n_train: int = 6
    min_delay: int = 5
    min_doppler: float = 15.0
    n_centroid: int = 6
    #: CFAR algorithm: "ca" (cell-averaging, the reference's
    #: `CfarDetector1D`) or "os" (ordered-statistics, comparison tier —
    #: robust to interfering targets in the train window).
    cfar: str = "ca"
    #: OS-CFAR order-statistic rank as a fraction of the train count
    #: (Rohling's k = 3N/4 default).
    os_rank: float = 0.75


@dataclasses.dataclass
class TrackerConfig:
    enable: bool = False
    m: int = 3
    n: int = 5
    max_acc: float = 10.0
    n_delete: int = 10
    #: Track smoothing: "none" (reference behavior) or "alpha-beta"
    #: (implements the reference's declared-but-TODO smooth key,
    #: `Tracker.h:7`).
    smooth: str = "none"
    #: alpha-beta gains (schema extension): measurement blend gain on
    #: delay/Doppler, and the Doppler-residual gain on acceleration.
    smooth_alpha: float = 0.5
    smooth_beta: float = 0.25
    #: Kalman smoothing noise model (smooth: kalman, schema extension):
    #: accel random-walk std (Hz/s per CPI) and measurement stds
    #: (delay bins / Hz; Doppler default = 0.3/cpi resolutions).
    kalman_q: float = 0.1
    kalman_r_delay: float = 0.3
    kalman_r_doppler: Optional[float] = None


@dataclasses.dataclass
class ProcessDataConfig:
    cpi: float = 0.75
    buffer: float = 2.0
    overlap: float = 0.0


@dataclasses.dataclass
class ProcessConfig:
    data: ProcessDataConfig = dataclasses.field(default_factory=ProcessDataConfig)
    ambiguity: AmbiguityConfig = dataclasses.field(default_factory=AmbiguityConfig)
    clutter: ClutterConfig = dataclasses.field(default_factory=ClutterConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    spectrum: SpectrumConfig = dataclasses.field(default_factory=SpectrumConfig)


@dataclasses.dataclass
class NetworkConfig:
    ip: str = "0.0.0.0"
    # Port map mirrors `config/config.yml:52-60`.
    api: int = 3000
    map: int = 3001
    detection: int = 3002
    track: int = 3003
    timestamp: int = 4000
    timing: int = 4001
    iqdata: int = 4002
    config: int = 4003


@dataclasses.dataclass
class SaveConfig:
    iq: bool = False
    map: bool = False
    detection: bool = False
    timing: bool = False
    path: str = "./save/"


@dataclasses.dataclass
class Config:
    capture: CaptureConfig = dataclasses.field(default_factory=CaptureConfig)
    process: ProcessConfig = dataclasses.field(default_factory=ProcessConfig)
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    save: SaveConfig = dataclasses.field(default_factory=SaveConfig)
    truth: Dict[str, Any] = dataclasses.field(default_factory=dict)
    location: Dict[str, Any] = dataclasses.field(default_factory=dict)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_samples(self) -> int:
        """Samples per CPI: nSamples = fs * tCpi (reference `src/blah2.cpp:142`)."""
        return int(self.capture.fs * self.process.data.cpi)

    @property
    def buffer_samples(self) -> int:
        """Capture ring size: cpi * buffer * fs (reference `src/blah2.cpp:129-134`)."""
        return int(self.process.data.cpi * self.process.data.buffer * self.capture.fs)


def _get(d: Optional[Dict[str, Any]], *keys: str, default: Any = None) -> Any:
    cur: Any = d
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def config_from_dict(doc: Dict[str, Any]) -> Config:
    """Build a typed Config from a parsed YAML mapping (reference schema)."""
    cfg = Config()
    cfg.raw = doc

    cap = doc.get("capture", {}) or {}
    cfg.capture.fs = int(cap.get("fs", cfg.capture.fs))
    cfg.capture.fc = int(cap.get("fc", cfg.capture.fc))
    device = cap.get("device", {}) or {}
    cfg.capture.device_type = str(device.get("type", cfg.capture.device_type))
    cfg.capture.device = device
    rep = cap.get("replay", {}) or {}
    cfg.capture.replay = ReplayConfig(
        state=bool(rep.get("state", False)),
        loop=bool(rep.get("loop", True)),
        file=str(rep.get("file", "")),
    )

    proc = doc.get("process", {}) or {}
    data = proc.get("data", {}) or {}
    cfg.process.data = ProcessDataConfig(
        cpi=float(data.get("cpi", 0.75)),
        buffer=float(data.get("buffer", 2.0)),
        overlap=float(data.get("overlap", 0.0)),
    )
    amb = proc.get("ambiguity", {}) or {}
    cfg.process.ambiguity = AmbiguityConfig(
        delay_min=int(amb.get("delayMin", -10)),
        delay_max=int(amb.get("delayMax", 400)),
        doppler_min=int(amb.get("dopplerMin", -200)),
        doppler_max=int(amb.get("dopplerMax", 200)),
    )
    clu = proc.get("clutter", {}) or {}
    cfg.process.clutter = ClutterConfig(
        enable=bool(clu.get("enable", True)),
        delay_min=int(clu.get("delayMin", -10)),
        delay_max=int(clu.get("delayMax", 400)),
        filter=str(clu.get("filter", "wiener")),
        n_batches=int(clu.get("nBatches", 8)),
        mu=float(clu.get("mu", 0.1)),
    )
    det = proc.get("detection", {}) or {}
    cfg.process.detection = DetectionConfig(
        enable=bool(det.get("enable", True)),
        pfa=float(det.get("pfa", 1e-5)),
        n_guard=int(det.get("nGuard", 2)),
        n_train=int(det.get("nTrain", 6)),
        min_delay=int(det.get("minDelay", 5)),
        min_doppler=float(det.get("minDoppler", 15.0)),
        n_centroid=int(det.get("nCentroid", 6)),
        cfar=str(det.get("cfar", "ca")),
        os_rank=float(det.get("osRank", 0.75)),
    )
    spec = proc.get("spectrum", {}) or {}
    cfg.process.spectrum = SpectrumConfig(
        bandwidth=float(spec.get("bandwidth", 2000.0)),
        n_sub=int(spec.get("nSub", 1)),
    )
    trk = proc.get("tracker", {}) or {}
    cfg.process.tracker = TrackerConfig(
        enable=bool(trk.get("enable", False)),
        m=int(_get(trk, "initiate", "M", default=3)),
        n=int(_get(trk, "initiate", "N", default=5)),
        max_acc=float(_get(trk, "initiate", "maxAcc", default=10.0)),
        n_delete=int(trk.get("delete", 10)),
        smooth=str(trk.get("smooth", "none")),
        smooth_alpha=float(trk.get("smoothAlpha", 0.5)),
        smooth_beta=float(trk.get("smoothBeta", 0.25)),
        kalman_q=float(trk.get("kalmanQ", 0.1)),
        kalman_r_delay=float(trk.get("kalmanRDelay", 0.3)),
        kalman_r_doppler=(float(trk["kalmanRDoppler"])
                          if "kalmanRDoppler" in trk else None),
    )

    net = doc.get("network", {}) or {}
    ports = net.get("ports", {}) or {}
    cfg.network = NetworkConfig(
        ip=str(net.get("ip", "0.0.0.0")),
        api=int(ports.get("api", 3000)),
        map=int(ports.get("map", 3001)),
        detection=int(ports.get("detection", 3002)),
        track=int(ports.get("track", 3003)),
        timestamp=int(ports.get("timestamp", 4000)),
        timing=int(ports.get("timing", 4001)),
        iqdata=int(ports.get("iqdata", 4002)),
        config=int(ports.get("config", 4003)),
    )

    save = doc.get("save", {}) or {}
    cfg.save = SaveConfig(
        iq=bool(save.get("iq", False)),
        map=bool(save.get("map", False)),
        detection=bool(save.get("detection", False)),
        timing=bool(save.get("timing", False)),
        path=str(save.get("path", "./save/")),
    )

    cfg.truth = doc.get("truth", {}) or {}
    cfg.location = doc.get("location", {}) or {}
    return cfg


def load_config(path: str) -> Config:
    """Load a blah2-format YAML config file."""
    with open(path, "r") as f:
        doc = yaml.safe_load(f)
    return config_from_dict(doc or {})
