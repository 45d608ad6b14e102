"""M-of-N delay-Doppler tracker (host-side).

The tracker is tiny, sequential and stateful, so it runs on the host over the
per-CPI detection products (SURVEY §7.3) rather than on the device.

Parity with reference `src/process/tracker/Tracker.{h,cpp}`:
  - ``process`` = update-then-initiate (`Tracker.cpp:31-50`);
  - kinematic prediction: delay += (doppler·T·λ + ½·a·T²)/rangeRes,
    doppler += a·T (`Tracker.cpp:126-135`), with rangeRes = c/fs and
    λ = c/fc (`src/blah2.cpp:190-192`); golden value: delay 10 bins,
    Doppler −20 Hz, acc 5 Hz/s, T=1 s → delay 9.821, Doppler −15
    (`test/unit/process/tracker/TestTracker.cpp:74-83`);
  - association gate ±1 delay bin, ±(1/cpi) Hz around the *prediction* —
    the reference gates around uninitialized zeros (`Tracker.cpp:59-60,81-84`),
    a known bug flagged in SURVEY §2.1 that we do not replicate;
  - on association: current = detection, acceleration re-estimated as
    Δdoppler/T, nInactive reset, state ASSOCIATED, M-of-N promotion
    (`Tracker.cpp:86-96`);
  - on miss: current = prediction, ACTIVE→COASTING, ASSOCIATED→TENTATIVE,
    nInactive += 1, delete after n_delete misses (`Tracker.cpp:99-123`);
  - initiation: each unassociated detection spawns one TENTATIVE track per
    acceleration hypothesis on the grid ±max_acc at resolution 1/cpi²
    (`Tracker.cpp:17-23,137-160`);
  - smoothing: the reference parses ``tracker.smooth`` from every config
    (`src/blah2.cpp:188`, `config/config.yml:48`) but never implements it
    (`Tracker.h:7` "@todo Add smoothing capability"; `Track.h:11` notes
    current is "used for smoothing output"). Implemented here:
    ``smooth: alpha-beta`` blends each associated measurement with the
    kinematic prediction (gain ``smoothAlpha`` on delay/Doppler) and
    drives the acceleration estimate from the Doppler residual (gain
    ``smoothBeta``) instead of the reference's raw Δdoppler/T
    re-estimate — less jittery tracks from the same detections.
    ``smooth: kalman`` runs a per-track 3-state (delay, doppler,
    acceleration) Kalman filter over the same kinematic model, with
    accel-random-walk process noise ``kalmanQ`` and measurement noise
    ``kalmanRDelay``/``kalmanRDoppler`` — optimal gains that adapt
    through initiation instead of the α-β constants.
    ``smooth: none`` (the reference default) keeps raw measurements.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from blah2_tpu_torch.data.detection import Detection
from blah2_tpu_torch.data.track import TrackState, TrackStore


class Tracker:
    def __init__(
        self,
        m: int,
        n: int,
        n_delete: int,
        cpi: float,
        max_acc_init: float,
        range_res: float,
        wavelength: float,
        smooth: str = "none",
        smooth_alpha: float = 0.5,
        smooth_beta: float = 0.25,
        kalman_q: float = 0.1,
        kalman_r_delay: float = 0.3,
        kalman_r_doppler: Optional[float] = None,
    ):
        self.m = int(m)
        self.n = int(n)
        self.n_delete = int(n_delete)
        self.cpi = float(cpi)
        self.max_acc_init = float(max_acc_init)
        self.range_res = float(range_res)
        self.wavelength = float(wavelength)
        smooth = (smooth or "none").lower().replace("_", "-")
        if smooth in ("alphabeta",):
            smooth = "alpha-beta"
        if smooth not in ("none", "alpha-beta", "kalman"):
            raise ValueError(
                f"tracker.smooth must be 'none', 'alpha-beta' or "
                f"'kalman', got {smooth!r}")
        self.smooth = smooth
        self.smooth_alpha = float(smooth_alpha)
        self.smooth_beta = float(smooth_beta)
        if not 0.0 < self.smooth_alpha <= 1.0:
            raise ValueError("smoothAlpha must be in (0, 1]")
        if not 0.0 <= self.smooth_beta <= 2.0:
            raise ValueError("smoothBeta must be in [0, 2]")
        # Kalman noise model: accel random walk std q (Hz/s per CPI), and
        # measurement stds in delay bins / Hz (Doppler default: a third of
        # the 1/cpi Doppler resolution).
        self.kalman_q = float(kalman_q)
        self.kalman_r_delay = float(kalman_r_delay)
        self.kalman_r_doppler = float(
            kalman_r_doppler if kalman_r_doppler is not None
            else 0.3 / float(cpi))
        if self.smooth == "kalman":
            if self.kalman_q <= 0.0:
                raise ValueError("kalmanQ must be > 0")
            if self.kalman_r_delay <= 0.0 or self.kalman_r_doppler <= 0.0:
                raise ValueError("kalmanRDelay/kalmanRDoppler must be > 0")
        self.timestamp_ms: Optional[int] = None
        self.store = TrackStore()

        # Acceleration hypothesis grid: resolution 1/cpi², span ±max_acc.
        resolution_acc = 1.0 / (self.cpi * self.cpi)
        n_acc = int(self.max_acc_init / resolution_acc)
        self.acc_init = [resolution_acc * (i - n_acc) for i in range(2 * n_acc + 1)]

    def predict(self, current, acceleration: float, t: float):
        """Kinematic prediction of (delay bins, doppler Hz)."""
        delay, doppler = current[0], current[1]
        delay_pred = delay + (
            (doppler * t * self.wavelength) + (0.5 * acceleration * t * t)
        ) / self.range_res
        doppler_pred = doppler + acceleration * t
        return (delay_pred, doppler_pred, 0.0)

    def process(self, detection: Detection, timestamp_ms: int) -> TrackStore:
        used = [False] * detection.n_detections
        if len(self.store) > 0:
            self._update(detection, timestamp_ms, used)
        else:
            self.timestamp_ms = timestamp_ms
        self._initiate(detection, used)
        return self.store

    def _update(self, detection: Detection, timestamp_ms: int, used) -> None:
        prev_ms = timestamp_ms if self.timestamp_ms is None \
            else self.timestamp_ms
        t = (timestamp_ms - prev_ms) / 1000.0
        self.timestamp_ms = timestamp_ms
        gate_doppler = 1.0 / self.cpi

        to_remove = []
        for rec in self.store.tracks:
            prev_doppler = rec.current[1]
            prediction = self.predict(rec.current, rec.acceleration, t)

            associated = None
            for j in range(detection.n_detections):
                if used[j]:
                    continue
                if (
                    abs(detection.delay[j] - prediction[0]) < 1.0
                    and abs(detection.doppler[j] - prediction[1]) < gate_doppler
                ):
                    associated = j
                    break

            if associated is not None:
                j = associated
                meas = (detection.delay[j], detection.doppler[j],
                        detection.snr[j])
                if self.smooth == "alpha-beta" and t > 0:
                    # Blend measurement with the kinematic prediction; the
                    # Doppler residual drives the acceleration estimate
                    # (γ-style) instead of the raw Δdoppler/T re-estimate.
                    r_delay = meas[0] - prediction[0]
                    r_doppler = meas[1] - prediction[1]
                    rec.associate((
                        prediction[0] + self.smooth_alpha * r_delay,
                        prediction[1] + self.smooth_alpha * r_doppler,
                        meas[2]))
                    rec.acceleration += self.smooth_beta * r_doppler / t
                elif self.smooth == "kalman" and t > 0:
                    self._kf_update(rec, meas, prediction, t)
                else:
                    rec.associate(meas)
                    if t > 0:
                        rec.acceleration = \
                            (detection.doppler[j] - prev_doppler) / t
                rec.n_inactive = 0
                rec.states.append(TrackState.ASSOCIATED)
                self.store.promote(rec, self.m, self.n)
                used[j] = True
            else:
                rec.current = prediction
                if self.smooth == "kalman" and rec.kf_p is not None \
                        and t > 0:
                    # Coast: the state propagated through predict();
                    # propagate the covariance too, so the gains stay
                    # consistent after a missed CPI.
                    rec.kf_p = self._kf_predict_cov(rec.kf_p, t)
                if rec.state == TrackState.ACTIVE:
                    rec.states.append(TrackState.COASTING)
                elif rec.state == TrackState.ASSOCIATED:
                    rec.states.append(TrackState.TENTATIVE)
                else:
                    rec.states.append(rec.state)
                rec.n_inactive += 1
                if rec.n_inactive > self.n_delete:
                    to_remove.append(rec)

        for rec in to_remove:
            self.store.remove(rec)

    def _kf_transition(self, t: float) -> np.ndarray:
        """State transition over Δt for x = (delay bins, doppler Hz,
        accel Hz/s) — the linearization of :meth:`predict` (same units,
        including the reference's unscaled ½·a·t² delay term)."""
        rr, lam = self.range_res, self.wavelength
        return np.array([[1.0, t * lam / rr, 0.5 * t * t / rr],
                         [0.0, 1.0, t],
                         [0.0, 0.0, 1.0]])

    def _kf_predict_cov(self, p: np.ndarray, t: float) -> np.ndarray:
        f = self._kf_transition(t)
        g = np.array([0.5 * t * t / self.range_res, t, 1.0])
        q = (self.kalman_q ** 2) * t * np.outer(g, g)
        return f @ p @ f.T + q

    def _kf_update(self, rec, meas, prediction, t: float) -> None:
        """Per-track 3-state Kalman step: covariance predict, gain from
        the innovation covariance, state/accel update. The mean predict
        already happened via :meth:`predict` (shared with the other
        smoothing modes, so the association gate sees the same point)."""
        if rec.kf_p is None:
            # Initiation covariance: measurement-sized position/velocity
            # uncertainty, full acceleration-hypothesis-grid spread.
            rec.kf_p = np.diag([self.kalman_r_delay ** 2,
                                self.kalman_r_doppler ** 2,
                                max(self.max_acc_init, 1e-3) ** 2])
        p = self._kf_predict_cov(rec.kf_p, t)
        x_pred = np.array([prediction[0], prediction[1], rec.acceleration])
        nu = np.array([meas[0] - x_pred[0], meas[1] - x_pred[1]])
        r = np.diag([self.kalman_r_delay ** 2, self.kalman_r_doppler ** 2])
        s = p[:2, :2] + r
        k = np.linalg.solve(s.T, p[:, :2].T).T          # P Hᵀ S⁻¹
        x = x_pred + k @ nu
        i_kh = np.eye(3)
        i_kh[:, :2] -= k                                 # I − K H
        p = i_kh @ p
        rec.kf_p = 0.5 * (p + p.T)
        rec.associate((float(x[0]), float(x[1]), meas[2]))
        rec.acceleration = float(x[2])

    def _initiate(self, detection: Detection, used) -> None:
        for j in range(detection.n_detections):
            if used[j]:
                continue
            point = (detection.delay[j], detection.doppler[j], detection.snr[j])
            for acc in self.acc_init:
                rec = self.store.add(point)
                rec.acceleration = acc
