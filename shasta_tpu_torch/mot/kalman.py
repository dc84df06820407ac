"""10-state constant-velocity Kalman filter with yaw-flip correction: the
port of shasta_tpu/mot/kalman.py (numpy).

Behavioral reference: mot_3d/motion_model/kalman_filter.py:7-175. State
x = [x, y, z, o, l, w, h, vx, vy, vz]; measurement z = x[:7]. Implemented
directly (filterpy-free) with the same quirks:

- ``get_prediction(ts)`` sets F's velocity terms to the time lag since the
  LAST UPDATE (not last prediction) and returns the prediction WITHOUT
  mutating the state; the next ``update`` re-runs predict with that F.
- yaw flip handling: if the measured yaw differs from the predicted yaw by
  an obtuse angle, the predicted yaw is flipped by pi before the update;
  >270-degree wraps are unwrapped (kalman_filter.py:100-118).
- score: measurement score if present else decayed x0.01.
"""
from __future__ import annotations

import numpy as np

from .covariance import NuCovariance

_H = np.eye(7, 10)


def _wrap(a: float) -> float:
    if a >= np.pi:
        a -= 2 * np.pi
    if a < -np.pi:
        a += 2 * np.pi
    return a


class KalmanFilterMotionModel:
    def __init__(self, bbox: np.ndarray, inst_type: str, time_stamp: float,
                 covariance: str = "default"):
        """bbox: mot array [x,y,z,o,l,w,h,(s)]."""
        self.prev_time_stamp = time_stamp
        self.latest_time_stamp = time_stamp
        self.score = bbox[7] if len(bbox) > 7 else None
        self.inst_type = inst_type

        self.x = np.zeros(10)
        self.x[:7] = np.asarray(bbox[:7], np.float64)
        self.F = np.eye(10)
        for i in range(3):
            self.F[i, 7 + i] = 1.0
        self.P = np.eye(10)
        self.Q = np.eye(10)
        self.R = np.eye(7)
        if covariance == "default":
            self.P[7:, 7:] *= 1000.0
            self.P *= 10.0
        elif "nuscenes" in covariance:
            cov = NuCovariance(covariance.split("_", 1)[1])
            self.P = cov.P[inst_type][:-1, :-1]
            self.Q = cov.Q[inst_type][:-1, :-1]
            self.R = cov.R[inst_type]

        self.history = [np.append(self.x[:7], self.score)]

    # -- core KF steps ------------------------------------------------------
    def _predict_state(self):
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.x[3] = _wrap(self.x[3])

    def predict(self, time_stamp=None):
        self._predict_state()

    def update(self, det_bbox: np.ndarray, gt_bbox: np.ndarray | None = None,
               aux_info=None):
        z = np.asarray(det_bbox[:7], np.float64).copy()

        self._predict_state()
        if gt_bbox is not None:
            # oracle-KF ablation: override the prior with GT
            self.x[:7] = np.asarray(gt_bbox[:7], np.float64)

        self.x[3] = _wrap(self.x[3])
        z[3] = _wrap(z[3])

        diff = abs(z[3] - self.x[3])
        if np.pi / 2.0 < diff < np.pi * 3 / 2.0:
            self.x[3] = _wrap(self.x[3] + np.pi)
        if abs(z[3] - self.x[3]) >= np.pi * 3 / 2.0:
            self.x[3] += 2 * np.pi if z[3] > 0 else -2 * np.pi

        y = z - _H @ self.x
        S = _H @ self.P @ _H.T + self.R
        K = self.P @ _H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(10) - K @ _H) @ self.P
        self.prev_time_stamp = self.latest_time_stamp
        self.x[3] = _wrap(self.x[3])

        s = det_bbox[7] if len(det_bbox) > 7 else None
        if s is None:
            self.score = None if self.score is None else self.score * 0.01
        else:
            self.score = s
        self.history[-1] = np.append(self.x[:7], self.score)

    def get_prediction(self, time_stamp=None) -> np.ndarray:
        """Time-lag-aware prediction; appended to history, state unchanged."""
        time_lag = (time_stamp - self.prev_time_stamp) if time_stamp is not None else 1.0
        self.latest_time_stamp = time_stamp
        for i in range(3):
            self.F[i, 7 + i] = time_lag
        px = self.F @ self.x
        px[3] = _wrap(px[3])
        pred = np.append(px[:7], self.score)
        self.history.append(pred)
        return pred

    def get_state(self) -> np.ndarray:
        return self.history[-1]

    def compute_innovation_matrix(self) -> np.ndarray:
        return _H @ self.P @ _H.T + self.R

    def sync_time_stamp(self, time_stamp):
        self.time_stamp = time_stamp


class FrameBasedKalmanFilterMotionModel(KalmanFilterMotionModel):
    """Frame-indexed CV Kalman filter ('fbkf' variant): velocity state is
    per-frame displacement, so F's velocity terms stay 1 regardless of
    timestamps (mot_3d/motion_model frame-based KF)."""

    def __init__(self, bbox, inst_type, time_stamp=None, covariance="default"):
        super().__init__(bbox, inst_type, time_stamp or 0.0, covariance)

    def get_prediction(self, time_stamp=None):
        self.latest_time_stamp = time_stamp
        for i in range(3):
            self.F[i, 7 + i] = 1.0
        px = self.F @ self.x
        px[3] = _wrap(px[3])
        pred = np.append(px[:7], self.score)
        self.history.append(pred)
        return pred


class NaiveMotionModel:
    """Velocity back-step model (mot_3d/motion_model velo variant): state is
    the latest box; association back-steps detections by v*dt instead."""

    def __init__(self, bbox, velo, inst_type, time_stamp):
        self.bbox = np.asarray(bbox, np.float64)
        self.velo = np.asarray(velo, np.float64)
        self.prev_time_stamp = time_stamp
        self.score = bbox[7] if len(bbox) > 7 else None
        self.history = [self.bbox.copy()]

    def predict(self, time_stamp=None):
        pass

    def update(self, det_bbox, gt_bbox=None, aux_info=None):
        self.bbox = np.asarray(det_bbox, np.float64)
        if aux_info and "velo" in aux_info:
            self.velo = np.asarray(aux_info["velo"], np.float64)
        self.history[-1] = self.bbox.copy()

    def get_prediction(self, time_stamp=None):
        self.history.append(self.bbox.copy())
        return self.bbox.copy()

    def get_state(self):
        return self.history[-1]

    def compute_innovation_matrix(self):
        return np.eye(7)

    def sync_time_stamp(self, time_stamp):
        self.time_stamp = time_stamp


class MovingAverageMotionModel:
    """Exponential moving-average box smoother ('ma' variant)."""

    def __init__(self, bbox, inst_type, time_stamp, alpha: float = 0.6):
        self.bbox = np.asarray(bbox, np.float64)
        self.alpha = alpha
        self.score = bbox[7] if len(bbox) > 7 else None
        self.history = [self.bbox.copy()]

    def predict(self, time_stamp=None):
        pass

    def update(self, det_bbox, gt_bbox=None, aux_info=None):
        d = np.asarray(det_bbox, np.float64)
        n = min(len(d), len(self.bbox))
        self.bbox[:n] = self.alpha * d[:n] + (1 - self.alpha) * self.bbox[:n]
        self.history[-1] = self.bbox.copy()

    def get_prediction(self, time_stamp=None):
        self.history.append(self.bbox.copy())
        return self.bbox.copy()

    def get_state(self):
        return self.history[-1]

    def compute_innovation_matrix(self):
        return np.eye(7)

    def sync_time_stamp(self, time_stamp):
        self.time_stamp = time_stamp
