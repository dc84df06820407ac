"""Tracklet: motion model + life manager + score bookkeeping; the port of
shasta_tpu/mot/tracklet.py.

Behavioral reference: mot_3d/tracklet/tracklet.py:9-96 (incl. the x0.01
score decay per unassociated prediction at :51).
"""
from __future__ import annotations

import numpy as np

from .hit_manager import HitManager
from .kalman import (
    FrameBasedKalmanFilterMotionModel,
    KalmanFilterMotionModel,
    MovingAverageMotionModel,
    NaiveMotionModel,
)


class Tracklet:
    def __init__(self, configs, tid, bbox, det_type, frame_index,
                 time_stamp=None, aux_info=None):
        self.id = tid
        self.time_stamp = time_stamp
        self.det_type = det_type
        self.aux_info = aux_info or {}
        self.configs = configs

        mm = configs["running"]["motion_model"]
        if mm == "kf":
            self.motion_model = KalmanFilterMotionModel(
                bbox=bbox, inst_type=det_type, time_stamp=time_stamp,
                covariance=configs["running"].get("covariance", "default"),
            )
        elif mm == "velo":
            self.motion_model = NaiveMotionModel(
                bbox=bbox, velo=self.aux_info.get("velo", np.zeros(2)),
                inst_type=det_type, time_stamp=time_stamp,
            )
        elif mm == "fbkf":
            self.motion_model = FrameBasedKalmanFilterMotionModel(
                bbox=bbox, inst_type=det_type, time_stamp=time_stamp,
                covariance=configs["running"].get("covariance", "default"),
            )
        elif mm == "ma":
            self.motion_model = MovingAverageMotionModel(
                bbox=bbox, inst_type=det_type, time_stamp=time_stamp
            )
        else:
            raise ValueError(mm)

        self.life_manager = HitManager(configs, frame_index)
        self.latest_score = bbox[7] if len(bbox) > 7 else None

    def predict(self, time_stamp=None, is_key_frame=True) -> np.ndarray:
        result = self.motion_model.get_prediction(time_stamp=time_stamp)
        self.life_manager.predict(is_key_frame=is_key_frame)
        if self.latest_score is not None:
            self.latest_score = self.latest_score * 0.01
        result = np.asarray(result, np.float64).copy()
        result[7] = self.latest_score if self.latest_score is not None else np.nan
        return result

    def update(self, mode: int, bbox, frame_index: int, is_key_frame=True,
               gt_bbox=None, aux_info=None):
        self.latest_score = bbox[7] if len(bbox) > 7 else None
        if mode in (1, 3):
            self.motion_model.update(bbox, gt_bbox, aux_info)
        self.life_manager.update(mode, frame_index, is_key_frame)

    def get_state(self) -> np.ndarray:
        result = np.asarray(self.motion_model.get_state(), np.float64).copy()
        if len(result) > 7:
            result[7] = self.latest_score if self.latest_score is not None else np.nan
        return result

    def valid_output(self, frame_index):
        return self.life_manager.valid_output(frame_index)

    def death(self, frame_index):
        return self.life_manager.death(frame_index)

    def state_string(self, frame_index):
        return self.life_manager.state_string(frame_index)

    def compute_innovation_matrix(self):
        return self.motion_model.compute_innovation_matrix()

    def sync_time_stamp(self, time_stamp):
        self.motion_model.sync_time_stamp(time_stamp)
