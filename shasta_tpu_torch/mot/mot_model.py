"""Classical MOT driver: predict -> associate -> update -> birth/death; the
port of shasta_tpu/mot/mot_model.py.

Behavioral reference: mot_3d/mot.py:14-266 (frame_mot), plus the oracle
variants mot_oracle_dets.py / mot_oracle_kf.py used for the BASELINE
ablations: `oracle='dets'` keeps only GT-associated TP detections as input;
`oracle='kf'` snaps each matched track's KF prior to the associated GT box
(kalman update with gt override, mot_oracle_kf.py:164-180).

Boxes are mot arrays [x, y, z, o, l, w, h, s]. The association's and the
redundancy's iou/giou matrices run in f32 on the model's device (default
the card; device="cpu" runs them on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ..device import resolve_device
from ..preprocessing.associate import associate_l2
from .association import associate_dets_to_tracks
from .redundancy import RedundancyModule
from .tracklet import Tracklet


@dataclass
class FrameData:
    dets: np.ndarray  # (N, 8) mot arrays
    ego: Any = None
    time_stamp: float = 0.0
    det_types: Sequence[Any] = ()
    pc: np.ndarray | None = None
    gt_dets: np.ndarray | None = None
    gt_types: Sequence[Any] = ()
    gt_ids: Sequence[Any] = ()
    aux_info: dict = field(default_factory=lambda: {"is_key_frame": True})


@dataclass
class UpdateInfoData:
    mode: int
    bbox: np.ndarray
    frame_index: int
    ego: Any = None
    pc: Any = None
    dets: Any = None
    aux_info: dict | None = None


DEFAULT_CONFIG = {
    "running": {
        "match_type": "bipartite",
        "score_threshold": 0.01,
        "asso": "giou",
        "asso_thres": {"giou": 1.5, "iou": 0.9, "m_dis": 11.07, "euler": 4.0},
        "motion_model": "kf",
        "covariance": "default",
        "max_age_since_update": 2,
        "min_hits_to_birth": 1,
    },
    "redundancy": {
        "mode": "mm",
        "det_score_threshold": {"giou": 0.1, "iou": 0.1, "m_dis": 0.1, "euler": 0.1},
        "det_dist_threshold": {"giou": -0.5, "iou": 0.1, "m_dis": 11.07, "euler": 4.0},
    },
}


class MOTModel:
    def __init__(self, configs: dict | None = None, oracle: str | None = None, device=None):
        self.configs = configs or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self.trackers: list[Tracklet] = []
        self.frame_count = 0
        self.count = 0
        self.time_stamp = None
        self.redundancy = RedundancyModule(self.configs, self.device)
        self.oracle = oracle

        r = self.configs["running"]
        self.match_type = r["match_type"]
        self.score_threshold = r["score_threshold"]
        self.asso = r["asso"]
        self.asso_thres = r["asso_thres"][self.asso]
        self.motion_model = r["motion_model"]
        self.max_age = r["max_age_since_update"]
        self.min_hits = r["min_hits_to_birth"]

    @property
    def has_velo(self):
        return self.motion_model not in ("kf", "fbkf", "ma")

    # -- oracle helpers ----------------------------------------------------
    def _filter_tp_dets(self, input_data: FrameData):
        """oracle='dets': keep only detections GT-associated as TPs
        (mot_oracle_dets semantics, via preprocessing association)."""
        if input_data.gt_dets is None or len(input_data.gt_dets) == 0:
            return input_data
        tp_pairs = associate_l2(
            np.asarray(input_data.gt_dets), list(input_data.gt_types),
            np.asarray(input_data.dets), list(input_data.det_types),
            threshold=2.0,
        )[0]
        keep = sorted(tp_pairs.keys())
        input_data.dets = np.asarray([input_data.dets[i] for i in keep])
        input_data.det_types = [input_data.det_types[i] for i in keep]
        return input_data

    def _gt_for_track(self, trk_pred, input_data: FrameData):
        """oracle='kf': nearest GT box within 2 m of the track prediction."""
        if input_data.gt_dets is None or len(input_data.gt_dets) == 0:
            return None
        gts = np.asarray(input_data.gt_dets)
        d = np.linalg.norm(gts[:, :2] - np.asarray(trk_pred[:2]), axis=1)
        j = int(d.argmin())
        return gts[j] if d[j] < 2.0 else None

    # -- main step ---------------------------------------------------------
    def frame_mot(self, input_data: FrameData):
        self.frame_count += 1
        if self.time_stamp is None:
            self.time_stamp = input_data.time_stamp

        if self.oracle == "dets":
            input_data = self._filter_tp_dets(input_data)

        dets = np.atleast_2d(np.asarray(input_data.dets, np.float64)) if len(
            input_data.dets
        ) else np.zeros((0, 8))
        det_indexes = [i for i in range(len(dets)) if dets[i][7] >= self.score_threshold]
        cand = dets[det_indexes] if det_indexes else np.zeros((0, 8))

        trk_preds = [
            trk.predict(input_data.time_stamp, input_data.aux_info["is_key_frame"])
            for trk in self.trackers
        ]
        if self.oracle == "kf":
            for t, trk in enumerate(self.trackers):
                gt = self._gt_for_track(trk_preds[t], input_data)
                if gt is not None:
                    trk_preds[t][:7] = gt[:7]

        innovations = (
            [trk.compute_innovation_matrix() for trk in self.trackers]
            if self.asso == "m_dis"
            else None
        )
        matches, unmatched_dets, unmatched_trks = associate_dets_to_tracks(
            cand,
            np.asarray(trk_preds).reshape(-1, 8) if trk_preds else np.zeros((0, 8)),
            self.match_type,
            self.asso,
            self.asso_thres,
            innovations,
            self.device,
        )
        time_lag = input_data.time_stamp - self.time_stamp
        is_kf = input_data.aux_info["is_key_frame"]

        det_of_trk = {t: d for d, t in matches}
        # the unmatched tracks' redundancy, one geometry call for the frame
        unmatched = [t for t in range(len(self.trackers)) if t not in det_of_trk]
        rescue = dict(zip(unmatched, self.redundancy.infer_frame(
            [self.trackers[t] for t in unmatched], dets, input_data.aux_info.get("velos"),
            time_lag)))
        for t, trk in enumerate(self.trackers):
            if t in det_of_trk:
                d = det_indexes[det_of_trk[t]]
                aux = {"is_key_frame": is_kf}
                if self.has_velo:
                    aux["velo"] = list(input_data.aux_info.get("velos", np.zeros((len(dets), 2)))[d])
                gt_bbox = None
                if self.oracle == "kf":
                    gt_bbox = self._gt_for_track(trk_preds[t], input_data)
                trk.update(1, dets[d], self.frame_count, is_kf, gt_bbox=gt_bbox, aux_info=aux)
            else:
                result_bbox, mode, _aux = rescue[t]
                trk.update(mode, result_bbox, self.frame_count, is_kf)

        for di in unmatched_dets:
            d = det_indexes[int(di)]
            aux = {"is_key_frame": is_kf}
            if self.has_velo:
                aux["velo"] = list(input_data.aux_info.get("velos", np.zeros((len(dets), 2)))[d])
            det_type = (
                input_data.det_types[d] if len(input_data.det_types) > d else None
            )
            self.trackers.append(
                Tracklet(
                    self.configs, self.count, dets[d], det_type,
                    self.frame_count, time_stamp=input_data.time_stamp, aux_info=aux,
                )
            )
            self.count += 1

        self.trackers = [
            trk for trk in self.trackers if not trk.death(self.frame_count)
        ]

        result = [
            (trk.get_state(), trk.id, trk.state_string(self.frame_count), trk.det_type)
            for trk in self.trackers
        ]
        self.time_stamp = input_data.time_stamp
        for trk in self.trackers:
            trk.sync_time_stamp(self.time_stamp)
        return result
