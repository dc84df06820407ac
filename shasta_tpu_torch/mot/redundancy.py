"""Unmatched-track handling: default / motion-model / bbox redundancy; the
port of shasta_tpu/mot/redundancy.py.

Behavioral reference: mot_3d/redundancy/redundancy.py:9-129. A track with no
high-score association can be rescued by a low-score detection overlapping
its predicted box (update mode 3) or kept as pure prediction (mode 0).

The JAX package calls the box geometry once per unmatched track. Here one
frame's unmatched tracks share one call: a track's candidates (the frame's
detections above det_score, back-stepped alike) do not depend on the
track, so its column of the (candidates, tracks) matrix is its own call's
result, bit for bit (tests/test_torch_mot.py holds the two against each
other). The matrix runs in f32 on the module's device.
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .association import geometry_matrix


class RedundancyModule:
    def __init__(self, configs: dict, device=None):
        self.configs = configs
        self.mode = configs["redundancy"]["mode"]
        self.asso = configs["running"]["asso"]
        self.det_score = configs["redundancy"]["det_score_threshold"][self.asso]
        self.det_threshold = configs["redundancy"]["det_dist_threshold"][self.asso]
        self.motion_model_type = configs["running"]["motion_model"]
        self.device = resolve_device(device)

    @property
    def back_step(self):
        return self.motion_model_type == "velo"

    def infer(self, trk, dets, velos=None, time_lag=None):
        """dets: (N, 8) mot arrays. Returns (result_bbox, update_mode, aux)."""
        return self.infer_frame([trk], dets, velos, time_lag)[0]

    def infer_frame(self, trks, dets, velos=None, time_lag=None):
        """`infer` of each of one frame's tracks, in order."""
        if not trks:
            return []
        if self.mode == "bbox":
            return self.bbox_redundancy(trks, dets)
        if self.mode == "mm":
            return self.motion_model_redundancy(trks, dets, velos, time_lag)
        return [self.default_redundancy(trk, dets) for trk in trks]

    def default_redundancy(self, trk, dets):
        return trk.get_state(), 0, None

    def _scores(self, cand, preds, kind):
        """(len(cand), len(preds)) f32 iou/giou matrix, or None without
        candidates."""
        if not cand:
            return None
        return geometry_matrix(np.stack(cand), np.stack(preds), kind, self.device)

    def motion_model_redundancy(self, trks, dets, velos, time_lag):
        preds = [trk.get_state() for trk in trks]
        cand_idx = [i for i, d in enumerate(dets) if d[7] > self.det_score]
        cand = [np.asarray(dets[i], np.float64) for i in cand_idx]
        if self.back_step and velos is not None:
            stepped = []
            for k, i in enumerate(cand_idx):
                d = cand[k].copy()
                d[0] -= velos[i][0] * time_lag
                d[1] -= velos[i][1] * time_lag
                stepped.append(d)
            cand = stepped

        geo = self._scores(cand, preds, self.asso) if self.asso in ("iou", "giou") else None
        out = []
        for j, (trk, pred_bbox) in enumerate(zip(trks, preds)):
            dists = []
            if geo is not None:
                dists = geo[:, j].tolist()
            elif cand:
                inv = (np.linalg.inv(trk.compute_innovation_matrix())
                       if self.asso == "m_dis" else None)
                for d in cand:
                    diff = d[:7] - pred_bbox[:7]
                    diff[3] = (diff[3] + np.pi) % (2 * np.pi) - np.pi
                    if inv is not None:
                        dists.append(float(np.sqrt(diff @ inv @ diff)))
                    else:
                        dists.append(float(np.sqrt(np.sum(diff * diff))))

            if self.asso in ("iou", "giou"):
                rescued = len(dists) > 0 and np.max(dists) >= self.det_threshold
            else:
                rescued = len(dists) > 0 and np.min(dists) <= self.det_threshold
            out.append((pred_bbox, (3 if rescued else 0), {"velo": np.zeros(2)}))
        return out

    def bbox_redundancy(self, trks, dets):
        cand = [np.asarray(d, np.float64) for d in dets if d[7] > self.det_score]
        preds = [trk.get_state() for trk in trks]
        ious = self._scores(cand, preds, "iou")
        out = []
        for j, pred_bbox in enumerate(preds):
            if ious is None or ious[:, j].max() < self.det_threshold:
                out.append((pred_bbox, 0, None))
                continue
            best = int(ious[:, j].argmax())
            out.append((cand[best], (1 if ious[best, j] > 0.7 else 3), None))
        return out
