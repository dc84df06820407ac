"""MOT metrics accumulator: MOTA / MOTP / ID switches per sequence; a copy
of shasta_tpu/mot/metrics.py.

Behavioral reference: mot_3d/metrics/eval.py:7-35 (a motmetrics-based
per-sequence accumulator; library-only in the reference too). Implemented
dependency-free with the standard CLEAR-MOT bookkeeping: per frame, match
GT<->hypotheses by center distance (keeping previous pairings when still
valid), count FP/FN/IDSW, accumulate distance over matches.
"""
from __future__ import annotations

import numpy as np


class MOTAccumulator:
    def __init__(self, dist_threshold: float = 2.0):
        self.dist_threshold = dist_threshold
        self.num_gt = 0
        self.num_fp = 0
        self.num_fn = 0
        self.num_idsw = 0
        self.num_matches = 0
        self.total_dist = 0.0
        self._last_match: dict = {}  # gt id -> hyp id

    def update(self, gt_ids, gt_centers, hyp_ids, hyp_centers):
        gt_ids = list(gt_ids)
        hyp_ids = list(hyp_ids)
        G, H = len(gt_ids), len(hyp_ids)
        self.num_gt += G
        gt_c = (
            np.asarray(gt_centers, np.float64).reshape(G, -1)[:, :2]
            if G else np.zeros((0, 2))
        )
        hyp_c = (
            np.asarray(hyp_centers, np.float64).reshape(H, -1)[:, :2]
            if H else np.zeros((0, 2))
        )

        dist = (
            np.linalg.norm(gt_c[:, None, :] - hyp_c[None, :, :], axis=2)
            if G and H
            else np.zeros((G, H))
        )
        matched_g: dict[int, int] = {}
        used_h: set[int] = set()

        # 1. keep persistent pairings still within threshold
        for gi, gid in enumerate(gt_ids):
            if gid in self._last_match and self._last_match[gid] in hyp_ids:
                hi = hyp_ids.index(self._last_match[gid])
                if dist[gi, hi] <= self.dist_threshold:
                    matched_g[gi] = hi
                    used_h.add(hi)

        # 2. greedily match the rest by distance
        if G and H:
            order = np.argsort(dist, axis=None)
            for idx in order:
                gi, hi = divmod(int(idx), H)
                if gi in matched_g or hi in used_h:
                    continue
                if dist[gi, hi] > self.dist_threshold:
                    break
                matched_g[gi] = hi
                used_h.add(hi)

        new_match = {}
        for gi, hi in matched_g.items():
            gid, hid = gt_ids[gi], hyp_ids[hi]
            if gid in self._last_match and self._last_match[gid] != hid:
                self.num_idsw += 1
            new_match[gid] = hid
            self.num_matches += 1
            self.total_dist += float(dist[gi, hi])
        self.num_fn += G - len(matched_g)
        self.num_fp += H - len(used_h)
        # persist pairings for ids seen this frame; keep older pairings too
        self._last_match.update(new_match)
        return sorted(matched_g.values())  # matched hypothesis indices

    @property
    def mota(self) -> float:
        if self.num_gt == 0:
            return 0.0
        return 1.0 - (self.num_fp + self.num_fn + self.num_idsw) / self.num_gt

    @property
    def motp(self) -> float:
        return self.total_dist / self.num_matches if self.num_matches else 0.0

    def summary(self) -> dict:
        return {
            "mota": self.mota,
            "motp": self.motp,
            "num_gt": self.num_gt,
            "fp": self.num_fp,
            "fn": self.num_fn,
            "idsw": self.num_idsw,
        }
