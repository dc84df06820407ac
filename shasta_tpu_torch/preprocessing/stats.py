"""Kalman covariance estimation from GT tracks (P/Q/R stats jsons): the port
of shasta_tpu/preprocessing/stats.py.

Behavioral reference: preprocessing/nusc_dataset_stats.py:22-97 — estimates
per-class diagonal covariances over the 11-d state
[x, y, z, o, l, w, h, vx, vy, vz, vo] from detections vs GT trajectories.
(The reference script imports a `stat_estimation` module missing from its
repo; this is a working re-derivation of the standard AB3DMOT-style
estimator the outputs in nusc_stats/*.json follow.)

- R (measurement noise, 7-d): var of det-minus-matched-GT residuals
- P (initial state, 11-d):    R plus velocity residual vars
- Q (process noise, 11-d):    var of GT constant-velocity prediction error
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from .associate import associate_l2

STATE_DIM = 11
MEAS_DIM = 7


def _wrap(a):
    return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi


def estimate_covariances(
    scenes: list[dict],
    threshold: float = 2.0,
) -> tuple[dict, dict, dict]:
    """scenes: list of {frames: [{dets (N,8) mot, det_types, gts (M,8) mot,
    gt_types, gt_ids}], dt: frame period}. Returns (P, Q, R) dicts of
    per-class 11/11/7-d diagonal lists."""
    meas_res = defaultdict(list)  # class -> [7-d residual]
    vel_res = defaultdict(list)  # class -> [4-d velocity residual]
    proc_res = defaultdict(list)  # class -> [11-d process residual]

    for scene in scenes:
        dt = scene.get("dt", 0.5)
        prev_gt: dict = {}
        prev_vel: dict = {}
        for frame in scene["frames"]:
            gts = np.asarray(frame["gts"]).reshape(-1, 8)
            gt_ids = list(frame["gt_ids"])
            gt_types = list(frame["gt_types"])
            dets = np.asarray(frame["dets"]).reshape(-1, 8)
            det_types = list(frame["det_types"])

            # measurement residuals from det<->GT association
            tp_pairs, _, _ = associate_l2(gts, gt_types, dets, det_types, threshold)
            for det_i, gt_i in tp_pairs.items():
                r = dets[det_i, :7] - gts[gt_i, :7]
                r[3] = _wrap(r[3])
                cls = det_types[det_i]
                meas_res[cls].append(r)

            # GT velocities + process residuals from trajectory differencing
            cur_gt = {}
            cur_vel = {}
            for i, gid in enumerate(gt_ids):
                cur_gt[gid] = (gts[i, :7], gt_types[i])
                if gid in prev_gt:
                    prev_state, cls = prev_gt[gid]
                    v = (gts[i, :3] - prev_state[:3]) / dt
                    vo = _wrap(gts[i, 3] - prev_state[3]) / dt
                    cur_vel[gid] = np.array([v[0], v[1], v[2], vo])
                    if gid in prev_vel:
                        # CV prediction error over one step
                        pv = prev_vel[gid]
                        pred = prev_state.copy()
                        pred[:3] += pv[:3] * dt
                        pred[3] += pv[3] * dt
                        e = gts[i, :7] - pred
                        e[3] = _wrap(e[3])
                        ev = cur_vel[gid] - pv
                        proc_res[cls].append(np.concatenate([e, ev]))
                        # velocity residual (for the P tail)
                        vel_res[cls].append(ev)
            prev_gt, prev_vel = cur_gt, cur_vel

    def var_or_default(rows, dim, default=1.0):
        if len(rows) < 2:
            return [default] * dim
        return np.maximum(np.var(np.stack(rows), axis=0), 1e-6).tolist()

    classes = set(meas_res) | set(proc_res)
    P, Q, R = {}, {}, {}
    for cls in classes:
        r = var_or_default(meas_res[cls], MEAS_DIM)
        v = var_or_default(vel_res[cls], 4)
        q = var_or_default(proc_res[cls], STATE_DIM)
        R[cls] = r
        P[cls] = r + v
        Q[cls] = q
    return P, Q, R


def write_stats(P: dict, Q: dict, R: dict, out_dir: str, name: str = "cp_2hz"):
    os.makedirs(out_dir, exist_ok=True)
    for label, d in (("P", P), ("Q", Q), ("R", R)):
        with open(os.path.join(out_dir, f"{label}_{name}.json"), "w") as f:
            json.dump(d, f)
