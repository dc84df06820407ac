"""Per-class Kalman covariance tables: the port of shasta_tpu/mot/covariance.py.

Behavioral reference: mot_3d/motion_model/covariance/nuscenes.py:4-17 —
diagonal P/Q/R per class loaded from the checked-in statistics JSONs
(estimated by preprocessing/nusc_dataset_stats.py). The same artifacts are
vendored under shasta_tpu/mot/stats; the stats/ directory beside this
module holds byte-identical copies (numeric data, 11-d diagonals for the
state [x,y,z,o,l,w,h,vx,vy,vz,vo]; R is 7-d measurement noise).
"""
from __future__ import annotations

import json
import os

import numpy as np

_STATS_DIR = os.path.join(os.path.dirname(__file__), "stats")

OBJ_TYPES = "car,bus,trailer,truck,pedestrian,bicycle,motorcycle".split(",")


class NuCovariance:
    def __init__(self, name: str = "cp_2hz", stats_dir: str | None = None):
        d = stats_dir or _STATS_DIR
        with open(os.path.join(d, f"P_{name}.json")) as f:
            P = json.load(f)
        with open(os.path.join(d, f"Q_{name}.json")) as f:
            Q = json.load(f)
        with open(os.path.join(d, f"R_{name}.json")) as f:
            R = json.load(f)
        self.P = {t: np.diag(P[t]) for t in OBJ_TYPES}
        self.Q = {t: np.diag(Q[t]) for t in OBJ_TYPES}
        self.R = {t: np.diag(R[t]) for t in OBJ_TYPES}
