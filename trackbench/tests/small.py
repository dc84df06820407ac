"""The cells' configurations and mixes cut to a size the CPU runs in
seconds: a 12 m x 12 m grid at the published voxel size, a few thousand
points, a dozen objects and small max_obj; everything else as committed."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_OBJ = {"car": 10, "pedestrian": 10, "truck": 6, "trailer": 6, "bus": 6, "motorcycle": 6,
             "bicycle": 6}


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def small(config: str, traffic: str) -> tuple[dict, dict]:
    cfg, mix = load("configs", config), load("traffic", traffic)
    half = 6.0
    cfg["point_pipeline"].update(pc_range=[-half, -half, -5.0, half, half, 3.0], max_voxels=6000)
    cfg["model"].update(pc_start=[-half, -half], grid_shape=[41, 160, 160])
    cfg["assumed"]["caps"] = {"1": [12000, 6000, 3000, 3000]}
    cfg["classes"] = [dict(c, max_obj=SMALL_OBJ[c["name"]]) for c in cfg["classes"]]
    mix.update(objects=12, key_points=3000, sweep_points=1000, spots=800, frames=3,
               scenes=3 if mix["driver"] == "eval_lanes" else 2, trace_frames=4)
    mix["check_scenes"] = mix["scenes"]
    if mix["driver"] == "eval_lanes":
        mix["lanes"] = 2
        cfg["assumed"]["caps"]["2"] = [24000, 12000, 6000, 6000]
    return cfg, mix
