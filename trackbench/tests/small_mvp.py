"""The MVP cell's configuration and mix cut to a size the CPU runs in
seconds: small.py's 12 m x 12 m grid at the published 0.075 m voxels, a
few thousand real points, a dozen objects with 10 virtual points a sweep,
max_obj 10."""
from __future__ import annotations

from trackbench.tests.small import load, small


def small_mvp() -> tuple[dict, dict]:
    cut, _ = small("shasta-car", "stream")
    cfg, mix = load("configs", "shasta-car-mvp"), load("traffic", "mvp_stream")
    half = 6.0
    cfg["point_pipeline"].update(pc_range=[-half, -half, -5.0, half, half, 3.0])
    cfg["model"].update(pc_start=[-half, -half], grid_shape=cut["model"]["grid_shape"],
                        max_voxels=6000)
    cfg["assumed"]["caps"] = cut["assumed"]["caps"]
    cfg["classes"] = [dict(c, max_obj=10) for c in cfg["classes"]]
    mix.update(objects=12, key_points=3000, sweep_points=1000, spots=800, frames=3, scenes=2,
               trace_frames=4, virtual_points=10, cloud_rows=16000)
    mix["check_scenes"] = mix["scenes"]
    return cfg, mix
