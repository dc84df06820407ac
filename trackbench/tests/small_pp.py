"""The pillar cell's configuration and mix cut to a size the CPU runs in
seconds: a 12.8 m x 12.8 m canvas of 64 x 64 pillars at the published 0.2
m (about a thousand filled of 1,500 slots), the published channel widths, a
few thousand points, a dozen objects and max_obj 10."""
from __future__ import annotations

from trackbench.tests.small import load


def small_pp() -> tuple[dict, dict]:
    cfg, mix = load("configs", "shasta-car-pp"), load("traffic", "pp_stream")
    half = 6.4
    cfg["point_pipeline"].update(pc_range=[-half, -half, -5.0, half, half, 3.0], max_voxels=1500)
    cfg["model"].update(pc_start=[-half, -half], grid_shape=[1, 64, 64])
    cfg["classes"] = [dict(c, max_obj=10) for c in cfg["classes"]]
    mix.update(objects=12, key_points=3000, sweep_points=1000, spots=800, frames=3, scenes=2,
               trace_frames=4)
    mix["check_scenes"] = mix["scenes"]
    return cfg, mix
