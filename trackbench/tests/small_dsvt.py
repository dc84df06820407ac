"""The DSVT cell's configuration and mix cut to a size the CPU runs in
seconds: a 48 x 48 pillar grid at the published 0.3 m (14.4 m a side),
windows of 6 shifted by 3, sets of 8, d_model 32 (8 heads, FFN 64) over
all four blocks, a residual neck of 32/32/64 channels to 96 and a shared
conv to 32; a dozen objects, a few thousand points and max_obj 10."""
from __future__ import annotations

from trackbench.tests.small import load


def small_dsvt(max_pillars: int = 1500) -> tuple[dict, dict]:
    cfg, mix = load("configs", "shasta-car-dsvt"), load("traffic", "dsvt_stream")
    half = 7.2
    cfg["point_pipeline"].update(pc_range=[-half, -half, -5.0, half, half, 3.0])
    cfg["model"].update(pc_start=[-half, -half], grid_shape=[1, 48, 48], pfn_filters=[32, 32],
                        max_pillars=max_pillars, dsvt_d_model=32, dsvt_ffn=64, dsvt_set_size=8,
                        dsvt_window=6, dsvt_shift=3, ds_num_filters=[32, 32, 64],
                        us_num_filters=[32, 32, 32], neck_input_features=32,
                        share_conv_channel=32)
    cfg["classes"] = [dict(c, max_obj=10) for c in cfg["classes"]]
    mix.update(objects=12, key_points=3000, sweep_points=1000, spots=800, frames=3, scenes=2,
               trace_frames=4, cloud_rows=13000)
    mix["check_scenes"] = mix["scenes"]
    return cfg, mix
