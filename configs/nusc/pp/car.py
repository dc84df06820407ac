"""ShaSTA's car config (configs/nusc/car.py) on CenterPoint-PointPillars'
trunk: the reader, scatter, neck and voxel generator of CenterPoint's
configs/nusc/pp/nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py (det3d's
PointPillars for nuScenes), under ShaSTA's shared conv, affinity head and
tracker. 0.2 x 0.2 x 8 m pillars over [-51.2, 51.2] m, 20 points a
pillar, 60,000 pillars (the test-time max_voxel_num), 10 sweeps; a 512 x
512 x 64 canvas; the RPN's three blocks to 384 channels at 128 x 128 (out
stride 4, 0.8 m cells). The shared conv takes those 384 channels: ShaSTA
publishes no PointPillars config. Served by the port only (reader
"pillars"); training refuses it.
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _base import *  # noqa: F401,F403

det_type = ["car"]
max_objects = 90
fp_ratio = 1 / 3
dead_trk_ratio = 1 / 3
beta = 0.5

model = dict(
    model,  # noqa: F405
    max_obj=max_objects,
    pc_start=(-51.2, -51.2),
    voxel_size=(0.2, 0.2),
    out_stride=4,
    grid_shape=(1, 512, 512),
    reader="pillars",
    pfn_filters=(64, 64),  # det3d's "two_pfn": Linear 10 -> 32 (+ its max), 64 -> 64
    layer_nums=(3, 5, 5),
    ds_layer_strides=(2, 2, 2),
    ds_num_filters=(64, 128, 256),
    us_layer_strides=(0.5, 1, 2),
    us_num_filters=(128, 128, 128),
    neck_input_features=64,
)

point_pipeline = dict(
    point_pipeline,  # noqa: F405
    voxel_size=(0.2, 0.2, 8.0),
    pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
    max_points_in_voxel=20,
    max_voxels=60000,
)
