"""ShaSTA's car config (configs/nusc/car.py) on DSVT-P's trunk: the reader,
backbone, scatter and 2D backbone of DSVT's nuScenes pillar model under
TransFusion-L (Wang et al., "DSVT: Dynamic Sparse Voxel Transformer with
Rotated Sets", CVPR 2023; Haiyang-W/DSVT
tools/cfgs/dsvt_models/dsvt_plain_1f_onestage_nusences.yaml), under
TransFusion-L's shared conv, ShaSTA's affinity head and tracker.
OpenPCDet's DynamicPillarVFE (NUM_FILTERS [128, 128]) over [-54, 54] x
[-54, 54] m in 0.3 x 0.3 x 8 m pillars (a 360 x 360 grid), 10 sweeps of
[x, y, z, intensity, lag] rows; one DSVT stage of four blocks (d_model
128, 8 heads, FFN 256, GELU) over sets of 90 in 30 x 30 windows shifted by
0 and 15; the 128 x 360 x 360 canvas; BaseBEVResBackbone (LAYER_NUMS [1,
2, 2], strides [1, 2, 2], filters [128, 128, 256], upsample [0.5, 1, 2] to
3 x 128) to 384 x 180 x 180 (out stride 2, 0.6 m cells); the shared conv
384 -> 128, a plain 3x3 conv (USE_BIAS_BEFORE_NORM false: no bias). Frames
are the clouds' rows, handed to the pipelines as `cloud` (B, N, 5) and
`cloud_valid` (B, N) in place of the voxel arrays; max_pillars slots a
lane. Served by the port only (reader "dsvt"); training refuses it.
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
    share_conv_channel=128,
    pc_start=(-54.0, -54.0),
    voxel_size=(0.3, 0.3),
    out_stride=2,
    grid_shape=(1, 360, 360),
    reader="dsvt",
    z_range=(-5.0, 3.0),
    pfn_filters=(128, 128),
    max_pillars=26000,
    dsvt_d_model=128,
    dsvt_heads=8,
    dsvt_ffn=256,
    dsvt_blocks=4,
    dsvt_set_size=90,
    dsvt_window=30,
    dsvt_shift=15,
    layer_nums=(1, 2, 2),
    ds_layer_strides=(1, 2, 2),
    ds_num_filters=(128, 128, 256),
    us_layer_strides=(0.5, 1, 2),
    us_num_filters=(128, 128, 128),
    neck_input_features=128,
)

point_pipeline = dict(
    point_pipeline,  # noqa: F405
    voxel_size=(0.3, 0.3, 8.0),
    pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
)
