"""ShaSTA's car config (configs/nusc/car.py) on CenterPoint-MVP's trunk:
the reader and backbone of MVP's
configs/mvp/nusc_centerpoint_voxelnet_0075voxel_fix_bn_z_scale_virtual.py
(Yin, Zhou, Krähenbühl, "Multimodal Virtual Point 3D Detection", NeurIPS
2021), under ShaSTA's neck, shared conv, affinity head and tracker. det3d's
DynamicVoxelEncoder(virtual=True) over [-54, 54] x [-54, 54] x [-5, 3] m
in 0.075 x 0.075 x 0.2 m voxels, every point of a voxel counted, into
160,000 voxel slots (det3d's test-time max_voxel_num at 0.075 m); its 21
features a voxel feed SpMiddleResNetFHD (conv_input 21 -> 16, then
16/32/64/128 over 41 x 1440 x 1440), then the VoxelNet RPN to 512 at
stride 8 as car.py. Frames are MVP's point rows, 16 channels (x, y, z, 11
painted channels, the type: 1 real, 0 painted, -1 virtual, the time),
handed to the pipelines as `cloud` and `cloud_valid` (infer.py). Served
by the port only (reader "dynamic"); training refuses it. The stage caps
are sized for one frame a step (B=1 serving).
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
    num_input_features=21,
    reader="dynamic",
    z_range=(-5.0, 3.0),
    max_voxels=160000,
    cap_conv2=220000,
    cap_conv3=140000,
    cap_conv4=64000,
    cap_extra=60000,
)
