"""Point-cloud & box augmentation library; the port of
shasta_tpu/data/augment.py (numpy, on the host, driven by the caller's
generator).

Behavioral reference: det3d/core/sampler/preprocess.py (global flips /
rotation / scaling / translation noise, per-object noise) as used by the
Preprocess pipeline stage (det3d/datasets/pipelines/preprocess.py:48-158).
The ShaSTA configs enable only global rot/scale/translate
(configs/nusc/car.py:105-113); the rest are provided for pipeline parity.
All functions operate jointly on points (N, >=3) and optional boxes
(M, >=7 [x,y,z,w,l,h,yaw,(vx,vy)]) and are host-side numpy.
"""
from __future__ import annotations

import numpy as np


def random_flip_x(points, boxes=None, rng=None, prob=0.5):
    """Mirror across the x axis (y -> -y)."""
    if (rng or np.random).random() >= prob:
        return points, boxes
    points = points.copy()
    points[:, 1] = -points[:, 1]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        if boxes.shape[1] > 8:
            boxes[:, 8] = -boxes[:, 8]
    return points, boxes


def random_flip_y(points, boxes=None, rng=None, prob=0.5):
    """Mirror across the y axis (x -> -x)."""
    if (rng or np.random).random() >= prob:
        return points, boxes
    points = points.copy()
    points[:, 0] = -points[:, 0]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = np.pi - boxes[:, 6]
        if boxes.shape[1] > 7:
            boxes[:, 7] = -boxes[:, 7]
    return points, boxes


def global_rotation(points, boxes=None, rng=None, noise=(-np.pi / 4, np.pi / 4)):
    ang = (rng or np.random).uniform(*noise)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s], [s, c]])
    points = points.copy()
    points[:, :2] = points[:, :2] @ rot.T
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :2] = boxes[:, :2] @ rot.T
        boxes[:, 6] += ang
        if boxes.shape[1] > 8:
            boxes[:, 7:9] = boxes[:, 7:9] @ rot.T
    return points, boxes


def global_scaling(points, boxes=None, rng=None, noise=(0.95, 1.05)):
    s = (rng or np.random).uniform(*noise)
    points = points.copy()
    points[:, :3] *= s
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :6] *= s
        if boxes.shape[1] > 8:
            boxes[:, 7:9] *= s
    return points, boxes


def global_translate(points, boxes=None, rng=None, std=0.5):
    t = (rng or np.random).normal(0, std, size=3)
    points = points.copy()
    points[:, :3] += t
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] += t
    return points, boxes


def shuffle_points(points, rng=None):
    points = points.copy()
    (rng or np.random).shuffle(points)
    return points
