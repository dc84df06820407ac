"""Mot-format box array helpers: the port of shasta_tpu/mot/bbox.py.

The mot_3d library's BBox array layout is [x, y, z, o(yaw), l, w, h, (s)]
(mot_3d/data_protos/bbox.py:29-33) — yaw at index 3 and LENGTH along the
heading x axis (unlike the det3d 11-feature row where index 3 is width).
We keep boxes as plain numpy arrays instead of objects; this module holds
the layout conversions.
"""
from __future__ import annotations

import numpy as np

from ..ops.nms import mot_to_geometry_rows


class MotBBox:
    """Namespace for [x, y, z, o, l, w, h, s] array operations."""

    X, Y, Z, O, L, W, H, S = range(8)

    # mot rows -> float64 geometry rows [x, y, z, w', l', h, yaw], w' along
    # the box-local x axis (the weighted NMS shares the conversion)
    to_geometry_rows = staticmethod(mot_to_geometry_rows)

    @staticmethod
    def from_det11(rows: np.ndarray) -> np.ndarray:
        """det3d 11-feature rows [x,y,z,w,l,h,yaw,...,score] -> mot rows."""
        rows = np.atleast_2d(rows)
        out = np.zeros((len(rows), 8))
        out[:, :3] = rows[:, :3]
        out[:, 3] = rows[:, 6]
        out[:, 4] = rows[:, 4]
        out[:, 5] = rows[:, 3]
        out[:, 6] = rows[:, 5]
        if rows.shape[1] > 10:
            out[:, 7] = rows[:, 10]
        return out

    @staticmethod
    def bev_corners(box: np.ndarray) -> np.ndarray:
        """(4, 2) BEV corners, CCW, l along heading (bbox.py box2corners2d)."""
        x, y, o, l, w = box[0], box[1], box[3], box[4], box[5]
        dx, dy = l / 2.0, w / 2.0
        c, s = np.cos(o), np.sin(o)
        local = np.array([[dx, dy], [dx, -dy], [-dx, -dy], [-dx, dy]])
        rot = np.array([[c, -s], [s, c]])
        return local @ rot.T + np.array([x, y])
