"""Rigid-transform helpers (quaternions, SE(3)) for ego/sensor/global
frames: a copy of shasta_tpu/core/transforms.py for the port.

Host-side numpy (used by preprocessing and data loading). Behavioral
reference: preprocessing/get_det_sensor_info.py:45-112 (global -> ego ->
lidar sensor frame chain) and nuscenes-devkit Box.translate/rotate.
Quaternions are [w, x, y, z].
"""
from __future__ import annotations

import numpy as np


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_inverse(q: np.ndarray) -> np.ndarray:
    n = np.dot(q, q)
    return np.array([q[0], -q[1], -q[2], -q[3]]) / n


def velo2world(ego_matrix: np.ndarray, velo: np.ndarray) -> np.ndarray:
    """Rotate a local [vx, vy] velocity into the world frame by the ego
    pose's rotation block (mot_3d/utils/geometry.py:15-20)."""
    return np.asarray(ego_matrix)[:2, :2] @ np.asarray(velo)


def quat_slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation between unit quaternions (shortest arc).

    Used for 20 Hz GT interpolation at non-key frames (the devkit's
    get_boxes behavior the reference relies on, gt_info.py 20hz branch)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:  # nearly parallel: lerp + renormalize
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def transform_points(points: np.ndarray, rot_q: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply p' = R p + t to (N, 3) points."""
    return points @ quat_to_rotmat(rot_q).T + trans


def inverse_transform_points(
    points: np.ndarray, rot_q: np.ndarray, trans: np.ndarray
) -> np.ndarray:
    """Apply p' = R^-1 (p - t) (global -> local), devkit translate/rotate order."""
    return (points - trans) @ quat_to_rotmat(rot_q)


def global_to_sensor_box(
    box_translation: np.ndarray,
    box_rotation: np.ndarray,
    ego_translation: np.ndarray,
    ego_rotation: np.ndarray,
    sensor_translation: np.ndarray,
    sensor_rotation: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Global-frame box pose -> lidar sensor frame.

    Mirrors get_det_sensor_info.py: box.translate(-ego_t); box.rotate(ego_q^-1);
    box.translate(-sensor_t); box.rotate(sensor_q^-1).
    """
    t = box_translation - ego_translation
    inv_e = quat_inverse(ego_rotation)
    t = quat_to_rotmat(inv_e) @ t
    q = quat_multiply(inv_e, box_rotation)
    t = t - sensor_translation
    inv_s = quat_inverse(sensor_rotation)
    t = quat_to_rotmat(inv_s) @ t
    q = quat_multiply(inv_s, q)
    return t, q


def sensor_to_global_box(
    box_translation: np.ndarray,
    box_rotation: np.ndarray,
    ego_translation: np.ndarray,
    ego_rotation: np.ndarray,
    sensor_translation: np.ndarray,
    sensor_rotation: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`global_to_sensor_box` (nusc_common.py:181-201)."""
    t = quat_to_rotmat(sensor_rotation) @ box_translation + sensor_translation
    q = quat_multiply(sensor_rotation, box_rotation)
    t = quat_to_rotmat(ego_rotation) @ t + ego_translation
    q = quat_multiply(ego_rotation, q)
    return t, q
