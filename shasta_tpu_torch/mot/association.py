"""Detection-to-track association: greedy / bipartite over 4 metrics; the
port of shasta_tpu/mot/association.py.

Behavioral reference: mot_3d/association.py:9-120. Distance matrices are
computed with the vectorized rotated-box geometry (core/geometry.py)
instead of per-pair shapely calls; semantics preserved:
- iou/giou distances are 1 - metric; matches above dist_threshold rejected
- greedy: globally sorted distance list, first-free pairing
  (association.py:53-89, the Mahalanobis-3D-MOT order, which differs from
  the row-ordered PubTracker greedy)
- m_dis: Mahalanobis with per-track innovation matrices; euler: weighted
  L2 on [x, y, yaw] (mot_3d/utils/geometry.py m_distance semantics)

The iou/giou matrices run in f32 on the caller's device, as the JAX
package's run in f32 (jnp.asarray of float64 rows without jax_enable_x64):
a float64 matrix could send a pair near a threshold the other way. m_dis
and euler stay numpy double loops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..device import resolve_device
from .bbox import MotBBox


def geometry_matrix(boxes1, boxes2, kind: str, device) -> np.ndarray:
    """(N, M) float32 iou_3d or giou_3d (kind "iou" / "giou") of mot rows
    boxes1 (N, 8) against boxes2 (M, 8), computed in f32 on `device`."""
    fn = geometry.iou_3d if kind == "iou" else geometry.giou_3d
    rows = [torch.as_tensor(MotBBox.to_geometry_rows(b), dtype=torch.float32).to(device)
            for b in (boxes1, boxes2)]
    with torch.inference_mode():
        return fn(*rows).cpu().numpy()


def _m_distance_matrix(dets, tracks, inv_innovations=None) -> np.ndarray:
    D = np.zeros((len(dets), len(tracks)))
    for i, det in enumerate(dets):
        for j, trk in enumerate(tracks):
            diff = np.asarray(det[:7], np.float64) - np.asarray(trk[:7], np.float64)
            # yaw wrap on the orientation component (index 3 in mot layout)
            diff[3] = (diff[3] + np.pi) % (2 * np.pi) - np.pi
            if inv_innovations is not None:
                D[i, j] = np.sqrt(diff @ inv_innovations[j] @ diff)
            else:
                D[i, j] = np.sqrt(np.sum(diff * diff))
    return D


def compute_distance_matrix(dets, tracks, asso: str, trk_innovation_matrix=None,
                            device=None):
    """(N, M) distances of dets to tracks; iou/giou on `device` (None: the
    card, through resolve_device)."""
    dets = np.atleast_2d(np.asarray(dets, np.float64))
    tracks = np.atleast_2d(np.asarray(tracks, np.float64))
    if asso in ("iou", "giou"):
        return 1.0 - geometry_matrix(dets, tracks, asso, resolve_device(device))
    if asso == "m_dis":
        invs = [np.linalg.inv(m) for m in trk_innovation_matrix]
        return _m_distance_matrix(dets, tracks, invs)
    if asso == "euler":
        return _m_distance_matrix(dets, tracks, None)
    raise ValueError(asso)


def greedy_matcher(dist_matrix: np.ndarray) -> np.ndarray:
    """Globally-sorted greedy pairing (association.py:53-89)."""
    nd, nt = dist_matrix.shape
    order = np.argsort(dist_matrix.reshape(-1))
    det_taken = [-1] * nd
    trk_taken = [-1] * nt
    out = []
    for idx in order:
        d, t = int(idx // nt), int(idx % nt)
        if det_taken[d] == -1 and trk_taken[t] == -1:
            det_taken[d] = t
            trk_taken[t] = d
            out.append([d, t])
    return np.asarray(out).reshape(-1, 2)


def associate_dets_to_tracks(
    dets,
    tracks,
    mode: str,
    asso: str,
    dist_threshold: float = 0.9,
    trk_innovation_matrix=None,
    device=None,
):
    """Returns (matches list[(d, t)], unmatched_dets, unmatched_tracks)."""
    if len(dets) == 0 or len(tracks) == 0:
        return [], np.arange(len(dets)), np.arange(len(tracks))
    dist = compute_distance_matrix(dets, tracks, asso, trk_innovation_matrix, device)
    if mode == "bipartite":
        from scipy.optimize import linear_sum_assignment

        r, c = linear_sum_assignment(dist)
        pairs = np.stack([r, c], axis=1)
    elif mode == "greedy":
        pairs = greedy_matcher(dist)
    else:
        raise ValueError(mode)

    unmatched_dets = [d for d in range(len(dets)) if d not in pairs[:, 0]]
    unmatched_tracks = [t for t in range(len(tracks)) if t not in pairs[:, 1]]
    matches = []
    for m in pairs:
        if dist[m[0], m[1]] > dist_threshold:
            unmatched_dets.append(m[0])
            unmatched_tracks.append(m[1])
        else:
            matches.append((int(m[0]), int(m[1])))
    return matches, np.asarray(unmatched_dets), np.asarray(unmatched_tracks)
