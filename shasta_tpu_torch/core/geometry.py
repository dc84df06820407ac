"""Rotated-box geometry on tensors: the port of shasta_tpu/core/geometry.py
(IoU / GIoU / point-in-box / distances / score rectification).

Fixed-shape batched code over corner arrays, as in the JAX package:
polygon intersection is masked Sutherland-Hodgman clipping with a fixed
vertex capacity (a convex quad clipped by a convex quad has at most 8
vertices); the convex hull of two quads is a fixed-size monotone chain
whose pops run as a fixed number of masked steps (the JAX while_loop).
The JAX function's per-pair vmap is a leading batch axis here.

Box rows are the 7-feature BEV row [x, y, z, w, l, h, yaw] (w along the
box-local x after rotation, l along y: the corners of core/boxes.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .boxes import center_to_corner_box2d

_EPS = 1e-8
# max vertices of quad ∩ quad
_CAP = 8


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """BEV corners (..., N, 4, 2), clockwise, of boxes (..., N, >=7)."""
    return center_to_corner_box2d(boxes[..., :2], boxes[..., 3:5], boxes[..., 6])


def polygon_area(verts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Absolute shoelace area of masked polygons: verts (..., V, 2), mask
    (..., V) with the valid vertices contiguous from index 0. Invalid
    vertices take the first vertex (degenerate edges add no area)."""
    n = mask.sum(-1)
    v = torch.where(mask[..., None], verts, verts[..., :1, :])
    x, y = v[..., 0], v[..., 1]
    xn = torch.roll(x, -1, dims=-1)
    yn = torch.roll(y, -1, dims=-1)
    area2 = (x * yn - xn * y).sum(-1)
    return torch.where(n >= 3, area2.abs() * 0.5, 0.0)


def _clip_one_edge(verts, mask, p1, p2):
    """Clip masked polygons (..., V, 2) by the half-plane right of the
    directed edges p1 -> p2 (..., 2): clockwise polygons, inside where
    cross(e, p) <= 0. Returns (..., 2V) vertices and mask, compacted."""
    V = verts.shape[-2]
    e = p2 - p1
    d = verts - p1[..., None, :]
    cross = e[..., None, 0] * d[..., 1] - e[..., None, 1] * d[..., 0]
    inside = cross <= _EPS

    ar = torch.arange(V, device=verts.device)
    n = mask.sum(-1, keepdim=True)
    # the successor of the last valid vertex is vertex 0
    nxt = torch.where(ar == n - 1, 0, torch.roll(ar, -1).expand_as(mask))

    e_in = torch.gather(inside, -1, nxt)
    ve = torch.gather(verts, -2, nxt[..., None].expand_as(verts))
    ce = torch.gather(cross, -1, nxt)
    cs = cross
    # intersection of segment (vs, ve) with the clip line
    t = cs / torch.where((cs - ce).abs() < _EPS, _EPS, cs - ce)
    inter = verts + t[..., None] * (ve - verts)

    # each input edge emits up to 2 vertices: [crossing point?, endpoint?]
    emit_inter = mask & (inside != e_in)
    emit_end = mask & e_in
    out_verts = torch.stack([inter, ve], dim=-2).reshape(*verts.shape[:-2], 2 * V, 2)
    out_mask = torch.stack([emit_inter, emit_end], dim=-1).reshape(*mask.shape[:-1], 2 * V)
    # compact the valid vertices to the front (stable)
    order = torch.argsort((~out_mask).to(torch.int8), dim=-1, stable=True)
    return (torch.gather(out_verts, -2, order[..., None].expand_as(out_verts)),
            torch.gather(out_mask, -1, order))


def _quad_clip(sub: torch.Tensor, clip: torch.Tensor):
    """Intersection polygons of clockwise quads sub, clip (..., 4, 2) ->
    (verts (..., 16, 2), mask (..., 16))."""
    V = 2 * _CAP
    verts = sub.new_zeros(sub.shape[:-2] + (V, 2))
    verts[..., :4, :] = sub
    mask = torch.zeros(sub.shape[:-2] + (V,), dtype=torch.bool, device=sub.device)
    mask[..., :4] = True
    for k in range(4):
        verts, mask = _clip_one_edge(verts, mask, clip[..., k, :], clip[..., (k + 1) % 4, :])
        # a convex clip never exceeds _CAP + 4 live vertices
        verts, mask = verts[..., :V, :], mask[..., :V]
    return verts, mask


def rect_intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Overlap area of clockwise BEV quads c1, c2 (..., 4, 2)."""
    return polygon_area(*_quad_clip(c1, c2))


def _pair_corners(boxes1, boxes2):
    c1, c2 = corners_bev(boxes1), corners_bev(boxes2)
    N, M = boxes1.shape[0], boxes2.shape[0]
    return c1[:, None].expand(N, M, 4, 2), c2[None, :].expand(N, M, 4, 2)


def iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU: boxes (N, 7), (M, 7) -> (N, M)."""
    inter = rect_intersection_area(*_pair_corners(boxes1, boxes2))
    a1 = (boxes1[:, 3] * boxes1[:, 4])[:, None]
    a2 = (boxes2[:, 3] * boxes2[:, 4])[None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=_EPS)


def _z_overlap_union(boxes1, boxes2):
    zmax1 = boxes1[:, 2] + boxes1[:, 5] / 2
    zmin1 = boxes1[:, 2] - boxes1[:, 5] / 2
    zmax2 = boxes2[:, 2] + boxes2[:, 5] / 2
    zmin2 = boxes2[:, 2] - boxes2[:, 5] / 2
    overlap = torch.clamp(torch.minimum(zmax1[:, None], zmax2[None, :])
                          - torch.maximum(zmin1[:, None], zmin2[None, :]), min=0.0)
    union = torch.maximum(zmax1[:, None], zmax2[None, :]) - torch.minimum(
        zmin1[:, None], zmin2[None, :])
    return overlap, union


def _volumes(boxes1, boxes2):
    return ((boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None],
            (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :])


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU with axis-aligned z overlap (geometry.py:171-183)."""
    inter_bev = rect_intersection_area(*_pair_corners(boxes1, boxes2))
    z_overlap, _ = _z_overlap_union(boxes1, boxes2)
    inter_vol = inter_bev * z_overlap
    v1, v2 = _volumes(boxes1, boxes2)
    return inter_vol / torch.clamp(v1 + v2 - inter_vol, min=_EPS)


def _half_hull(pts: torch.Tensor):
    """One monotone-chain hull half of sorted points (B, P, 2) with a
    fixed-size stack -> (stack (B, P, 2), size (B,)). A point pops the
    stack while the turn is not left: at most P - 1 masked pops, each a
    no-op once its condition fails (the JAX while_loop)."""
    B, P, _ = pts.shape
    stack = pts.new_zeros((B, P, 2))
    size = torch.zeros((B,), dtype=torch.long, device=pts.device)
    rows = torch.arange(B, device=pts.device)
    for i in range(P):
        p = pts[:, i]
        for _ in range(i):
            a = stack[rows, (size - 2).clamp(min=0)]
            b = stack[rows, (size - 1).clamp(min=0)]
            cr = (b[:, 0] - a[:, 0]) * (p[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (p[:, 0] - a[:, 0])
            size = size - ((size >= 2) & (cr <= 0)).long()
        stack[rows, size] = p
        size = size + 1
    return stack, size


def _convex_hull_area(points: torch.Tensor) -> torch.Tensor:
    """Area of the convex hull of each (B, P, 2) point set."""
    B, P, _ = points.shape
    # lexicographic (x, then y) stable order: sort by y, then stably by x
    o = torch.argsort(points[..., 1], dim=1, stable=True)
    o = torch.gather(o, 1, torch.argsort(torch.gather(points[..., 0], 1, o), dim=1, stable=True))
    pts = torch.gather(points, 1, o[..., None].expand_as(points))
    lower, nl = _half_hull(pts)
    upper, nu = _half_hull(pts.flip(1))
    # lower[:nl-1] + upper[:nu-1] as one hull polygon
    idx = torch.arange(2 * P, device=points.device)[None]
    low_valid = idx < (nl - 1)[:, None]
    verts = torch.where(low_valid[..., None],
                        torch.gather(lower, 1, idx.clamp(0, P - 1)[..., None].expand(B, -1, 2)),
                        0.0)
    up_idx = idx - (nl - 1)[:, None]
    up_valid = (up_idx >= 0) & (up_idx < (nu - 1)[:, None])
    verts = torch.where(up_valid[..., None],
                        torch.gather(upper, 1, up_idx.clamp(0, P - 1)[..., None].expand(B, -1, 2)),
                        verts)
    return polygon_area(verts, low_valid | up_valid)


def _inter_hull(boxes1, boxes2):
    cc1, cc2 = _pair_corners(boxes1, boxes2)
    N, M = boxes1.shape[0], boxes2.shape[0]
    inter = rect_intersection_area(cc1, cc2)
    hull = _convex_hull_area(torch.cat([cc1, cc2], -2).reshape(N * M, 8, 2)).reshape(N, M)
    return inter, hull


def giou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV GIoU (mot_3d/utils/geometry.py giou2d semantics)."""
    inter, hull = _inter_hull(boxes1, boxes2)
    a1 = (boxes1[:, 3] * boxes1[:, 4])[:, None]
    a2 = (boxes2[:, 3] * boxes2[:, 4])[None, :]
    union = a1 + a2 - inter
    return inter / torch.clamp(union, min=_EPS) - (hull - union) / torch.clamp(hull, min=_EPS)


def giou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D GIoU (mot_3d/utils/geometry.py:195-229 semantics)."""
    inter, hull = _inter_hull(boxes1, boxes2)
    z_overlap, z_union = _z_overlap_union(boxes1, boxes2)
    inter_vol = inter * z_overlap
    hull_vol = hull * z_union
    v1, v2 = _volumes(boxes1, boxes2)
    union_vol = v1 + v2 - inter_vol
    return (inter_vol / torch.clamp(union_vol, min=_EPS)
            - (hull_vol - union_vol) / torch.clamp(hull_vol, min=_EPS))


def pc_in_box(box7: torch.Tensor, pc: torch.Tensor, scale: float = 1.5) -> torch.Tensor:
    """Mask (P,) of the points pc (P, >=3) inside the scaled rotated box
    box7 (7,) [x, y, z, w, l, h, yaw] (mot_3d/utils/geometry.py:98-119)."""
    cx, cy, cz = box7[0], box7[1], box7[2]
    w, l, h = box7[3] * scale, box7[4] * scale, box7[5] * scale
    c, s = torch.cos(box7[6]), torch.sin(box7[6])
    dx = pc[:, 0] - cx
    dy = pc[:, 1] - cy
    rx = dx * c + dy * s
    ry = -dx * s + dy * c
    return (rx.abs() <= l / 2) & (ry.abs() <= w / 2) & ((pc[:, 2] - cz).abs() <= h / 2)


def center_distance(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV center L2 distance (gt_association/associate.py:107-113)."""
    d = boxes1[:, None, :2] - boxes2[None, :, :2]
    return torch.sqrt((d * d).sum(-1))


def m_distance(det: torch.Tensor, trk: torch.Tensor, inv_cov: torch.Tensor) -> torch.Tensor:
    """Mahalanobis distance between state vectors (geometry.py m_distance)."""
    diff = det - trk
    return torch.sqrt(diff @ inv_cov @ diff)


def score_rectification(dets_mot, gts_mot) -> np.ndarray:
    """Oracle score rectification (mot_3d/utils/geometry.py:274-304): set
    each detection's score to its best 3D IoU with an unclaimed GT
    (claimed in descending-best-IoU order; duplicates 0.2, misses 0.05).

    Host utility over mot-layout rows [x, y, z, yaw, l, w, h, (s)];
    returns the rectified score vector. The IoUs are the port's iou_3d in
    f32 on the CPU."""
    dets_mot = np.asarray(dets_mot, np.float64).reshape(
        -1, dets_mot.shape[-1] if len(dets_mot) else 8)
    n, m = len(dets_mot), len(gts_mot)
    if m == 0 or n == 0:
        return np.zeros((n,), np.float64)

    def to_geom(b):
        # mot [x,y,z,yaw,l,w,h] -> geometry [x,y,z,w,l,h,yaw]
        b = np.asarray(b, np.float64)
        return torch.as_tensor(np.stack([b[:, 0], b[:, 1], b[:, 2], b[:, 5], b[:, 4],
                                         b[:, 6], b[:, 3]], 1), dtype=torch.float32)

    iou = iou_3d(to_geom(dets_mot), to_geom(np.asarray(gts_mot))).numpy()
    max_idx = np.argmax(iou, axis=1)
    max_iou = np.max(iou, axis=1)
    order = list(reversed(sorted(range(n), key=lambda k: max_iou[k])))
    out = np.empty((n,), np.float64)
    claimed: set[int] = set()
    for i in order:
        if max_iou[i] >= 0.1 and max_idx[i] not in claimed:
            out[i] = max_iou[i]
            claimed.add(int(max_idx[i]))
        elif max_iou[i] >= 0.1:
            out[i] = 0.2
        else:
            out[i] = 0.05
    return out
