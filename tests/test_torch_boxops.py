"""The port's device box ops against the JAX package (CPU): the voxelizer,
the NMS suite, the rotated-box geometry and the rigid transforms.

Tolerances: the tensor voxelizer and NMS keep masks exact against their
JAX counterparts (points_to_voxel_jax, rotate_nms_jax); IoU/GIoU and the
other geometry in f32 at 1e-5 (the same f32 arithmetic in another
framework); the numpy copies (points_to_voxel_np, grid_size, the host NMS
functions, transforms) byte-identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.core import geometry as jgeom
from shasta_tpu.core import transforms as jtf
from shasta_tpu.ops import nms as jnms
from shasta_tpu.ops import voxelize as jvox

from shasta_tpu_torch.core import geometry as tgeom
from shasta_tpu_torch.core import transforms as ttf
from shasta_tpu_torch.ops import nms as tnms
from shasta_tpu_torch.ops import voxelize as tvox

# (points, span, voxel size, range, max points, max voxels): the second binds the cap
VOX = {"free": (3000, 3.0, [0.25, 0.25, 0.5], [-2, -2, -2, 2, 2, 2], 6, 4000),
       "capped": (3000, 2.0, [0.1, 0.1, 0.1], [-2, -2, -2, 2, 2, 2], 3, 200)}


def _points(n, span, seed, C=5):
    rng = np.random.default_rng(seed)
    # clustered so that voxels hold several points
    centers = rng.uniform(-span, span, size=(n // 10, 3))
    pts = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 0.05, (n, 3))
    return np.concatenate([pts, rng.normal(size=(n, C - 3))], 1).astype(np.float32)


@pytest.mark.parametrize("case", list(VOX))
def test_points_to_voxel_np_copy_is_byte_identical(case):
    n, span, vs, cr, P, M = VOX[case]
    pts = _points(n, span, seed=1)
    for got, want in zip(tvox.points_to_voxel_np(pts, vs, cr, P, M),
                         jvox.points_to_voxel_np(pts, vs, cr, P, M)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    g = tvox.grid_size(vs, cr)
    assert g.dtype == jvox.grid_size(vs, cr).dtype
    assert g.tobytes() == jvox.grid_size(vs, cr).tobytes()


@pytest.mark.parametrize("case", list(VOX))
def test_points_to_voxel_equals_the_jax_voxelizer(case):
    n, span, vs, cr, P, M = VOX[case]
    pts = _points(n, span, seed=2)
    got = tvox.points_to_voxel(torch.from_numpy(pts), vs, cr, P, M)
    want = jvox.points_to_voxel_jax(jnp.asarray(pts), vs, cr, P, M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k = int(got[3].sum())
    assert k == M if case == "capped" else 0 < k < M


def test_points_to_voxel_holds_the_np_voxels_in_key_order():
    """Below the cap, the tensor voxelizer's voxels are the numpy
    voxelizer's (arrival order), sorted by their zyx grid key: exact."""
    n, span, vs, cr, P, M = VOX["free"]
    pts = _points(n, span, seed=3)
    v, c, nump, valid = (t.numpy() for t in tvox.points_to_voxel(torch.from_numpy(pts), vs,
                                                                   cr, P, M))
    vn, cn, nn = tvox.points_to_voxel_np(pts, vs, cr, P, M)
    gs = tvox.grid_size(vs, cr)
    order = np.argsort((cn[:, 0].astype(np.int64) * gs[1] + cn[:, 1]) * gs[0] + cn[:, 2])
    k = int(valid.sum())
    assert k == len(cn)
    np.testing.assert_array_equal(c[:k], cn[order])
    np.testing.assert_array_equal(nump[:k], nn[order])
    np.testing.assert_array_equal(v[:k], vn[order])


def _geom_boxes(rng, n, span=10.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-span, span, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(1, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("seed,thresh", [(0, 0.3), (1, 0.1), (2, 0.5)])
def test_rotate_nms_keep_mask_equals_the_jax_nms(seed, thresh):
    rng = np.random.default_rng(seed)
    boxes = _geom_boxes(rng, 40, span=6.0)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    got = tnms.rotate_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh).numpy()
    want = np.asarray(jnms.rotate_nms_jax(jnp.asarray(boxes), jnp.asarray(scores), thresh))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    # and the host copy keeps the same boxes
    np.testing.assert_array_equal(np.sort(tnms.rotate_nms_np(boxes, scores, thresh)),
                                  np.nonzero(want)[0])


def test_rotate_nms_np_copy_is_byte_identical():
    rng = np.random.default_rng(4)
    boxes = _geom_boxes(rng, 30, span=5.0)
    scores = rng.uniform(0, 1, 30).astype(np.float32)
    for kw in ({}, {"pre_max_size": 20, "post_max_size": 6}):
        got = tnms.rotate_nms_np(boxes, scores, 0.2, **kw)
        want = jnms.rotate_nms_np(boxes, scores, 0.2, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_circle_nms_np_copy_is_byte_identical():
    rng = np.random.default_rng(5)
    dets = np.concatenate([rng.uniform(-5, 5, (50, 2)), rng.uniform(0, 1, (50, 1))], 1)
    for post in (None, 7):
        got = tnms.circle_nms_np(dets, 1.0, post)
        want = jnms.circle_nms_np(dets, 1.0, post)
        assert got.tobytes() == want.tobytes()


def _det(x, y, s, yaw=0.0, l=4.0, w=2.0, h=1.5, z=0.0):
    return np.array([x, y, z, yaw, l, w, h, s])


WEIGHTED = {
    "votes": (np.stack([_det(0.0, 0.0, 0.9), _det(0.2, 0.0, 0.6), _det(-0.2, 0.0, 0.3),
                        _det(30.0, 0.0, 0.8)]), ["car"] * 4),
    "types": (np.stack([_det(0, 0, 0.9), _det(0.1, 0, 0.5)]), ["car", "pedestrian"]),
    "yaw_outlier": (np.stack([_det(0.0, 0.0, 0.9, yaw=0.0), _det(0.05, 0.0, 0.8, yaw=0.02),
                              _det(-0.05, 0.0, 0.7, yaw=2.0)]), ["car"] * 3),
    "empty": (np.zeros((0, 8)), []),
}


@pytest.mark.parametrize("case", list(WEIGHTED))
def test_weighted_nms_copy_is_byte_identical(case):
    dets, types = WEIGHTED[case]
    got, got_types = tnms.weighted_nms(dets, types)
    want, want_types = jnms.weighted_nms(dets, types)
    assert got_types == want_types
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_mot_to_geometry_rows_equals_the_jax_package():
    from shasta_tpu.mot.bbox import MotBBox

    rows = np.random.default_rng(6).normal(size=(9, 8))
    assert tnms.mot_to_geometry_rows(rows).tobytes() == MotBBox.to_geometry_rows(rows).tobytes()


PAIRWISE = ("iou_bev", "iou_3d", "giou_bev", "giou_3d", "center_distance")


@pytest.mark.parametrize("fn", PAIRWISE)
def test_pairwise_geometry_matches_jax(fn):
    """Random boxes, many overlapping, plus copies of some (IoU 1) and
    axis-aligned ones: f32 at 1e-5."""
    rng = np.random.default_rng(7)
    b1 = _geom_boxes(rng, 12, span=3.0)
    b2 = np.concatenate([_geom_boxes(rng, 9, span=3.0), b1[:3]])
    b2[0, 6] = b1[4, 6] = 0.0
    got = getattr(tgeom, fn)(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    want = np.asarray(getattr(jgeom, fn)(jnp.asarray(b1), jnp.asarray(b2)))
    assert got.shape == (12, 12)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if fn != "center_distance":
        assert (want > 0.05).sum() >= 5  # overlaps, not only zeros


def test_rect_intersection_and_polygon_area_match_jax():
    rng = np.random.default_rng(8)
    b1, b2 = _geom_boxes(rng, 16, span=2.0), _geom_boxes(rng, 16, span=2.0)
    c1 = tgeom.corners_bev(torch.from_numpy(b1))
    c2 = tgeom.corners_bev(torch.from_numpy(b2))
    from shasta_tpu.core.boxes import corners_bev as jcorners

    np.testing.assert_allclose(c1.numpy(), np.asarray(jcorners(jnp.asarray(b1))), atol=1e-5)
    got = tgeom.rect_intersection_area(c1, c2).numpy()
    want = np.asarray(jgeom.rect_intersection_area(jcorners(jnp.asarray(b1)),
                                                   jcorners(jnp.asarray(b2))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (want > 0).sum() >= 4
    mask = np.arange(8)[None] < rng.integers(0, 9, (16, 1))
    verts = rng.normal(size=(16, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tgeom.polygon_area(torch.from_numpy(verts), torch.from_numpy(mask)).numpy(),
        np.asarray(jgeom.polygon_area(jnp.asarray(verts), jnp.asarray(mask))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_pc_in_box_matches_jax(scale):
    rng = np.random.default_rng(9)
    box = np.array([1.0, 2.0, 0.0, 2.0, 4.0, 2.0, 0.7], np.float32)
    pts = (rng.normal(size=(500, 3)) * 2.5 + box[:3]).astype(np.float32)
    got = tgeom.pc_in_box(torch.from_numpy(box), torch.from_numpy(pts), scale).numpy()
    want = np.asarray(jgeom.pc_in_box(jnp.asarray(box), jnp.asarray(pts), scale))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_m_distance_matches_jax():
    rng = np.random.default_rng(10)
    det, trk = rng.normal(size=(2, 7)).astype(np.float32)
    a = rng.normal(size=(7, 7)).astype(np.float32)
    inv_cov = (a @ a.T + 7 * np.eye(7)).astype(np.float32)
    got = float(tgeom.m_distance(*(torch.from_numpy(x) for x in (det, trk, inv_cov))))
    want = float(jgeom.m_distance(*(jnp.asarray(x) for x in (det, trk, inv_cov))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_score_rectification_matches_jax():
    """The JAX function takes its IoUs from the C++ runtime, the port's from
    its own iou_3d: scores at 1e-5, the claims exact."""
    gt = np.array([[0, 0, 0, 0.0, 4, 2, 1.6], [10, 3, 0, 0.4, 4.5, 2, 1.5]])
    dets = np.array([[0.1, 0, 0, 0.0, 4, 2, 1.6, 0.9],
                     [0.5, 0.3, 0, 0.0, 4, 2, 1.6, 0.8],
                     [30, 30, 0, 0.0, 4, 2, 1.6, 0.7],
                     [10.3, 3.1, 0.1, 0.5, 4.4, 2.1, 1.5, 0.6]])
    got = tgeom.score_rectification(dets, gt)
    want = jgeom.score_rectification(dets, gt)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[1] == want[1] == 0.2 and got[2] == want[2] == 0.05
    assert tgeom.score_rectification(dets, np.zeros((0, 7))).tobytes() == np.zeros(4).tobytes()


def _pose(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q), rng.normal(size=3) * 5


TRANSFORMS = {
    "quat_to_rotmat": lambda m, r: m.quat_to_rotmat(_pose(r)[0]),
    "quat_multiply": lambda m, r: m.quat_multiply(_pose(r)[0], _pose(r)[0]),
    "quat_inverse": lambda m, r: m.quat_inverse(r.normal(size=4)),
    "velo2world": lambda m, r: m.velo2world(r.normal(size=(4, 4)), r.normal(size=2)),
    "quat_slerp": lambda m, r: np.stack([m.quat_slerp(_pose(r)[0], _pose(r)[0], t)
                                         for t in (0.0, 0.3, 1.0)]),
    "transform_points": lambda m, r: m.transform_points(r.normal(size=(20, 3)), *_pose(r)),
    "inverse_transform_points": lambda m, r: m.inverse_transform_points(
        r.normal(size=(20, 3)), *_pose(r)),
    "global_to_sensor_box": lambda m, r: np.concatenate(m.global_to_sensor_box(
        r.normal(size=3), _pose(r)[0], *_pose(r)[::-1], *_pose(r)[::-1])),
    "sensor_to_global_box": lambda m, r: np.concatenate(m.sensor_to_global_box(
        r.normal(size=3), _pose(r)[0], *_pose(r)[::-1], *_pose(r)[::-1])),
}


@pytest.mark.parametrize("fn", list(TRANSFORMS))
def test_transforms_copy_is_byte_identical(fn):
    got = TRANSFORMS[fn](ttf, np.random.default_rng(11))
    want = TRANSFORMS[fn](jtf, np.random.default_rng(11))
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
