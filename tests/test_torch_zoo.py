"""The port's model zoo against the JAX package on the same inputs (CPU).

One random variable tree in the JAX layout (numpy, from a seed) drives
both sides through `load_jax_variables`. Tolerances: BEVMap's whole trunk
atol 2e-3 / rtol 1e-3 (tests/test_block_conv.py:127); pillars, dynamic
voxel means and psroi 1e-5; DCN 1e-4; coordinates, validity, counts and
the pillar canvas exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from shasta_tpu.models import ShastaConfig as JConfig
from shasta_tpu.models.bevmap import BEVMap as JBEVMap
from shasta_tpu.models.dynamic_voxel import (dynamic_voxelize as jdv,
                                             dynamic_voxelize_virtual as jdvv)
from shasta_tpu.models.pillars import PillarFeatureNet as JPFN
from shasta_tpu.models.pillars import point_pillars_scatter as jscatter
from shasta_tpu.ops.dcn import DeformConv2d as JDCN
from shasta_tpu.ops.dcn import deform_psroi_pooling as jpsroi

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.models import (BEVMap, ShastaConfig, ShastaModel, dynamic_voxelize,
                                     dynamic_voxelize_virtual)
from shasta_tpu_torch.models.pillars import PillarFeatureNet, point_pillars_scatter
from shasta_tpu_torch.ops.dcn import DeformConv2d, deform_psroi_pooling
from shasta_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
             cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)
FRAME_KEYS = ("voxels", "num_points", "coordinates", "voxels_valid")


def _trunk_tree(tree):
    return {col: {p: tree[col][p] for p in ("backbone", "neck")}
            for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def bevmap_case():
    """(ShastaModel, BEVMap, JAX tree, frame, BEVMap's map) at the small
    config, one tree for both models."""
    model = ShastaModel(ShastaConfig(**SMALL), device="cpu")
    tree = random_jax_variables(model, seed=3)
    load_jax_variables(model, tree)
    bev = BEVMap(ShastaConfig(**SMALL), device="cpu")
    load_jax_variables(bev, tree)
    frame = {k: v for k, v in make_batch(ShastaConfig(**SMALL), num_voxels_cap=3000,
                                         n_dets=4, seed=1).items() if k in FRAME_KEYS}
    with torch.no_grad():
        got = bev(frame)
    return model, bev, tree, frame, got


def test_bevmap_matches_jax(bevmap_case):
    """BEVMap (the unplanned route's plain versions) against the JAX
    BEVMap.apply: the (1, 10, 10, 512) neck map, channels last."""
    _, _, tree, frame, got = bevmap_case
    jm = JBEVMap(JConfig(**SMALL))
    want = np.asarray(jax.jit(jm.apply)(_trunk_tree(tree),
                                        {k: jnp.asarray(v) for k, v in frame.items()}))
    assert got.shape == (1, 10, 10, 512) and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)


def test_bevmap_state_dict_and_trunk_pth(bevmap_case, tmp_path):
    """The state_dict holds backbone.* and neck.* only; a trunk-only .pth
    that save_checkpoint wrote loads strictly and gives the same map."""
    _, bev, _, frame, got = bevmap_case
    assert {k.split(".")[0] for k in bev.state_dict()} == {"backbone", "neck"}
    path = str(tmp_path / "bev_map.pth")
    save_checkpoint(path, bev.state_dict())
    again = BEVMap(ShastaConfig(**SMALL), device="cpu")
    again.load_state_dict(load_checkpoint(path), strict=True)
    with torch.no_grad():
        assert torch.equal(again(frame), got)


def test_bevmap_with_shared_conv_is_bev_single(bevmap_case):
    """The served trunk (ShastaModel.bev_single) is the shared conv on
    BEVMap's map, with and without host plans."""
    from shasta_tpu_torch import plans as tp

    model, bev, _, frame, got = bevmap_case
    planned = tp.attach_plans(dict(frame), tp.frame_plans(
        frame["coordinates"][0], frame["voxels_valid"][0], model.cfg))
    with torch.no_grad():
        for f, m in ((frame, got), (planned, bev(planned))):
            mine = model.shared_conv(m.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            want = model.bev_single({k: torch.as_tensor(v) for k, v in f.items()})
            torch.testing.assert_close(mine, want, atol=1e-6, rtol=0)


def _pillar_inputs(rng, V=40, P=8, C=5):
    voxels = rng.normal(size=(V, P, C)).astype(np.float32) * 3
    num_points = rng.integers(0, P + 1, V).astype(np.int32)
    num_points[:3] = 0, P, 1  # an empty pillar, a full one, a single point
    coords = np.stack([np.zeros(V), rng.integers(0, 512, V), rng.integers(0, 512, V)],
                      1).astype(np.int32)
    return voxels, num_points, coords


@pytest.mark.parametrize("filters", [(64,), (32, 32)])
@pytest.mark.parametrize("train", [False, True])
def test_pillar_feature_net_matches_jax(rng, filters, train):
    """Eval mode, and train mode with its updated running statistics
    against flax's mutated batch_stats (the masked points count in the
    batch statistics on both sides)."""
    voxels, num_points, coords = _pillar_inputs(rng)
    pfn = PillarFeatureNet(filters, device="cpu")
    tree = random_jax_variables(pfn, seed=5)
    load_jax_variables(pfn, tree)
    jm = JPFN(num_filters=filters)
    args = [jnp.asarray(a) for a in (voxels, num_points, coords)]
    pfn.train(train)
    with torch.no_grad():
        got = pfn(*(torch.from_numpy(a) for a in (voxels, num_points, coords)))
    if train:
        want, upd = jm.apply(tree, *args, train=True, mutable=["batch_stats"])
        for i in range(len(filters)):
            bn = getattr(pfn, f"bn_{i}")
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(upd["batch_stats"][f"bn_{i}"]["mean"]),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(upd["batch_stats"][f"bn_{i}"]["var"]),
                                       atol=1e-5, rtol=1e-5)
    else:
        want = jm.apply(tree, *args, train=False)
    assert got.shape == (len(voxels), filters[-1])
    assert not got[0].any()  # the empty pillar pools to 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_point_pillars_scatter_matches_jax(rng):
    """Exact: distinct cells, invalid rows (one on a valid row's cell),
    negative indices that count from the end and indices out of range
    that drop."""
    V, C, B, ny, nx = 60, 6, 2, 16, 12
    cells = rng.choice(B * ny * nx, V, replace=False)
    coords = np.stack([cells // (ny * nx), np.zeros(V, int), (cells // nx) % ny, cells % nx],
                      1).astype(np.int32)
    valid = rng.random(V) > 0.2
    valid[:4] = True
    coords[0, 3] = -1  # x from the end: (.., nx - 1), a cell no other row takes
    coords[1, 2] = ny  # y out of range: dropped
    coords[2, 0] = B  # batch out of range: dropped
    coords[3, 0] = -1  # batch from the end
    for r in (0, 3):  # keep the wrapped cells distinct from every other row
        wrapped = (coords[r, 0] % B, coords[r, 2] % ny, coords[r, 3] % nx)
        others = [tuple(c) for c in coords[4:, [0, 2, 3]]]
        valid[4:][[o == wrapped for o in others]] = False
    valid[5] = False
    coords[5] = coords[6]
    feats = rng.normal(size=(V, C)).astype(np.float32)
    want = np.asarray(jscatter(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                               B, ny, nx))
    got = point_pillars_scatter(torch.from_numpy(feats), torch.from_numpy(coords),
                                torch.from_numpy(valid), B, ny, nx)
    assert got.shape == (B, ny, nx, C)
    np.testing.assert_array_equal(got.numpy(), want)


PC_RANGE = (-2.0, -2.0, -1.0, 2.0, 2.0, 1.0)
VOXEL = (0.5, 0.5, 0.5)


def _dv_points(rng, N, C):
    pts = rng.uniform(-2.5, 2.5, size=(N, C)).astype(np.float32)
    pts[:4, :3] = [[2.0, 2.0, 1.0], [-2.0, -2.0, -1.0], [2.0, 0.1, 0.1], [1.99, -0.3, 0.9]]
    valid = np.ones(N, bool)
    valid[-20:] = False
    pts[-20:] = 100.0  # padding garbage
    return pts, valid


@pytest.mark.parametrize("virtual", [False, True])
@pytest.mark.parametrize("max_voxels", [256, 12])
def test_dynamic_voxelize_matches_jax(rng, virtual, max_voxels):
    """Coordinates and validity exact, means at 1e-5 (the order of the
    sums differs); max_voxels 12 overflows. The edge points: the upper
    corner (dropped: it floors to the grid size), the lower corner (kept)."""
    pts, valid = _dv_points(rng, 400, 16 if virtual else 5)
    if virtual:
        pts[:, -2] = rng.choice([1.0, 0.0, -1.0], size=len(pts))
    jf, tf = (jdvv, dynamic_voxelize_virtual) if virtual else (jdv, dynamic_voxelize)
    want = [np.asarray(a) for a in jax.jit(jf, static_argnums=(2, 3, 4))(
        jnp.asarray(pts), jnp.asarray(valid), PC_RANGE, VOXEL, max_voxels)]
    got = [a.numpy() for a in tf(torch.from_numpy(pts), torch.from_numpy(valid), PC_RANGE,
                                 VOXEL, max_voxels)]
    n = int(want[2].sum())
    assert (n == max_voxels) == (max_voxels == 12) and n > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == want[0].shape == (max_voxels, 21 if virtual else 5)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv_matches_jax(rng, modulated):
    """Random offset-conv weights (taps off the grid, some outside the
    map) on both sides, at 1e-4."""
    x = rng.normal(size=(2, 9, 7, 4)).astype(np.float32)
    m = DeformConv2d(4, 6, modulated=modulated, device="cpu")
    tree = random_jax_variables(m, seed=7)
    load_jax_variables(m, tree)
    want = np.asarray(jax.jit(JDCN(6, modulated=modulated).apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, 9, 7, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_deform_conv_zero_offsets_is_a_plain_conv(rng):
    """At init the offset conv is zero: the taps sit on the grid and the
    deformable conv is the plain 3x3 conv with the (K*C, F) kernel."""
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    m = DeformConv2d(4, 6, modulated=False, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.bias.normal_(generator=torch.Generator().manual_seed(1))
        got = m(x)
        w = m.kernel.reshape(3, 3, 4, 6).permute(3, 2, 0, 1)
        want = F.conv2d(x.permute(0, 3, 1, 2), w, m.bias, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


PSROI = dict(spatial_scale=0.5, output_dim=4, group_size=2, pooled_size=3, sample_per_part=2)


def _psroi_inputs(rng):
    data = rng.normal(size=(2, 12, 14, 16)).astype(np.float32)
    rois = np.array([[0, 1.2, 2.7, 20.0, 18.0],  # partly out of bounds
                     [1, 0.0, 0.0, 8.0, 6.0],
                     [0, 5.0, 5.0, 5.4, 5.2],  # tiny: the 0.1 clamp
                     [1, -40.0, -40.0, -30.0, -30.0],  # fully out: count 0
                     [0, 2.5, 3.5, 9.5, 10.5]],  # halves: round to even
                    np.float32)
    trans = rng.normal(size=(len(rois), 4, 3, 3)).astype(np.float32)
    return data, rois, trans


@pytest.mark.parametrize("with_trans", [False, True])
def test_deform_psroi_pooling_matches_jax(rng, with_trans):
    """Forward at 1e-5 and counts exact; the gradients of sum(out**2)
    with respect to data and trans against jax.grad at 1e-5."""
    data, rois, trans = _psroi_inputs(rng)
    kw = dict(PSROI, trans_std=0.3 if with_trans else 0.0)

    def jfwd(d, t):
        return jpsroi(d, jnp.asarray(rois), t, **kw)

    def jloss(d, t):
        return jnp.sum(jfwd(d, t)[0] ** 2)

    jt = jnp.asarray(trans) if with_trans else None
    want, want_c = jax.jit(jfwd)(jnp.asarray(data), jt)
    td = torch.from_numpy(data).requires_grad_()
    tt = torch.from_numpy(trans).requires_grad_() if with_trans else None
    got, got_c = deform_psroi_pooling(td, torch.from_numpy(rois), tt, **kw)
    assert got.shape == (5, 3, 3, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert not got_c[3].any() and got_c.sum() > 0
    (got ** 2).sum().backward()
    if with_trans:
        gd, gt = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(data), jt)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), atol=1e-5, rtol=1e-5)
        assert np.abs(np.asarray(gt)).sum() > 0
    else:
        gd = jax.jit(jax.grad(jloss))(jnp.asarray(data), None)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), atol=1e-5, rtol=1e-5)
    assert np.abs(np.asarray(gd)).sum() > 0
