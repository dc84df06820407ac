"""Port's model modules against the JAX package on the same weights (CPU, f32).

One random variable tree in the JAX layout (made with numpy from a seed)
drives both sides; `load_jax_variables` carries it into the port.
Tolerances: whole sparse trunk atol 2e-3 / rtol 1e-3 (as
tests/test_block_conv.py:127), neck + shared conv 1e-4, affinity 1e-5,
small tensor functions 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.core import bilinear as jbil
from shasta_tpu.core import boxes as jboxes
from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
from shasta_tpu.models.affinity import AffinityNet as JAffinity
from shasta_tpu.models.backbone import SparseBackbone as JBackbone
from shasta_tpu.models.rpn import RPN as JRPN, SharedConv as JShared
from shasta_tpu.models.vfe import voxel_mean_vfe as jvfe
from shasta_tpu.ops import sparse as sp
from shasta_tpu.train.convert import convert_shasta_checkpoint

from shasta_tpu_torch import plans as tp
from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.core import bilinear as tbil
from shasta_tpu_torch.core import boxes as tboxes
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.models import ShastaConfig, ShastaModel, voxel_mean_vfe
from shasta_tpu_torch.ops import sparse as tsp

SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
             cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)


@pytest.fixture(scope="module")
def small():
    """(port model, JAX-layout variables) at the small config."""
    model = ShastaModel(ShastaConfig(**SMALL), device="cpu")
    variables = random_jax_variables(model, seed=0)
    load_jax_variables(model, variables)
    return model, variables


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"].get(name, {})}


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def test_load_jax_variables_round_trip(small):
    """The port loads a tree of ShastaModel.init's structure strictly, and
    the JAX package's own converter maps the port's state_dict back onto
    the same tree."""
    model, variables = small
    cfg = JConfig(**SMALL)
    batch = {k: jnp.asarray(v) for k, v in
             make_batch(cfg, num_voxels_cap=64, n_dets=4, seed=0).items()}
    shapes = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0), batch))

    def flat(tree):
        return {jax.tree_util.keystr(p): tuple(leaf.shape)
                for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    assert flat(variables) == flat(shapes)
    back = convert_shasta_checkpoint(model.state_dict())
    _assert_tree_equal(back, variables)


def test_load_jax_variables_rejects_a_wrong_shape(small):
    model, variables = small
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["shared_conv"]["conv"]["bias"] = np.zeros((3,), np.float32)
    fresh = ShastaModel(ShastaConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError):
        load_jax_variables(fresh, bad)


def test_sparse_backbone_with_plans_matches_xla_trunk(small):
    model, variables = small
    cfg = model.cfg
    b = make_batch(cfg, num_voxels_cap=3000, n_dets=4, seed=1)
    V = b["coordinates"].shape[1]
    coords = np.concatenate([np.zeros((V, 1), np.int32), b["coordinates"][0]], 1)
    valid = b["voxels_valid"][0]
    feats = np.array(jvfe(jnp.asarray(b["voxels"][0]), jnp.asarray(b["num_points"][0])))
    jst = sp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                          cfg.grid_shape, 1)
    caps = dict(cap_conv2=cfg.cap_conv2, cap_conv3=cfg.cap_conv3,
                cap_conv4=cfg.cap_conv4, cap_extra=cfg.cap_extra)
    want = np.asarray(JBackbone(**caps).apply(_sub(variables, "backbone"), jst))
    plans = {k: torch.from_numpy(v) for k, v in
             tp.frame_plans(b["coordinates"][0], valid, cfg).items()}
    st = tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                          torch.from_numpy(valid), cfg.grid_shape, 1)
    with torch.no_grad():
        got = model.backbone(st, plans).permute(0, 2, 3, 1).numpy()  # NHWC
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_neck_and_shared_conv_match(small, rng):
    model, variables = small
    x = rng.normal(size=(1, 12, 12, 256)).astype(np.float32)
    neck = JRPN().apply(_sub(variables, "neck"), jnp.asarray(x))
    want = np.asarray(JShared(64).apply(_sub(variables, "shared_conv"), neck))
    with torch.no_grad():
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = model.shared_conv(model.neck(t)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 12, 12), (2, 10, 14)])
def test_neck_and_shared_conv_match_on_the_kernel_route(small, rng, monkeypatch, shape):
    """The route that f32 inference takes on the card (models/rpn.py
    `kernel_route`: packed weights, BN folded to scale and shift, NHWC maps,
    the deconv as a GEMM with a 2x2 store, both deblocks in one buffer),
    forced on the CPU, where dense_conv runs its plain version, against
    the JAX neck and shared conv; the second shape's half grid is odd."""
    from shasta_tpu_torch.models import rpn
    from shasta_tpu_torch.ops.kernels import dense_conv

    model, variables = small
    monkeypatch.setattr(rpn, "kernel_route", rpn.fusable)
    x = rng.normal(size=(*shape, 256)).astype(np.float32)
    neck = JRPN().apply(_sub(variables, "neck"), jnp.asarray(x))
    want = np.asarray(JShared(64).apply(_sub(variables, "shared_conv"), neck))
    before = dense_conv.dense_conv.launches
    with torch.no_grad():
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = model.shared_conv(model.neck(t))
    assert got.permute(0, 2, 3, 1).is_contiguous()  # the kernel route's NHWC storage
    assert dense_conv.dense_conv.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4)


@pytest.mark.parametrize("n_real", [None, 7])
def test_affinity_matches(small, rng, n_real):
    model, variables = small
    N = model.cfg.max_obj
    boxes = [rng.normal(size=(1, N, 11)).astype(np.float32) for _ in range(2)]
    for bx in boxes:
        bx[..., 3:6] = np.abs(bx[..., 3:6]) + 0.5
    feats = [rng.normal(size=(1, N, 320)).astype(np.float32) for _ in range(2)]
    pb, cb = boxes
    pf, cf = feats
    want = JAffinity(max_obj=N).apply(
        {"params": variables["params"]["affinity"]},
        jnp.asarray(pb[..., :7]), jnp.asarray(cb[..., :7]), jnp.asarray(cb[..., 7:9]),
        jnp.asarray(cb[..., 9:10]), jnp.asarray(pf), jnp.asarray(cf), n_real=n_real)
    with torch.no_grad():
        got = model.head(*(torch.from_numpy(a) for a in (
            pb[..., :7], cb[..., :7], cb[..., 7:9], cb[..., 9:10], pf, cf)),
            n_real=n_real)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_boxes_bilinear_vfe_match(rng):
    boxes7 = rng.normal(size=(2, 6, 7)).astype(np.float32) * 3
    np.testing.assert_allclose(
        tboxes.box_points_5(torch.from_numpy(boxes7)).numpy(),
        np.asarray(jboxes.box_points_5(jnp.asarray(boxes7))), atol=1e-5)
    bev = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    pts = rng.uniform(-4, 4, size=(2, 6, 5, 3)).astype(np.float32)  # some off-map
    args = ((-3.0, -3.0), (0.075, 0.075), 8)
    np.testing.assert_allclose(
        tbil.sample_bev_features(torch.from_numpy(bev), torch.from_numpy(pts), *args).numpy(),
        np.asarray(jbil.sample_bev_features(jnp.asarray(bev), jnp.asarray(pts), *args)),
        atol=1e-5)
    vox = rng.normal(size=(30, 10, 5)).astype(np.float32)
    nump = rng.integers(0, 11, size=30).astype(np.int32)
    np.testing.assert_allclose(
        voxel_mean_vfe(torch.from_numpy(vox), torch.from_numpy(nump)).numpy(),
        np.asarray(jvfe(jnp.asarray(vox), jnp.asarray(nump))), atol=1e-5)


def test_synthetic_batch_is_the_same(rng):
    from shasta_tpu.data.synthetic import make_batch as jmake

    cfg = JConfig(**SMALL)
    a = make_batch(cfg, num_voxels_cap=500, n_dets=4, seed=3, with_gt=True)
    b = jmake(cfg, num_voxels_cap=500, n_dets=4, seed=3, with_gt=True)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
