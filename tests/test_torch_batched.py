"""The port's scene-batched step against the JAX package (CPU, f32): the
device index builders (exact), the unplanned trunk at B=2 (atol 2e-3 /
rtol 1e-3, tests/test_block_conv.py:127) and BatchedScenePipeline (ids,
used, keep and FN exact; refined scores to 1e-4), plus each port lane
against the port's single-scene ScenePipeline.

The JAX side runs its XLA path: build_subm_index / build_strided_plan in
the global layout, use_pallas_gather=False.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.infer import BatchedScenePipeline as JBatched
from shasta_tpu.infer import default_tracker_params as jparams
from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
from shasta_tpu.ops import sparse as sp

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.infer import FRAME_KEYS, BatchedScenePipeline, ScenePipeline
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.ops import sparse as tsp

GEOMS = {"down": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         "down_z_unpadded": ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
         "extra": ((3, 1, 1), (2, 1, 1), (0, 0, 0))}
SMALL = dict(max_obj=6, grid_shape=(41, 48, 48), pc_start=(-3.0, -3.0),
             cap_conv2=512, cap_conv3=256, cap_conv4=128, cap_extra=128)


def _make_frame_major(rng, B=2, shape=(6, 10, 10), per_lane_n=(20, 13),
                      per_lane_cap=32, C=4):
    """Frame-major fixed-capacity arrays (coords, valid, feats): lane b
    owns rows [b*cap, (b+1)*cap) with a padded tail that carries its frame
    id (a copy of tests/test_pallas_sparse.py:151-179)."""
    Z, Y, X = shape
    coords_l, feats_l, valid_l = [], [], []
    for b in range(B):
        n = per_lane_n[b]
        cs = set()
        while len(cs) < n:
            cs.add((b, int(rng.integers(Z)), int(rng.integers(Y)),
                    int(rng.integers(X))))
        cs = np.array(sorted(cs), np.int32)
        pad = np.zeros((per_lane_cap - n, 4), np.int32)
        pad[:, 0] = b
        coords_l.append(np.concatenate([cs, pad]))
        f = rng.normal(size=(per_lane_cap, C)).astype(np.float32)
        f[n:] = 0
        feats_l.append(f)
        valid_l.append(np.arange(per_lane_cap) < n)
    return np.concatenate(coords_l), np.concatenate(valid_l), np.concatenate(feats_l)


def _both(coords, valid, feats, shape, B=2):
    jst = sp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                          shape, B)
    tst = tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                           torch.from_numpy(valid), shape, B)
    return jst, tst


def test_subm_index_matches_xla_index(rng):
    jst, tst = _both(*_make_frame_major(rng), (6, 10, 10))
    got = tsp.build_subm_index(tst, tsp.key_table(tst)).gather.numpy()
    want = np.asarray(sp.build_subm_index(jst).gather)
    np.testing.assert_array_equal(got, want)
    assert (got < 64).sum() > 33  # neighbours beyond each row itself


@pytest.mark.parametrize("max_out", [160, 24])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_strided_plan_matches_xla_plan(rng, geom, max_out):
    """Output set, decode and gather index, exactly; max_out 24 binds
    (the global layout keeps the 24 smallest keys over both lanes)."""
    coords, valid, feats = _make_frame_major(rng, per_lane_n=(30, 22), per_lane_cap=40)
    jst, tst = _both(coords, valid, feats, (6, 10, 10))
    plan = tsp.build_strided_plan(tst, *GEOMS[geom], max_out, tsp.key_table(tst))
    want = sp.build_strided_plan(jst, *GEOMS[geom], max_out)
    np.testing.assert_array_equal(plan.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(plan.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(plan.index.gather.numpy(), np.asarray(want.gather))
    assert plan.out_shape == want.out_shape
    n_valid = int(plan.valid.sum())
    assert (n_valid == max_out) == (max_out == 24)
    # the next stage's presorted table and subm index (3x3x3 outputs)
    if GEOMS[geom][0] == (3, 3, 3):
        out = tsp.SparseTensor(None, plan.coords, plan.valid, plan.out_shape, 2)
        jout = sp.SparseTensor(jnp.zeros((max_out, 1)), want.coords, want.valid,
                               want.out_shape, 2)
        got = tsp.build_subm_index(out, tsp.key_table_presorted(out)).gather.numpy()
        np.testing.assert_array_equal(
            got, np.asarray(sp.build_subm_index(jout, table=sp.key_table_presorted(jout)).gather))


def _lane_frames(cfg, seeds, V):
    parts = [make_batch(cfg, num_voxels_cap=V, n_dets=4, seed=s) for s in seeds]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_unplanned_trunk_at_two_lanes_matches_xla_bev(rng):
    kw = dict(max_obj=6, grid_shape=(41, 32, 32),
              cap_conv2=512, cap_conv3=256, cap_conv4=128, cap_extra=128)
    model = ShastaModel(ShastaConfig(**kw), device="cpu")
    variables = random_jax_variables(model, seed=3)
    load_jax_variables(model, variables)
    b = _lane_frames(model.cfg, (3, 4), 128)
    want = np.asarray(JModel(JConfig(**kw)).apply(
        jax.tree.map(jnp.asarray, variables), {k: jnp.asarray(b[k]) for k in FRAME_KEYS},
        method=JModel.bev_single))
    with torch.no_grad():
        got = model.bev_single({k: torch.from_numpy(b[k]) for k in FRAME_KEYS}).numpy()
    assert got.shape == want.shape and got.shape[0] == 2
    assert np.abs(want).max() > 0 and not np.allclose(want[0], want[1])
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def _scene(cfg, seeds, V, n_dets, T):
    """T frames of B lanes: each lane's voxels from its seed, dets that
    move along their velocity, so tracks carry over."""
    rng = np.random.default_rng(0)
    base = _lane_frames(cfg, seeds, V)
    boxes = base["det_boxes"].copy()
    boxes[:, :n_dets, :2] = rng.uniform(-2.5, 2.5, (len(seeds), n_dets, 2))
    frames = []
    for t in range(T):
        f = {k: base[k] for k in ("voxels", "num_points", "coordinates", "voxels_valid")}
        f["voxels"] = f["voxels"] + np.float32(0.05 * t)
        boxes[:, :n_dets, :2] += (boxes[:, :n_dets, 7:9] * 0.5
                                  + rng.normal(0, 0.05, (len(seeds), n_dets, 2)))
        f["det_boxes"] = boxes.copy()
        frames.append(f)
    return frames


def test_batched_pipeline_matches_jax_and_single_scene_lanes():
    """2 lanes x 3 frames, lane 1 reset at frame 2: the port against the
    JAX BatchedScenePipeline, and each lane against a port ScenePipeline
    (ids less the lane's offset and, after a reset, the ids issued before
    it: the batched counters are never reset)."""
    B, T, n = 2, 3, 5
    model = ShastaModel(ShastaConfig(**SMALL), device="cpu")
    variables = random_jax_variables(model, seed=1)
    load_jax_variables(model, variables)
    pipe = BatchedScenePipeline(model, cls_id=2, batch=B)
    jpipe = JBatched(model=JModel(JConfig(**SMALL)),
                     variables=jax.tree.map(jnp.asarray, variables),
                     cls_id=2, params=jparams(max_age=4), batch=B)
    singles = [ScenePipeline(model, cls_id=2) for _ in range(B)]
    base = [0, 1_000_000]
    for t, frame in enumerate(_scene(model.cfg, (0, 1), 400, n, T)):
        reset = np.array([t == 0, t == 0 or t == 2])
        n_curr = [n, n - (t == 1)]
        for lane in np.where(reset & (t > 0))[0]:
            singles[lane].reset()
            base[lane] = int(pipe._id_counts[lane])
        got = pipe.step_frames(frame, n_curr, reset, [0.5, 0.5])
        want = jpipe.step_frames(frame, n_curr, reset, [0.5, 0.5])
        for field in ("tid", "used", "keep", "fn"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=f"{field} frame {t}")
        np.testing.assert_allclose(got.ref, want.ref, atol=1e-4)
        for lane in range(B):
            s = singles[lane].step_frame({k: v[lane:lane + 1] for k, v in frame.items()},
                                         n_curr[lane], 0.5)
            for field in ("used", "keep", "fn"):
                np.testing.assert_array_equal(getattr(got, field)[lane], getattr(s, field),
                                              err_msg=f"{field} lane {lane} frame {t}")
            np.testing.assert_array_equal(
                np.where(got.used[lane], got.tid[lane] - base[lane], 0),
                np.where(s.used, s.tid, 0), err_msg=f"tid lane {lane} frame {t}")
            np.testing.assert_allclose(got.ref[lane], s.ref, atol=1e-4)
            used_ids = got.tid[lane][got.used[lane]]
            assert ((used_ids > lane * 1_000_000) & (used_ids < (lane + 1) * 1_000_000)).all()
    assert got.used.any(axis=1).all() and got.tid.shape == (B, 2 * SMALL["max_obj"])
