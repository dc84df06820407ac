"""The port's step_chunk and track_cap against the JAX package (CPU, f32).

- ScenePipeline.step_chunk (T frames, with or without stacked plans)
  equals T step_frame calls of the port exactly (the same ops on the CPU),
  carried state included, and the JAX step_chunk (its XLA lax.scan): ids,
  used, keep and FN exact, refined scores to 1e-4
  (tests/test_infer_pipeline.py:117 rebuilt on the port);
- BatchedScenePipeline.step_chunk at 2 lanes, one lane reset inside the
  chunk, the same against step_frames and the JAX step_chunk
  (tests/test_batched_pipeline.py:65);
- a track_cap below 2N(max_age+1), where aged tracks outgrow the table,
  held against the JAX pipelines with the same cap.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from shasta_tpu.infer import BatchedScenePipeline as JBatched
from shasta_tpu.infer import ScenePipeline as JPipeline
from shasta_tpu.infer import default_tracker_params as jparams
from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.infer import FRAME_KEYS, BatchedScenePipeline, ScenePipeline
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.plans import attach_plans, frame_plans

SMALL = dict(max_obj=6, grid_shape=(41, 48, 48), pc_start=(-3.0, -3.0),
             cap_conv2=512, cap_conv3=256, cap_conv4=128, cap_extra=128)
FIELDS = ("tid", "used", "keep", "fn")
T, N_DETS = 4, 5


@pytest.fixture(scope="module")
def models():
    model = ShastaModel(ShastaConfig(**SMALL), device="cpu")
    variables = random_jax_variables(model, seed=3)
    load_jax_variables(model, variables)
    return model, JModel(JConfig(**SMALL)), jax.tree.map(jnp.asarray, variables)


def _scene(cfg, lanes, seed):
    """T frames of `lanes` scenes: each lane's voxels drift, its dets move
    along their velocity with noise, and lose one det on the third frame."""
    rng = np.random.default_rng(seed)
    bases = [make_batch(cfg, 1, 512, n_dets=N_DETS, seed=seed + lane) for lane in range(lanes)]
    boxes = [b["det_boxes"].copy() for b in bases]
    for b in boxes:
        b[0, :N_DETS, :2] = rng.uniform(-2.5, 0.5, (N_DETS, 2))
    frames, n_currs = [], []
    for t in range(T):
        parts = []
        for base, b in zip(bases, boxes):
            b[0, :N_DETS, :2] += b[0, :N_DETS, 7:9] * 0.1 + rng.normal(0, 0.05, (N_DETS, 2))
            f = {k: base[k] for k in FRAME_KEYS if k != "det_boxes"}
            f["voxels"] = f["voxels"] + np.float32(0.05 * t)
            f["det_boxes"] = b.copy()
            parts.append(f)
        frames.append({k: np.concatenate([p[k] for p in parts]) for k in FRAME_KEYS})
        n_currs.append([N_DETS - (t == 2)] * lanes)
    return frames, np.asarray(n_currs)


def _stack(frames):
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


def _assert_equal(got, want, atol):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    np.testing.assert_allclose(got.ref, want.ref, atol=atol)


@pytest.mark.parametrize("plans", ["stacked", "none"])
def test_step_chunk_equals_single_steps_and_the_jax_chunk(models, plans):
    model, jmodel, jvars = models
    frames, n_currs = _scene(model.cfg, 1, seed=0)
    n_currs, lags = n_currs[:, 0].tolist(), [0.5] * T
    if plans == "stacked":
        frames = [attach_plans(f, frame_plans(f["coordinates"][0], f["voxels_valid"][0],
                                               model.cfg)) for f in frames]
    single = ScenePipeline(model, cls_id=2)
    want = [single.step_frame(f, n, lag) for f, n, lag in zip(frames, n_currs, lags)]
    pipe = ScenePipeline(model, cls_id=2)
    got = pipe.step_chunk(_stack(frames), n_currs, lags)
    assert got.tid.shape == (T, 2 * model.cfg.max_obj) and got.keep.shape == (T, 6)
    for t in range(T):
        _assert_equal(StepAt(got, t), want[t], atol=0.0)
    for a, b in zip(pipe._table, single._table):
        assert a.equal(b)
    assert pipe._prev_feat.equal(single._prev_feat)
    np.testing.assert_array_equal(pipe._n_prev, single._n_prev)
    assert pipe._id_counts.equal(single._id_counts) and int(pipe._id_counts[0]) >= N_DETS

    jpipe = JPipeline(model=jmodel, variables=jvars, cls_id=2, params=jparams(max_age=4))
    jgot = jpipe.step_chunk({k: v for k, v in _stack(frames).items()
                             if not k.startswith("plan_")}, n_currs, lags)
    _assert_equal(got, jgot, atol=1e-4)


def test_batched_step_chunk_equals_step_frames_and_the_jax_chunk(models):
    model, jmodel, jvars = models
    B = 2
    frames, n_currs = _scene(model.cfg, B, seed=5)
    resets = np.zeros((T, B), bool)
    resets[0] = True
    resets[2, 1] = True  # lane 1 starts a new scene inside the chunk
    lags = np.full((T, B), 0.5, np.float32)
    single = BatchedScenePipeline(model, cls_id=2, batch=B)
    want = [single.step_frames(f, n, r, lag)
            for f, n, r, lag in zip(frames, n_currs, resets, lags)]
    pipe = BatchedScenePipeline(model, cls_id=2, batch=B)
    got = pipe.step_chunk(_stack(frames), n_currs, resets, lags)
    assert got.tid.shape == (T, B, 2 * model.cfg.max_obj)
    for t in range(T):
        _assert_equal(StepAt(got, t), want[t], atol=0.0)
    for a, b in zip(pipe._table, single._table):
        assert a.equal(b)
    np.testing.assert_array_equal(pipe._n_prev, single._n_prev)

    jpipe = JBatched(model=jmodel, variables=jvars, cls_id=2, params=jparams(max_age=4),
                     batch=B)
    _assert_equal(got, jpipe.step_chunk(_stack(frames), n_currs, resets, lags), atol=1e-4)


@pytest.mark.parametrize("lanes", [1, 2])
def test_track_cap_matches_jax(models, lanes):
    """track_cap = 2N + 2: at most two aged tracks survive a step. The dets
    jump away from their tracks, so tracks age out, and without the cap
    (a port pipeline beside it) more than two would be carried."""
    model, jmodel, jvars = models
    N2 = 2 * model.cfg.max_obj
    cap = N2 + 2
    frames, n_currs = _scene(model.cfg, lanes, seed=7)
    for t, f in enumerate(frames):
        f["det_boxes"][:, :, :2] += np.float32(8.0 * t)  # no det near its old track
    if lanes == 1:
        pipes = [ScenePipeline(model, cls_id=2, track_cap=cap), ScenePipeline(model, cls_id=2),
                 JPipeline(model=jmodel, variables=jvars, cls_id=2, params=jparams(max_age=4),
                           track_cap=cap)]
        steps = [[p.step_frame(f, n[0], 0.5) for p in pipes] for f, n in zip(frames, n_currs)]
        tables = [p._table for p in pipes]
    else:
        pipes = [BatchedScenePipeline(model, cls_id=2, batch=lanes, track_cap=cap),
                 BatchedScenePipeline(model, cls_id=2, batch=lanes),
                 JBatched(model=jmodel, variables=jvars, cls_id=2, params=jparams(max_age=4),
                          batch=lanes, track_cap=cap)]
        steps = [[p.step_frames(f, n, [t == 0] * lanes, [0.5] * lanes) for p in pipes]
                 for t, (f, n) in enumerate(zip(frames, n_currs))]
        tables = [p._table for p in pipes[:2]] + [pipes[2]._tables]  # the JAX pipeline's name
    table, uncapped, jtable = tables
    assert pipes[0].cap == cap and table.used.shape[-1] == cap
    assert uncapped.used.shape[-1] == N2 * 5
    for got, _, want in steps:
        _assert_equal(got, want, atol=1e-4)
    for field in ("used", "tid"):  # the port's one-lane table keeps its lane axis
        got = getattr(table, field).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jtable, field)).reshape(got.shape))
    # the cap binds: uncapped, more tracks age than the two slots hold
    assert int(uncapped.used[..., N2:].sum(-1).min()) > 2
    assert table.used[..., N2:].all()


class StepAt:
    """Step t of a chunk's StepOutput, with StepOutput's fields."""

    def __init__(self, out, t):
        self._out, self._t = out, t

    def __getattr__(self, field):
        return getattr(self._out, field)[self._t]
