"""Port's decision rules, greedy assignment and scan tracker against the
JAX package on the same inputs (CPU). Ids and flags must match exactly;
refined scores to 1e-6 (both sides compute them in f32)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.infer import default_tracker_params as jparams
from shasta_tpu.tracker import scan_tracker as jst
from shasta_tpu.tracker.decision import apply_decision_rules as jdecide
from shasta_tpu.tracker.greedy import greedy_assign_jax

from shasta_tpu_torch.infer import default_tracker_params
from shasta_tpu_torch.tracker import scan_tracker as tst
from shasta_tpu_torch.tracker.decision import apply_decision_rules
from shasta_tpu_torch.tracker.greedy import greedy_assign, greedy_assign_plain

from test_torch_greedy_kernel import JAX_CASES, case as greedy_case


def _softmaxes(rng, N, sharp):
    logits = rng.normal(size=(N + 2, N + 2)).astype(np.float32) * sharp
    e = np.exp(logits - logits.max())
    m1 = e[:N] / e[:N].sum(1, keepdims=True)
    m2 = e[:, :N] / e[:, :N].sum(0, keepdims=True)
    return m1.astype(np.float32), m2.astype(np.float32)


@pytest.mark.parametrize("max_age,merged", [(4, True), (2, False)])
def test_tracker_params_equal_the_jax_packages(max_age, merged):
    """The port's copy of the tracker constants gives the same parameters."""
    want = jparams(max_age=max_age, merged=merged)
    got = default_tracker_params(max_age=max_age, merged=merged)
    assert (got.max_age, got.merged_mode) == (want.max_age, want.merged_mode)
    for name in ("gates", "alpha", "beta", "refine"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_decision_rules_match(seed):
    rng = np.random.default_rng(seed)
    N = 12
    m1, m2 = _softmaxes(rng, N, sharp=4.0)
    n_prev, n_curr = int(rng.integers(0, N + 1)), int(rng.integers(0, N + 1))
    want = jdecide(jnp.asarray(m1), jnp.asarray(m2), n_prev, n_curr)
    got = apply_decision_rules(torch.from_numpy(m1), torch.from_numpy(m2), n_prev, n_curr)
    for g, w, name in zip(got, want, got._fields):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("case", JAX_CASES)
def test_greedy_assign_matches(case):
    """The plain loop, and `greedy_assign` on a CPU tensor, against the JAX
    scan lane by lane (cases: tests/test_torch_greedy_kernel.py): random
    matrices with ties ("0"-"2"), the dist of the serving step at 180 x 900
    for 1 and 7 lanes, equal minima, rows with nothing below THRESH, rows
    whose candidates earlier rows took, M of 45 and 1500, negative values;
    no row or no column: every row unmatched."""
    d = greedy_case(case)
    lanes = d if d.ndim == 3 else d[None]
    if 0 in lanes.shape:
        want = np.full(lanes.shape[:2], -1)
    else:
        want = np.asarray(jax.vmap(greedy_assign_jax)(jnp.asarray(lanes)))
    want = want.reshape(d.shape[:-1])
    assert (want >= 0).any() or 0 in d.shape
    for fn in (greedy_assign_plain, greedy_assign):
        got = fn(torch.from_numpy(d))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)


def test_greedy_assign_on_the_cpu_is_the_plain_loop():
    """A CPU tensor takes the plain route: no kernel launch, nothing counted
    under tracker.greedy_launches while a profiler records; a row holding a
    NaN matches nothing (the loop's min is NaN), as the kernel copies; the
    kernel's entry refuses a CPU tensor."""
    from shasta_tpu_torch.ops.kernels.greedy import greedy_rows
    from shasta_tpu_torch.utils import profiler

    d = torch.from_numpy(greedy_case("nan"))
    launches = greedy_rows.launches
    profiler.reset_counters()
    try:
        with torch.profiler.profile():
            got = greedy_assign(d)
            assert "tracker.greedy_launches" not in profiler.counters()
    finally:
        profiler.reset_counters()
    assert greedy_rows.launches == launches
    assert torch.equal(got, greedy_assign_plain(d))
    assert (got[0, 3] == -1) and (got[1, 9:11] == -1).all() and (got >= 0).sum() > 10
    with pytest.raises(ValueError, match="CUDA"):
        greedy_rows(d)


def _frame_dets(rng, N, prev_ct):
    """Random det rows (class-major), some continuing last frame's dets."""
    n = int(rng.integers(1, N))
    cls = np.full(N, -1, np.int32)
    cls[:n] = np.sort(rng.integers(0, 3, size=n))
    ct = rng.uniform(-10, 10, (N, 2)).astype(np.float32)
    if prev_ct is not None:
        k = min(n, len(prev_ct))
        ct[:k] = prev_ct[:k] + rng.normal(0, 0.3, (k, 2))
    valid = np.arange(N) < n
    valid &= rng.random(N) > 0.1
    return dict(
        ct=ct, velocity=rng.normal(0, 0.5, (N, 2)).astype(np.float32),
        cls=np.where(valid, cls, -1).astype(np.int32),
        score=rng.uniform(0.2, 1, N).astype(np.float32),
        ref_score=rng.uniform(0, 1, N).astype(np.float32),
        newborn=rng.random(N) < 0.3, dead=rng.random(N) < 0.15, valid=valid)


@pytest.mark.parametrize("merged", [True, False])
def test_scan_tracker_matches_over_frames(merged):
    rng = np.random.default_rng(7)
    N, cap = 10, 10 * 3
    jp = jparams(max_age=2, merged=merged)
    tp = default_tracker_params(max_age=2, merged=merged)
    jtab, jid = jst.TrackTable.empty(cap), jnp.int32(0)
    ttab, tid_ = tst.TrackTable.empty(cap, "cpu"), torch.zeros((), dtype=torch.int32)
    prev = None
    for _ in range(8):
        d = _frame_dets(rng, N, prev)
        prev = d["ct"]
        jtab, jid, jt, ju, jr = jst.step_frame(
            jtab, jid, jst.FrameDets(**{k: jnp.asarray(v) for k, v in d.items()}),
            jnp.float32(0.5), jp)
        ttab, tid_, tt, tu, tr = tst.step_frame(
            ttab, tid_, tst.FrameDets(**{k: torch.from_numpy(v) for k, v in d.items()}),
            torch.tensor(0.5), tp)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
        assert int(tid_) == int(jid)
        for name in ttab._fields:
            np.testing.assert_allclose(getattr(ttab, name).numpy(),
                                       np.asarray(getattr(jtab, name)), atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_track_scene_matches_jax(seed):
    """The whole-scene scan on the frames of tests/test_scan_tracker.py:
    ids and used exact, refined scores to 1e-6; the default cap
    N*(max_age+1) and (F, N) outputs."""
    from test_scan_tracker import _params, _random_scene, _stack_frames

    frames_np, _ = _random_scene(np.random.default_rng(seed), F=8, max_real=6)
    frames = _stack_frames(frames_np, 8)
    lags = np.full(len(frames_np), 0.5, np.float32)
    jt, ju, jr = jst.track_scene(frames, jnp.asarray(lags), _params())
    jp = _params()
    tp = tst.TrackerParams(*(torch.tensor(np.asarray(v)) for v in jp[:4]), jp.max_age,
                           jp.merged_mode)
    tt, tu, tr = tst.track_scene(
        tst.FrameDets(*(torch.tensor(np.asarray(f)) for f in frames)),
        torch.from_numpy(lags), tp)
    assert tt.shape == tu.shape == tr.shape == (8, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    assert tu.any() and int(tt.max()) > 1
