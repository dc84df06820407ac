"""Port's decision rules, greedy assignment and scan tracker against the
JAX package on the same inputs (CPU). Ids and flags must match exactly;
refined scores to 1e-6 (both sides compute them in f32)."""
import numpy as np
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
from shasta_tpu_torch.tracker.greedy import greedy_assign


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


@pytest.mark.parametrize("seed", range(3))
def test_greedy_assign_matches(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 5, size=(9, 14)).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = 1e18
    d[:, 3] = d[:, 4]  # ties: the first free column wins
    np.testing.assert_array_equal(greedy_assign(torch.from_numpy(d)).numpy(),
                                  np.asarray(greedy_assign_jax(jnp.asarray(d))))


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
