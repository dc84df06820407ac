"""The port's host trackers against the JAX package's (numpy f64 on both
sides): greedy_assign_np and _assign on random gated matrices, and
PubTracker / PubTrackerMerged over a seeded multi-frame, multi-class det
stream. Outputs must be equal: matches exactly; per track its id, active,
age, flags and ref_detection_score (at 1e-12, both sides f64).
"""
import copy

import numpy as np
import pytest

from shasta_tpu.tracker import pub_tracker as jpt
from shasta_tpu.tracker.greedy import greedy_assign_np as jgreedy_assign_np

from shasta_tpu_torch.tracker import pub_tracker as tpt
from shasta_tpu_torch.tracker.greedy import greedy_assign_np

NAMES = tpt.NUSCENES_TRACKING_NAMES


def _gated(rng, N, M, share=0.3):
    dist = rng.uniform(0, 10, size=(N, M))
    dist[rng.random((N, M)) < share] = 1e18
    return dist


@pytest.mark.parametrize("seed", range(3))
def test_greedy_assign_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        N, M = int(rng.integers(0, 9)), int(rng.integers(0, 9))
        dist = _gated(rng, N, M)
        dist[:, :M // 2] = np.round(dist[:, :M // 2])  # ties: the first minimum wins
        got, want = greedy_assign_np(dist), jgreedy_assign_np(dist.copy())
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("hungarian", [False, True])
def test_assign_matches_jax(hungarian):
    """Greedy and Hungarian over matrices with gated pairs (> 1e16): the
    matches and the extra unmatched dets of a gated Hungarian pair."""
    rng = np.random.default_rng(7)
    extra_seen = 0
    for _ in range(40):
        N, M = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        dist = _gated(rng, N, M, share=0.5)
        got, want = tpt._assign(dist.copy(), hungarian), jpt._assign(dist.copy(), hungarian)
        assert got == want
        extra_seen += len(want[1])
    assert extra_seen > 0 or not hungarian


def _stream(seed, frames=12, objects=14):
    """Per frame (dets, time_lag): objects of all 7 classes moving at
    constant velocity, each detected with probability 0.8 with noise, plus
    false positives; ShaSTA flags (newborn, dead, FN) on some dets; frames
    2 and 7 have no det; class 'bus' misses every third frame."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, len(NAMES), objects)
    pos = rng.uniform(-20, 20, (objects, 2))
    vel = rng.normal(0, 1.5, (objects, 2))
    out = []
    for t in range(frames):
        lag = 0.5 if t % 5 else 0.45
        dets = []
        if t not in (2, 7):
            for o in range(objects):
                name = NAMES[cls[o]]
                if rng.random() > 0.8 or (name == "bus" and t % 3 == 0):
                    continue
                xy = pos[o] + 0.5 * t * vel[o] + rng.normal(0, 0.3, 2)
                d = {"sample_token": f"f{t}", "translation": [float(xy[0]), float(xy[1]), 0.5],
                     "size": [2.0, 4.5, 1.6], "rotation": [1.0, 0.0, 0.0, 0.0],
                     "velocity": [float(v) for v in vel[o] + rng.normal(0, 0.2, 2)],
                     "detection_name": name, "detection_score": float(rng.uniform(0.2, 1)),
                     "ref_detection_score": float(rng.uniform(0, 1)),
                     "attribute_name": "vehicle.moving"}
                r = rng.random()
                if r < 0.25:
                    d["newborn"] = True
                elif r < 0.35:
                    d["dead"] = True
                elif r < 0.45:
                    d["FN"] = True
                dets.append(d)
            for _ in range(int(rng.integers(0, 3))):  # false positives
                xy = rng.uniform(-20, 20, 2)
                dets.append({"sample_token": f"f{t}", "translation": [float(xy[0]), float(xy[1]), 0.5],
                             "size": [2.0, 4.5, 1.6], "rotation": [1.0, 0.0, 0.0, 0.0],
                             "velocity": [0.0, 0.0], "detection_name": NAMES[rng.integers(7)],
                             "detection_score": float(rng.uniform(0.1, 0.5)),
                             "ref_detection_score": float(rng.uniform(0, 1)),
                             "attribute_name": "vehicle.moving"})
        out.append((dets, lag))
    return out


def _same_tracks(got, want, where):
    assert len(got) == len(want), where
    for g, w in zip(got, want):
        assert list(g) == list(w), where
        for k, v in w.items():
            if k == "ref_detection_score":
                assert abs(g[k] - v) <= 1e-12, (where, g[k], v)
            elif isinstance(v, np.ndarray):
                assert np.array_equal(g[k], v), (where, k)
            else:
                assert g[k] == v, (where, k, g[k], v)


TRACKERS = {
    "single": lambda m, h, max_age: m.PubTracker(hungarian=h, max_age=max_age),
    "single_refined": lambda m, h, max_age: m.PubTracker(
        hungarian=h, max_age=max_age, refine_confidence=True, alpha=0.5, beta=0.4),
    "merged": lambda m, h, max_age: m.PubTrackerMerged(hungarian=h, max_age=max_age),
}


@pytest.mark.parametrize("kind", list(TRACKERS))
@pytest.mark.parametrize("hungarian", [False, True])
@pytest.mark.parametrize("max_age", [2, 4])
def test_trackers_match_jax(kind, hungarian, max_age):
    stream = _stream(seed=100 * list(TRACKERS).index(kind) + 10 * hungarian + max_age)
    got_t = TRACKERS[kind](tpt, hungarian, max_age)
    want_t = TRACKERS[kind](jpt, hungarian, max_age)
    aged = ids = 0
    for t, (dets, lag) in enumerate(stream):
        if t == 6:  # a scene start
            got_t.reset()
            want_t.reset()
        got = got_t.step_centertrack(copy.deepcopy(dets), lag)
        want = want_t.step_centertrack(copy.deepcopy(dets), lag)
        _same_tracks(got, want, (kind, t))
        assert got_t.id_count == want_t.id_count
        aged += sum(1 for w in want if w["active"] == 0)
        ids = max(ids, want_t.id_count)
    assert aged > 0 and ids > 5  # the stream ages tracks and hands out ids
