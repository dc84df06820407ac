"""The greedy-assignment kernel (`ops.kernels.greedy.greedy_rows`, the CUDA
route of `tracker.greedy.greedy_assign`) against the plain loop
`greedy_assign_plain`, element for element, on the cases below; and the
serving pipelines' steps on the card against the CPU route. Card tests only
(the kernel has no CPU mode); the CPU tests hold the plain loop to the JAX
package's scan on the same cases (tests/test_torch_tracker.py).
"""
import numpy as np
import pytest
import torch

from chip_smoke import tracker_dist
from shasta_tpu_torch.tracker.greedy import INVALID, THRESH, greedy_assign, greedy_assign_plain

SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
             cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)


def seeded(seed):
    """The (9, 14) matrices of the first test of the plain loop: half the
    entries BIG, column 3 a copy of column 4 (ties)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 5, size=(9, 14)).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = INVALID
    d[:, 3] = d[:, 4]
    return d


def ties(rng):
    """Small integer values, so rows hold many equal minima; -0 beside +0."""
    d = rng.integers(0, 3, (2, 40, 70)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = INVALID
    d[d == 0] = np.where(rng.random(int((d == 0).sum())) < 0.5, -0.0, 0.0)
    return d


def none_below(rng):
    """Rows with no entry below THRESH (THRESH itself, just above it, BIG,
    inf) among rows with a few."""
    d = rng.choice(np.float32([1e16, 2e16, 5e17, INVALID, np.inf]), (3, 20, 37))
    some = rng.random((3, 20)) < 0.5
    d[some, rng.integers(0, 37, int(some.sum()))] = rng.uniform(0, 1, int(some.sum()))
    d[:, ::4, 0] = np.nextafter(np.float32(THRESH), np.float32(0))  # the largest value below
    return d.astype(np.float32)


def taken_only(rng):
    """Twelve rows whose candidates lie among the same three columns: rows
    after the third find them taken and match nothing; a fourth column
    free to row 11 alone."""
    d = np.full((1, 12, 50), INVALID, np.float32)
    d[0, :, [7, 19, 33]] = rng.uniform(0, 1, (3, 12))
    d[0, 11, 48] = 0.5
    return d


def odd_width(rng):
    """M = 45 (not a multiple of 32), N = 33 (past one warp of rows)."""
    d = rng.uniform(0, 5, (3, 33, 45)).astype(np.float32)
    d[rng.random(d.shape) < 0.7] = INVALID
    return d


def wide(rng):
    """M = 1500 (above 1024): most rows hold hundreds of candidates; each
    odd row repeats the row before it, so it finds its minimum taken."""
    d = rng.uniform(0, 5, (2, 50, 1500)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = INVALID
    d[:, 1::2] = d[:, 0::2]
    d[:, 7] = INVALID  # one row with no candidate
    return d


def negative(rng):
    """Negative values, -0 and +0: the unsigned order of the float bits."""
    d = rng.uniform(-5, 5, (2, 30, 64)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = -0.0
    d[rng.random(d.shape) < 0.1] = 0.0
    d[rng.random(d.shape) < 0.5] = INVALID
    return d


def with_nan(rng):
    """NaN in some rows: the loop's min is then NaN, so the row gets -1."""
    d = rng.uniform(0, 5, (2, 16, 40)).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = INVALID
    d[0, 3, 17] = d[1, 9, 0] = d[1, 10, 39] = np.nan
    return d


CASES = {
    "0": lambda rng: seeded(0), "1": lambda rng: seeded(1), "2": lambda rng: seeded(2),
    "serve1": lambda rng: tracker_dist(1, 11), "serve7": lambda rng: tracker_dist(7, 12),
    "ties": ties, "none_below": none_below, "taken_only": taken_only, "odd_width": odd_width,
    "wide": wide, "negative": negative,
    "no_rows": lambda rng: np.zeros((2, 0, 30), np.float32),
    "no_columns": lambda rng: np.zeros((2, 5, 0), np.float32),
    "nan": with_nan,
}
# the JAX package's scan masks a taken column before its argmin, the loop
# adds INVALID: they differ where a taken column holds NaN
JAX_CASES = [c for c in CASES if c != "nan"]


def case(name: str) -> np.ndarray:
    return CASES[name](np.random.default_rng(sorted(CASES).index(name)))


@pytest.mark.gpu
def test_kernel_is_the_plain_version_on_the_card():
    """Every case, element for element, in one launch a case (none where a
    case has no row or no column), and a strided input refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from shasta_tpu_torch import resolve_device
    from shasta_tpu_torch.ops.kernels.greedy import greedy_rows

    dev = resolve_device("cuda")
    launches = greedy_rows.launches
    for name in CASES:
        d = torch.from_numpy(case(name))
        want = greedy_assign_plain(d)
        got = greedy_assign(d.to(dev))
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and torch.equal(got.cpu(), want), name
        assert (want >= 0).any() or name in ("no_rows", "no_columns"), name
    assert greedy_rows.launches == launches + len(CASES) - 2
    with pytest.raises(ValueError, match="contiguous"):
        greedy_assign(torch.from_numpy(case("odd_width")).to(dev).transpose(1, 2))


def small_frames(cfg, T=4):
    """T frames of one small scene: the voxels of one batch, the dets moving
    along their velocity, so most rows match the row they were."""
    from shasta_tpu_torch.data.synthetic import make_batch

    rng = np.random.default_rng(3)
    base = make_batch(cfg, num_voxels_cap=2500, n_dets=7, seed=0)
    boxes = base["det_boxes"].copy()
    boxes[0, :7, :2] = rng.uniform(-2.5, 2.5, (7, 2))
    frames = []
    for _ in range(T):
        boxes[0, :7, :2] += boxes[0, :7, 7:9] * 0.2 + rng.normal(0, 0.05, (7, 2))
        frames.append(dict(base, det_boxes=boxes.copy()))
    return frames


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["scene", "multiclass"])
def test_pipeline_steps_on_the_card_equal_the_cpu_route(kind):
    """A ScenePipeline (one lane) and a 3-class MultiClassScenePipeline
    (3 lanes) on the card against the same pipeline on the CPU: ids and used
    flags exact, scores to 1e-4 (the trunk's sums in another order); one
    kernel launch a step, and one `tracker.greedy_launches` a traced step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from shasta_tpu_torch.convert import (class_models_from_jax, load_jax_variables,
                                          random_jax_variables)
    from shasta_tpu_torch.infer import MultiClassScenePipeline, ScenePipeline
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.ops.kernels.greedy import greedy_rows
    from shasta_tpu_torch.utils import profiler

    classes = {"car": 10, "pedestrian": 8, "bus": 6}
    cfgs = {n: ShastaConfig(**dict(SMALL, max_obj=m)) for n, m in classes.items()}
    frames = small_frames(cfgs["car"])
    trees = {n: random_jax_variables(ShastaModel(c, device="cpu"), seed=40 + i)
             for i, (n, c) in enumerate(cfgs.items())}

    def step_fn(device):
        if kind == "scene":
            model = ShastaModel(cfgs["car"], device=device)
            load_jax_variables(model, trees["car"])
            pipe = ScenePipeline(model, cls_id=2)
            return lambda f: {"car": pipe.step_frame(f, 7, 0.5)}
        pipe = MultiClassScenePipeline(class_models_from_jax(cfgs, trees), trunk_key="car",
                                       device=device)
        return lambda f: pipe.step_frame(f, {n: (f["det_boxes"][:, :m], min(7, m))
                                             for n, m in classes.items()}, 0.5)

    runs = {}
    for device in ("cuda", "cpu"):
        step = step_fn(device)
        launches = greedy_rows.launches
        runs[device] = [step(f) for f in frames[:-1]]
        assert greedy_rows.launches - launches == (len(frames) - 1) * (device == "cuda")
        profiler.reset_counters()
        try:
            with torch.profiler.profile():
                runs[device].append(step(frames[-1]))
                counted = profiler.counters().get("tracker.greedy_launches", 0)
        finally:
            profiler.reset_counters()
        assert counted == (device == "cuda"), device
    matched = 0
    for t, (got, want) in enumerate(zip(runs["cuda"], runs["cpu"])):
        assert set(got) == set(want), t
        for n in want:
            assert np.array_equal(got[n].tid, want[n].tid), (t, n)
            assert np.array_equal(got[n].used, want[n].used), (t, n)
            np.testing.assert_allclose(got[n].ref, want[n].ref, atol=1e-4, rtol=0)
            if t:
                before = runs["cpu"][t - 1][n]
                matched += len(set(want[n].tid[want[n].used]) & set(before.tid[before.used]))
    assert matched > 0  # the assignment matched rows to tracks
