"""The port's augmentation and detection evaluation against the JAX
package's (CPU, numpy).

shasta_tpu_torch.data.augment: each transform under the same
np.random.default_rng(seed) as shasta_tpu.data.augment, on the same points
and boxes (7 and 9 columns, or none), gives equal arrays, and both leave
their inputs as they were; with no generator both draw from np.random's
global state. shasta_tpu_torch.data.det_eval.evaluate_detection returns the
JAX function's dict (the tests/test_eval_metrics.py cases and a class
without GT, whose APs are NaN), and evaluate_detection_official prints
and returns None without the nuScenes devkit, as the JAX function does.
"""
import sys

import numpy as np
import pytest

from shasta_tpu.data import augment as jaugment
from shasta_tpu.data import det_eval as jdet_eval
from test_torch_chain import same_value

from shasta_tpu_torch.data import augment, det_eval


def _scene(seed, n_boxes, box_cols):
    rng = np.random.default_rng(seed)
    points = rng.normal(0.0, 20.0, (200, 5)).astype(np.float32)
    boxes = None if box_cols is None else rng.normal(0.0, 5.0, (n_boxes, box_cols))
    return points, boxes


TRANSFORMS = {
    "flip_x": lambda m, p, b, r: m.random_flip_x(p, b, rng=r),
    "flip_x always": lambda m, p, b, r: m.random_flip_x(p, b, rng=r, prob=1.1),
    "flip_y always": lambda m, p, b, r: m.random_flip_y(p, b, rng=r, prob=1.1),
    "flip_y never": lambda m, p, b, r: m.random_flip_y(p, b, rng=r, prob=0.0),
    "rotation": lambda m, p, b, r: m.global_rotation(p, b, rng=r),
    "rotation narrow": lambda m, p, b, r: m.global_rotation(p, b, rng=r, noise=(-0.1, 0.1)),
    "scaling": lambda m, p, b, r: m.global_scaling(p, b, rng=r),
    "translate": lambda m, p, b, r: m.global_translate(p, b, rng=r, std=0.2),
    "shuffle": lambda m, p, b, r: (m.shuffle_points(p, rng=r), b),
}


@pytest.mark.parametrize("box_cols", [None, 7, 9])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_augment_equals_jax(name, box_cols):
    for seed in range(3):
        points, boxes = _scene(seed, 6, box_cols)
        before = (points.copy(), None if boxes is None else boxes.copy())
        got = TRANSFORMS[name](augment, points, boxes, np.random.default_rng(seed))
        want = TRANSFORMS[name](jaugment, points, boxes, np.random.default_rng(seed))
        same_value(list(got), list(want))
        same_value([points, boxes], list(before))


def test_augment_chain_and_global_state_equal_jax():
    """A chain of every transform on one generator, and each transform with
    rng=None drawing from np.random's global state seeded alike."""
    points, boxes = _scene(9, 10, 9)
    outs = []
    for mod in (augment, jaugment):
        r = np.random.default_rng(11)
        p, b = mod.random_flip_x(points, boxes, rng=r)
        p, b = mod.random_flip_y(p, b, rng=r)
        p, b = mod.global_rotation(p, b, rng=r)
        p, b = mod.global_scaling(p, b, rng=r)
        p, b = mod.global_translate(p, b, rng=r)
        outs.append([mod.shuffle_points(p, rng=r), b])
    same_value(outs[0], outs[1])
    state = np.random.get_state()
    try:
        outs = []
        for mod in (augment, jaugment):
            np.random.seed(5)
            outs.append([mod.random_flip_x(points, boxes, prob=1.1), mod.global_rotation(points),
                         mod.global_scaling(points, boxes), mod.global_translate(points, boxes),
                         mod.shuffle_points(points)])
        same_value(outs[0], outs[1])
    finally:
        np.random.set_state(state)


def _det_frames(seed, n_frames=10, n_obj=5, keep=None, offset=0.1, classes=("car",)):
    rng = np.random.default_rng(seed)
    gt, results = {}, {}
    for f in range(n_frames):
        tok = f"t{f}"
        centers = rng.uniform(-30, 30, (n_obj, 2))
        names = [classes[k % len(classes)] for k in range(n_obj)]
        gt[tok] = [{"translation": [c[0], c[1], 0], "detection_name": n}
                   for c, n in zip(centers, names)]
        results[tok] = [{"translation": [c[0] + offset * rng.normal(), c[1], 0],
                         "detection_name": n, "detection_score": float(rng.random())}
                        for c, n in zip(centers[:keep], names[:keep])]
    return gt, results


@pytest.mark.parametrize("case", ["perfect", "half missing", "far", "two classes", "no gt class"])
def test_evaluate_detection_equals_jax(case):
    kw = {"perfect": {}, "half missing": dict(keep=2), "far": dict(offset=3.0),
          "two classes": dict(classes=("car", "pedestrian")), "no gt class": {}}[case]
    gt, results = _det_frames(len(case), **kw)
    classes = ["car", "pedestrian"] if case == "two classes" else ["car"]
    if case == "no gt class":
        classes = ["car", "bus"]
        results["t0"].append({"translation": [0.0, 0.0, 0.0], "detection_name": "bus"})
    got = det_eval.evaluate_detection(gt, results, classes)
    want = jdet_eval.evaluate_detection(gt, results, classes)
    same_value(got, want)
    assert list(got) == classes + ["mean_ap"] and 0.0 <= got["mean_ap"] <= 1.0
    if case == "perfect":
        assert got["mean_ap"] > 0.9
    if case == "half missing":
        assert 0.2 < got["mean_ap"] < 0.6
    if case == "no gt class":
        assert all(np.isnan(v) for v in got["bus"].values())


def test_evaluate_detection_official_without_devkit_equals_jax(tmp_path, capsys, monkeypatch):
    """Without the devkit (its import made to fail) both print one line and
    return None."""
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    args = (str(tmp_path / "res.json"), "v1.0-mini", "val", str(tmp_path), str(tmp_path))
    capsys.readouterr()
    assert det_eval.evaluate_detection_official(*args) is None
    port_out = capsys.readouterr().out
    assert jdet_eval.evaluate_detection_official(*args) is None
    assert capsys.readouterr().out == port_out == (
        "nuscenes devkit not available; use evaluate_detection instead\n")
