"""The traffic generator: the same seed gives the same traffic, every seed
the same class counts, shares as stated, detections within their caps."""
import numpy as np

from trackbench.gen.scenes import class_counts, detections, make_scene, objects_at, stream_scenes
from trackbench.tests.small import load, small


def test_class_counts_largest_remainder():
    mix = load("traffic", "stream")
    shares = [c["share"] for c in mix["classes"]]
    assert class_counts(shares, 80) == [46, 21, 8, 2, 1, 1, 1]
    assert sum(class_counts(shares, 13)) == 13


def test_same_seed_same_frames_and_other_seed_same_sizes():
    cfg, mix = small("shasta-nusc7", "stream")
    caps = {c["name"]: c["max_obj"] for c in cfg["classes"]}
    a = stream_scenes(2**31 + 5, mix, cfg["point_pipeline"], caps)
    b = stream_scenes(2**31 + 5, mix, cfg["point_pipeline"], caps)
    c = stream_scenes(11, mix, cfg["point_pipeline"], caps)
    assert len(a) == len(c) == mix["scenes"] and all(len(s) == mix["frames"] for s in a)
    for fa, fb, fc in zip(a[0], b[0], c[0]):
        for k in ("voxels", "coordinates", "num_points", "voxels_valid"):
            assert np.array_equal(fa[k], fb[k])
            assert fa[k].shape == fc[k].shape
        assert fa["boxes"].keys() == fb["boxes"].keys()
        assert all(np.array_equal(fa["boxes"][n], fb["boxes"][n]) for n in fa["boxes"])
    assert not np.array_equal(a[0][0]["coordinates"], c[0][0]["coordinates"])


def test_shares_fp_ratio_and_caps():
    mix = load("traffic", "stream")
    rng = np.random.default_rng(3)
    scene = make_scene(rng, mix, [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0], 10)
    kinds = np.bincount(scene["kinds"], minlength=7)
    assert kinds.tolist() == class_counts([c["share"] for c in mix["classes"]], mix["objects"])
    caps = {"car": 90, "pedestrian": 5}
    n_car, n_true = [], []
    for t in range(20):
        objs = objects_at(scene, t, mix)
        dets = detections(rng, scene, objs, mix, caps)
        names = [d[0] for d in dets]
        assert names.count("pedestrian") <= 5
        true_car = sum(1 for d in dets if d[0] == "car" and d[5] >= 0.3 and np.any(d[4]))
        n_car.append(names.count("car"))
        n_true.append(true_car)
    # ~46 cars detected at 0.85 plus a third as many false positives
    assert 45 <= np.mean(n_car) <= 58
    assert abs(np.mean(n_car) - np.mean(n_true) * 4 / 3) < 2
