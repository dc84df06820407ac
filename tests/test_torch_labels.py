"""The port's GT affinity labels (shasta_tpu_torch/preprocessing/) against
the JAX package's associate_l2, frame_gt_matrices and _mot_rows, exactly,
and the labelled train split of write_track_split: its labels equal JAX's
frame_gt_matrices of the same files, and both packages' datasets read the
same training samples from it."""
import json
import os
import zlib

import numpy as np
import pytest

from shasta_tpu.data.nuscenes import (NuScenesTrackDataset as JDataset,
                                      PointPipelineConfig as JPipeline)
from shasta_tpu.preprocessing import associate as jassoc, gt_shasta as jgt
from shasta_tpu.preprocessing.nuscenes_chain import _mot_rows as jmot_rows

from shasta_tpu_torch.data.nuscenes import NuScenesTrackDataset, PointPipelineConfig
from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
from shasta_tpu_torch.preprocessing import associate, gt_shasta
from shasta_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = ["car", "pedestrian", "bus"]
GT_TYPES = {"car": "vehicle.car", "pedestrian": "human.pedestrian.adult",
            "bus": "vehicle.bus.rigid"}


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(a, b)


def _frame(rng, ids, detect, fps=2):
    """GT mot rows of objects `ids` (centres seeded by the id), types,
    and det rows of the ids in `detect` (within 0.5 m) plus fps false
    positives far away, scores random."""
    pos = {i: np.random.default_rng(zlib.crc32(i.encode())).uniform(-40, 40, 2) for i in ids}
    kind = {i: TYPES[sum(map(ord, i)) % 3] for i in ids}
    gt = np.zeros((len(ids), 8))
    gt[:, :2] = [pos[i] for i in ids]
    dets = np.zeros((len(detect) + fps, 8))
    dets[:len(detect), :2] = [pos[i] + rng.uniform(-0.5, 0.5, 2) for i in detect]
    dets[len(detect):, :2] = rng.uniform(60, 80, (fps, 2))
    dets[:, 7] = rng.uniform(0, 1, len(dets))
    dtypes = [kind[i] for i in detect] + list(rng.choice(TYPES, fps))
    return dets, dtypes, gt, [GT_TYPES[kind[i]] for i in ids], list(ids)


def test_associate_l2_matches_jax():
    rng = np.random.default_rng(0)
    for case in range(20):
        M, N = rng.integers(0, 9), rng.integers(0, 9)
        gt = rng.uniform(-5, 5, (M, 8))
        pred = rng.uniform(-5, 5, (N, 8 if case % 2 else 3))
        gtt = [GT_TYPES[t] for t in rng.choice(TYPES, M)]
        pt = list(rng.choice(TYPES, N))
        scores = rng.uniform(0, 1, N) if case % 3 == 0 else None
        got = associate.associate_l2(gt, gtt, pred, pt, 2.0, scores)
        assert got == jassoc.associate_l2(gt, gtt, pred, pt, 2.0, scores), case


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_gt_matrices_match_jax(seed):
    """A scene start; then a pair with a match, FN tracks (detected before,
    missed now, still in the GT), dead tracks (a vanished object, false
    positives) and a newborn; then seeded random pairs."""
    rng = np.random.default_rng(seed)
    start = _frame(rng, ["a", "b"], ["a", "b"])
    prev = _frame(rng, ["a", "b", "c", "d"], ["a", "b", "c", "d"])
    curr = _frame(rng, ["a", "b", "c", "e"], ["a", "e"])
    pairs = [((None,) * 5, start), (prev, curr)]
    for _ in range(4):
        ids = [f"o{i}" for i in rng.choice(12, 8, replace=False)]
        nxt = [f"o{i}" for i in rng.choice(12, 8, replace=False)]
        pairs.append((_frame(rng, ids, [i for i in ids if rng.random() < 0.8]),
                      _frame(rng, nxt, [i for i in nxt if rng.random() < 0.8])))
    for p, c in pairs:
        got = gt_shasta.frame_gt_matrices(*p, *c)
        want = jgt.frame_gt_matrices(*p, *c)
        _same(got[0], want[0])
        _same(got[1], want[1])
    matched, newborn = gt_shasta.frame_gt_matrices(*prev, *curr)
    assert matched[0, 0] == 1 and matched[1, -1] == matched[2, -1] == 1  # a; b, c FN
    assert matched[3, -2] == 1 and (matched[4:, -2] == 1).all()  # d vanished; FPs
    assert newborn[1] == 1 and newborn.sum() == 1  # e


def test_mot_rows_match_jax():
    rng = np.random.default_rng(4)
    rows = [list(rng.normal(size=n)) for n in (10, 11, 12, 13)]
    np.testing.assert_array_equal(gt_shasta.mot_rows(rows), jmot_rows(rows))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_split")
    base = write_split_config(
        os.path.join(REPO, "configs", "nusc", "car.py"), {}, str(tmp / "base.py"),
        max_objects=10,
        point_pipeline=dict(voxel_size=(0.3, 0.3, 0.2),
                            pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0), max_voxels=3000,
                            nsweeps=3))
    sp = write_track_split(tmp / "data", Config.fromfile(base), n_scenes=2, n_frames=4, seed=5,
                           n_objects=16, n_points=2000, n_spots=500, split="train")
    return dict(sp, base=base)


def test_train_split_labels_equal_jax_on_its_files(split):
    kw = split["train"]
    assert kw["test_mode"] is False and os.path.isdir(kw["labels_path"])
    gt_dir = split["gt_info_dir"]
    prev, flags = None, np.zeros(3)
    for tok in split["tokens"]:
        with open(os.path.join(kw["cls_info_path"], tok + ".json")) as f:
            cls = json.load(f)
        with open(os.path.join(gt_dir, tok + ".json")) as f:
            gt = json.load(f)
        curr = (jmot_rows([c["translation"] + c["size"] + c["rotation"]
                           + [c["detection_score"]] for c in cls]),
                [c["detection_name"] for c in cls], jmot_rows(gt["frame_bboxes"]),
                gt["frame_types"], gt["frame_ids"])
        start = tok.endswith("f0")
        matched, newborn = jgt.frame_gt_matrices(*((None,) * 5 if start else prev), *curr)
        with np.load(os.path.join(kw["labels_path"], tok + ".npz"), allow_pickle=True) as d:
            got = d["matched"]
            _same(None if got.ndim != 2 else got, matched)
            np.testing.assert_array_equal(d["newborn"], newborn)
        if matched is not None:
            flags += [matched[:, :-2].sum(), matched[:, -2].sum(), matched[:, -1].sum()]
        prev = curr
    assert (flags > 0).all(), flags  # matches, dead and FN columns all occur


def test_train_split_reads_the_same_in_both_packages(split):
    """Training samples (test_mode False: GT matrices subsampled with the
    dataset's generator) are bit-equal in the two packages."""
    cfg = Config.fromfile(split["base"])
    kw = dict(split["train"], det_type=["car"], max_objects=10, fp_ratio=1 / 3,
              dead_trk_ratio=1 / 3, seed=3, load_points=False)
    ours = NuScenesTrackDataset(**kw, pipeline=PointPipelineConfig(**cfg.point_pipeline))
    theirs = JDataset(**kw, pipeline=JPipeline(**cfg.point_pipeline))
    assert len(ours) == len(split["tokens"])
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        for k in ("gt", "det_boxes", "prev_det_boxes"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["num_det_boxes"] == b["num_det_boxes"]
