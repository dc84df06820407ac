"""The port's training CLIs on the CPU at a small configuration, against
the JAX package:

- `tools.train --smoke` and one epoch over a labelled synthetic train split
  (write_track_split(split="train")) write epoch_1.pth and one
  train_log.jsonl row per step; `--resume` continues from the latest
  epoch_N.pth; the JAX package's load_checkpoint reads the .pth and its
  forward equals the port's at 1e-4;
- `tools.cache_features` writes a cache that the JAX CachedFeatureDataset
  reads into the same samples as the port's, and each `feat` equals JAX
  frame_features of the same batch of frames at 1e-4 (the last batch
  padded with its last frame);
- `tools.train --cached_features` runs an epoch on that cache.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.data.nuscenes import (CachedFeatureDataset as JCached,
                                      NuScenesTrackDataset as JDataset,
                                      PointPipelineConfig as JPipeline, collate as jcollate)
from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
from shasta_tpu.train.checkpoint import load_checkpoint as jload_checkpoint

from shasta_tpu_torch.data.nuscenes import CachedFeatureDataset, NuScenesTrackDataset, collate
from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
from shasta_tpu_torch.tools import cache_features, train
from shasta_tpu_torch.tools.common import build_dataset, load_model
from shasta_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    max_objects=10,
    model=dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-12.0, -12.0),
               voxel_size=(0.3, 0.3), cap_conv2=2000, cap_conv3=1000, cap_conv4=500,
               cap_extra=500),
    point_pipeline=dict(voxel_size=(0.3, 0.3, 0.2), pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                        max_voxels=3000, nsweeps=3))
JAX_ONLY = ("type", "use_pallas_gather", "assume_sorted_voxels")


def _jmodel(cfg):
    return JModel(JConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg.model.items() if k not in JAX_ONLY}))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    base = write_split_config(os.path.join(REPO, "configs", "nusc", "car.py"), {},
                              str(tmp / "base.py"), **SMALL)
    sp = write_track_split(tmp / "data", Config.fromfile(base), n_scenes=2, n_frames=3, seed=7,
                           n_objects=16, n_points=4000, n_spots=1000, split="train")
    cfg_path = write_split_config(base, {}, str(tmp / "train.py"), data=dict(
        train=sp["train"], samples_per_device=2, workers=1))
    work = str(tmp / "work")
    out = train.main(["--config", cfg_path, "--cpu", "--work_dir", work, "--epochs", "1"])
    return dict(sp, tmp=tmp, config=cfg_path, work=work, out=out)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_smoke_and_resume(tmp_path, split):
    work = str(tmp_path / "smoke")
    out = train.main(["--config", split["config"], "--cpu", "--smoke", "--work_dir", work,
                      "--epochs", "1"])
    assert os.path.isfile(os.path.join(work, "epoch_1.pth")) and len(out["losses"][0]) == 3
    assert [r["step"] for r in _rows(os.path.join(work, "train_log.jsonl"))] == [0, 1, 2]
    out = train.main(["--config", split["config"], "--cpu", "--smoke", "--work_dir", work,
                      "--epochs", "2", "--resume"])
    assert len(out["losses"]) == 1 and os.path.isfile(os.path.join(work, "epoch_2.pth"))
    assert len(_rows(os.path.join(work, "train_log.jsonl"))) == 6


def test_train_epoch_checkpoint_loads_in_jax(split):
    out, work = split["out"], split["work"]
    n_pairs = len(split["tokens"])  # every frame is a pair's curr frame
    assert out["steps_per_epoch"] == n_pairs // 2 and "no_grad" in out["route"]
    rows = _rows(os.path.join(work, "train_log.jsonl"))
    assert len(rows) == out["steps_per_epoch"] and all(np.isfinite(r["loss"]) for r in rows)
    ckpt = os.path.join(work, "epoch_1.pth")
    cfg = Config.fromfile(split["config"])
    model = load_model(cfg, ckpt, "cpu")
    jvars = jax.tree.map(jnp.asarray, jload_checkpoint(ckpt))
    ds = build_dataset(cfg, "train", load_points=True)
    batch = collate([ds[i] for i in (1, 4)])
    keys = ("det_boxes", "prev_det_boxes") + tuple(
        p + k for p in ("", "prev_") for k in ("voxels", "num_points", "coordinates",
                                                "voxels_valid"))
    with torch.no_grad():
        m1, m2 = model({k: batch[k] for k in keys})
    jm1, jm2 = jax.jit(_jmodel(cfg).apply)(jvars, {k: jnp.asarray(batch[k]) for k in keys})
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm1), atol=1e-4)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), atol=1e-4)


def test_cache_features_read_by_jax_and_cached_training(split):
    cfg = Config.fromfile(split["config"])
    ckpt = os.path.join(split["work"], "epoch_1.pth")
    cache = str(split["tmp"] / "cache")
    res = cache_features.main(["--config", split["config"], "--cpu", "--checkpoint", ckpt,
                               "--out", cache, "--batch", "4"])
    n = len(split["tokens"])
    assert res["frames"] == n and res["batches"] == 2
    assert sorted(os.listdir(cache)) == sorted(t + ".npz" for t in split["tokens"])

    # both packages' cached datasets read the same training samples
    kw = dict(split["train"], det_type=["car"], max_objects=10, fp_ratio=cfg.fp_ratio,
              dead_trk_ratio=cfg.dead_trk_ratio, seed=2, load_points=False)
    ours = CachedFeatureDataset(NuScenesTrackDataset(**kw), cache)
    theirs = JCached(JDataset(**kw), cache)
    for i in range(n):
        a, b = ours[i], theirs[i]
        for k in ("feat", "prev_feat", "gt", "det_boxes"):
            np.testing.assert_array_equal(a[k], b[k])

    # feat equals JAX frame_features of the same padded batches of frames
    pp = dict(cfg.point_pipeline, shuffle_points=False)
    vox = JDataset(**dict(split["train"], test_mode=True, labels_path=None),
                   det_type=["car"], max_objects=10, pipeline=JPipeline(**pp))
    jvars = jax.tree.map(jnp.asarray, jload_checkpoint(ckpt))
    feats = jax.jit(lambda v, f: _jmodel(cfg).apply(v, f, method=JModel.frame_features))
    for start in (0, 4):
        group = [vox[i] for i in range(start, min(start + 4, n))]
        batch = jcollate(group + [group[-1]] * (4 - len(group)))
        want = np.asarray(feats(jvars, {k: jnp.asarray(batch[k]) for k in (
            "voxels", "num_points", "coordinates", "voxels_valid", "det_boxes")}))
        for gi, s in enumerate(group):
            with np.load(os.path.join(cache, s["token"] + ".npz")) as d:
                assert d["feat"].dtype == np.float32
                np.testing.assert_allclose(d["feat"], want[gi], atol=1e-4)

    work = str(split["tmp"] / "cached_work")
    out = train.main(["--config", split["config"], "--cpu", "--work_dir", work, "--epochs", "1",
                      "--cached_features", cache])
    assert out["route"].startswith("cached") and len(out["losses"][0]) == n // 2
    assert all(np.isfinite(out["losses"][0])) and os.path.isfile(os.path.join(work, "epoch_1.pth"))
