"""Precompute frozen-trunk BEV descriptors for cached affinity training:
the port of tools/cache_features.py.

The reference recomputes both frames' BEV trunks for every training pair,
every epoch (train.py:195-215), though the trunk is frozen (train.py:
184-191): the descriptors are constants of (weights, frame). This tool
computes each frame's (max_obj, num_point*C) descriptors once, frames
batched through the unplanned trunk (`bev_single`: 12 sorted_lookup + 21
gather_conv launches per batch on the card), and stores them per token as
{token}.npz key 'feat', f32 (np.savez_compressed), a cache that either
package reads; training then runs the affinity head alone
(tools.train --cached_features). The last group is padded with its last
frame. Several comma-separated configs share one trunk pass per batch,
each sampling its own descriptors into {out}/{config stem}/.

    python -m shasta_tpu_torch.tools.cache_features --config configs/nusc/car.py \\
        --checkpoint bev_map.pth --split train --out work_dirs/feat_cache/car [--cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.bilinear import sample_bev_features
from ..core.boxes import box_points_5
from ..data.nuscenes import NuScenesTrackDataset, PointPipelineConfig, collate
from ..device import upload
from ..infer import FRAME_KEYS
from ..utils import Config
from .common import load_model, model_config


def _split_kwargs(cfg, split: str) -> dict:
    """cfg's dataset kwargs of `split` in test mode (descriptors need no GT
    and no augmentation), points in file order."""
    pp = dict(cfg.point_pipeline)
    pp["shuffle_points"] = False
    kw = dict(cfg.data[split])
    kw["test_mode"] = True
    kw.pop("labels_path", None)
    return dict(**kw, det_type=list(cfg.det_type), max_objects=cfg.max_objects,
                pipeline=PointPipelineConfig(**pp))


def main(argv=None) -> dict:
    """Returns {"frames", "batches", "out_dirs", "read_s", "trunk_s",
    "write_s"} (seconds per batch: reading and voxelizing its frames, the
    trunk and sampling until the descriptors are on the host, writing)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nusc/car.py",
                    help="one config, or comma-separated per-class configs sharing the "
                         "frozen trunk -> {out}/{config_stem}/")
    ap.add_argument("--checkpoint", default=None,
                    help="trunk checkpoint (bev_map or full model, .pth); seed-0 init if absent")
    ap.add_argument("--split", default="train")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=8, help="frames per trunk pass")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    args = ap.parse_args(argv)

    paths = args.config.split(",")
    cfgs = [Config.fromfile(p) for p in paths]
    model = load_model(cfgs[0], args.checkpoint, "cpu" if args.cpu else "cuda")
    if args.checkpoint:
        print(f"loaded {args.checkpoint}")
    vox_ds = NuScenesTrackDataset(**_split_kwargs(cfgs[0], args.split))
    entries = []  # (ShastaConfig, box dataset, out dir)
    for p, cfg in zip(paths, cfgs):
        out_dir = os.path.join(args.out, os.path.basename(p)[:-3]) if len(paths) > 1 else args.out
        os.makedirs(out_dir, exist_ok=True)
        entries.append((model_config(cfg),
                        NuScenesTrackDataset(**_split_kwargs(cfg, args.split), load_points=False),
                        out_dir))

    n, B = len(vox_ds), args.batch
    out = {"frames": n, "batches": 0, "out_dirs": [e[2] for e in entries], "read_s": [],
           "trunk_s": [], "write_s": []}
    for start in range(0, n, B):
        t0 = time.perf_counter()
        idxs = list(range(start, min(start + B, n)))
        group = [vox_ds[i] for i in idxs]
        batch = collate(group + [group[-1]] * (B - len(group)))
        boxes = []
        for _, box_ds, _ in entries:
            b = np.stack([box_ds[i]["det_boxes"] for i in idxs])
            boxes.append(np.concatenate([b, np.repeat(b[-1:], B - len(idxs), axis=0)]))
        t1 = time.perf_counter()
        feats = []
        with torch.no_grad():
            bev = model.bev_single({k: upload(batch[k], model.device) for k in FRAME_KEYS})
            for (mc, _, _), b in zip(entries, boxes):
                pts = box_points_5(upload(b, model.device)[:, :, :7])
                feats.append(sample_bev_features(bev, pts, mc.pc_start, mc.voxel_size,
                                                 mc.out_stride).float().cpu().numpy())
        t2 = time.perf_counter()
        for (_, _, out_dir), f in zip(entries, feats):
            for gi, s in enumerate(group):
                np.savez_compressed(os.path.join(out_dir, s["token"] + ".npz"), feat=f[gi])
        out["read_s"].append(t1 - t0)
        out["trunk_s"].append(t2 - t1)
        out["write_s"].append(time.perf_counter() - t2)
        out["batches"] += 1
        print(f"cached {min(start + B, n)}/{n}", end="\r")
    print(f"\nwrote {n} frames x {len(entries)} class(es) -> {args.out}")
    return out


if __name__ == "__main__":
    main()
