"""Estimate per-class Kalman P/Q/R covariances from GT trajectories: the port
of tools/estimate_stats.py.

Behavioral reference: preprocessing/nusc_dataset_stats.py:22-97 and
waymo_dataset_stats.py (whose `stat_estimation` import is missing from the
reference repo). Reads the preprocessed artifact tree, writes
{P,Q,R}_{name}.json that mot.covariance.NuCovariance reads.

    python -m shasta_tpu_torch.tools.estimate_stats --data data/nusc_preprocessed/train_2hz \\
        --det_name cp --out shasta_tpu_torch/mot/stats --name cp_2hz_mine
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..preprocessing.det_tools import _nu_to_mot
from ..preprocessing.stats import estimate_covariances, write_stats


def main(argv=None) -> tuple[dict, dict, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--det_name", default="cp")
    ap.add_argument("--out", required=True)
    ap.add_argument("--name", default="cp_2hz")
    ap.add_argument("--dt", type=float, default=0.5)
    ap.add_argument("--max_scenes", type=int, default=None)
    args = ap.parse_args(argv)

    det_dir = os.path.join(args.data, "detections", args.det_name, "dets")
    gt_dir = os.path.join(args.data, "gt_info")
    scenes = []
    names = sorted(f[:-4] for f in os.listdir(det_dir) if f.endswith(".npz"))
    if args.max_scenes:
        names = names[: args.max_scenes]
    for scene in names:
        dets = np.load(os.path.join(det_dir, scene + ".npz"), allow_pickle=True)
        gts = np.load(os.path.join(gt_dir, scene + ".npz"), allow_pickle=True)
        frames = []
        for fi in range(len(dets["bboxes"])):
            frames.append(dict(
                dets=_nu_to_mot(dets["bboxes"][fi]),
                det_types=list(dets["types"][fi]),
                gts=_nu_to_mot(gts["bboxes"][fi]),
                gt_types=[t.split(".")[-1] for t in gts["types"][fi]],
                gt_ids=list(gts["ids"][fi]),
            ))
        scenes.append({"frames": frames, "dt": args.dt})

    P, Q, R = estimate_covariances(scenes)
    write_stats(P, Q, R, args.out, args.name)
    print(f"wrote P/Q/R_{args.name}.json for classes {sorted(P)} -> {args.out}")
    return P, Q, R


if __name__ == "__main__":
    main()
