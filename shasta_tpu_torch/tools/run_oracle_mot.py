"""Classical / oracle MOT ablations over the preprocessed artifact tree: the
port of tools/run_oracle_mot.py.

Behavioral reference: the mot_3d oracle configs in BASELINE.json (the
reference library has no CLI driver for these). Runs MOTModel (kf/velo/ma
motion models, greedy/bipartite association, iou/giou/m_dis/euler metrics)
or the oracle variants over per-scene det npz files and reports MOTA/MOTP
via the built-in accumulator. The iou/giou matrices run on the card unless
--cpu is given.

    python -m shasta_tpu_torch.tools.run_oracle_mot --data data/nusc_preprocessed/val_2hz \\
        --det_name cp [--oracle dets|kf] [--asso giou] [--motion kf] \\
        [--covariance nuscenes_cp_2hz] [--cpu]
"""
from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np

from ..device import resolve_device
from ..mot import FrameData, MOTModel
from ..mot.metrics import MOTAccumulator
from ..mot.mot_model import DEFAULT_CONFIG
from ..preprocessing.det_tools import _nu_to_mot


def scene_names(data: str, det_name: str = "cp", max_scenes: int | None = None) -> list[str]:
    """The scenes of a {split}_2hz tree that have a det npz, sorted."""
    det_dir = os.path.join(data, "detections", det_name, "dets")
    names = sorted(f[:-4] for f in os.listdir(det_dir) if f.endswith(".npz"))
    return names[:max_scenes] if max_scenes else names


def scene_frames(data: str, det_name: str, scene: str) -> list[FrameData]:
    """The scene's frames as MOTModel inputs: mot rows of its detections and
    GT boxes, 0.5 s apart."""
    dets = np.load(os.path.join(data, "detections", det_name, "dets", scene + ".npz"),
                   allow_pickle=True)
    gts = np.load(os.path.join(data, "gt_info", scene + ".npz"), allow_pickle=True)
    return [FrameData(dets=_nu_to_mot(dets["bboxes"][fi]), det_types=list(dets["types"][fi]),
                      gt_dets=_nu_to_mot(gts["bboxes"][fi]), gt_types=list(gts["types"][fi]),
                      gt_ids=list(gts["ids"][fi]), time_stamp=0.5 * fi)
            for fi in range(len(dets["bboxes"]))]


def main(argv=None) -> tuple[dict, dict]:
    """Returns (the MOTA summary, {scene: each frame's output track ids})."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="{split}_2hz artifact dir")
    ap.add_argument("--det_name", default="cp")
    ap.add_argument("--oracle", default=None, choices=[None, "dets", "kf"])
    ap.add_argument("--asso", default="giou", choices=["iou", "giou", "m_dis", "euler"])
    ap.add_argument("--motion", default="kf", choices=["kf", "velo", "ma"])
    ap.add_argument("--match", default="bipartite", choices=["bipartite", "greedy"])
    ap.add_argument("--covariance", default="default")
    ap.add_argument("--max_scenes", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    args = ap.parse_args(argv)

    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["running"].update(
        asso=args.asso, motion_model=args.motion, match_type=args.match,
        covariance=args.covariance,
    )
    device = resolve_device("cpu" if args.cpu else "cuda")

    acc = MOTAccumulator()
    track_ids = {}
    for scene in scene_names(args.data, args.det_name, args.max_scenes):
        model = MOTModel(cfg, oracle=args.oracle, device=device)
        track_ids[scene] = []
        for frame in scene_frames(args.data, args.det_name, scene):
            g, gt_ids = frame.gt_dets, frame.gt_ids
            out = model.frame_mot(frame)
            hyp_ids = [tid for _, tid, state, _ in out]
            hyp_centers = [st[:2] for st, _, _, _ in out]
            acc.update(gt_ids, g[:, :2] if len(g) else np.zeros((0, 2)), hyp_ids, hyp_centers)
            track_ids[scene].append(hyp_ids)
        print(f"{scene}: running MOTA={acc.mota:.3f}")

    summary = acc.summary()
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return summary, track_ids


if __name__ == "__main__":
    main()
