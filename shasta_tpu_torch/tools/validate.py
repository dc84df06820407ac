"""Validation: the affinity eval over the val split, tracking and scoring:
the port of tools/validate.py (tools/nusc_shasta/validate.py:24-301:
decision rules -> cp_val.json -> save_first_frame -> PubTracker ->
TrackingEval, plain and confidence-refined).

    python -m shasta_tpu_torch.tools.validate --config configs/nusc/car.py \\
        --checkpoint work_dirs/car/latest.pth --work_dir work_dirs/car/val3 [--cpu]

Runs on the card unless --cpu is given (validate(device="cpu")).
"""
from __future__ import annotations

import argparse
import json
import os

from ..tracker.runner import eval_tracking_lite, eval_tracking_nuscenes, save_first_frame, track
from ..utils import Config
from .common import load_model
from .eval import evaluate


def validate(config_path: str, checkpoint: str, work_dir: str, device=None,
             run_official_eval: bool = True, root: str = "data/nuScenes",
             gt_info_dir: str | None = None, parity: bool = False, batch: int = 8) -> dict:
    """{'fps', 'metrics', 'metrics_refined'} and, given gt_info_dir,
    'metrics_lite' (eval_tracking_lite). device: default "cuda"."""
    cfg = Config.fromfile(config_path)
    os.makedirs(work_dir, exist_ok=True)
    model = load_model(cfg, checkpoint, device)
    annos = evaluate(cfg, model, "val", parity=parity, batch=batch)
    with open(os.path.join(work_dir, "cp_val.json"), "w") as f:
        json.dump(annos, f)

    frames = save_first_frame(cfg.data.val["frame_info_path"], work_dir)
    result, fps = track(annos["results"], frames, max_age=cfg.max_age)
    res_path = os.path.join(work_dir, "tracking_result.json")
    with open(res_path, "w") as f:
        json.dump(result, f)
    print(f"validate: tracked {len(frames)} frames at {fps:.1f} FPS")

    out = {"fps": fps, "metrics": None, "metrics_refined": None}
    if gt_info_dir and os.path.isdir(gt_info_dir):
        out["metrics_lite"] = eval_tracking_lite(result["results"], gt_info_dir)
        print("AMOTA-lite:", json.dumps(out["metrics_lite"]))
    if run_official_eval:
        out["metrics"] = eval_tracking_nuscenes(res_path, "val", work_dir, "v1.0-trainval", root)
        result_rc, _ = track(annos["results"], frames, max_age=cfg.max_age,
                             refine_confidence=True, alpha=cfg.alpha, beta=cfg.beta)
        rc_path = os.path.join(work_dir, "tracking_result_refined.json")
        with open(rc_path, "w") as f:
            json.dump(result_rc, f)
        out["metrics_refined"] = eval_tracking_nuscenes(rc_path, "val", work_dir + "_refined",
                                                        "v1.0-trainval", root)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nusc/car.py")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--work_dir", default="work_dirs/validate")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--root", default="data/nuScenes")
    ap.add_argument("--gt_info_dir", default=None,
                    help="gt_info/individual_frames dir for devkit-free AMOTA")
    ap.add_argument("--parity", action="store_true",
                    help="reference-shaped per-pair B=1 loop (default: scene-batched)")
    ap.add_argument("--batch", type=int, default=8, help="scene lanes (fast path)")
    args = ap.parse_args(argv)
    return validate(args.config, args.checkpoint, args.work_dir,
                    device="cpu" if args.cpu else "cuda", run_official_eval=not args.skip_eval,
                    root=args.root, gt_info_dir=args.gt_info_dir, parity=args.parity,
                    batch=args.batch)


if __name__ == "__main__":
    main()
