"""Per-class affinity eval: refined detections and ShaSTA flags ->
cp_{split}.json. The port of tools/eval.py.

    python -m shasta_tpu_torch.tools.eval --config configs/nusc/car.py \\
        --checkpoint work_dirs/car/latest.pth --work_dir work_dirs/car_eval --split val

Scene-batched by default (`--batch` lanes, `--chunk` steps per call);
`--parity` runs the reference-shaped loop, the two-frame forward on every
pair. `--track` also tracks the result (tracking_result.json and the
confidence-refined tracking_result_ref_alpha*_beta*.json) and scores both
with the official TrackingEval where the nuScenes devkit is installed.
Runs on the card unless --cpu is given. Checkpoints: .pth only.
"""
from __future__ import annotations

import argparse
import json
import os

from ..tracker.runner import (eval_tracking_nuscenes, run_affinity_eval,
                              run_affinity_eval_batched, save_first_frame, track)
from ..utils import Config
from .common import build_dataset, load_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the affinity model")
    p.add_argument("--config", default="configs/nusc/car.py")
    p.add_argument("--checkpoint", required=True,
                   help=".pth: det3d's Shasta or bev_map checkpoint, or one save_checkpoint "
                        "wrote (orbax directories cannot be read)")
    p.add_argument("--work_dir", default="work_dirs/eval")
    p.add_argument("--split", default="val", choices=["val", "test"])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--beta", type=float, default=None)
    p.add_argument("--track", action="store_true", help="also run tracking + official eval")
    p.add_argument("--root", default="data/nuScenes")
    p.add_argument("--parity", action="store_true",
                   help="reference-shaped per-pair B=1 loop (default: scene-batched)")
    p.add_argument("--batch", type=int, default=8, help="scene lanes (fast path)")
    p.add_argument("--chunk", type=int, default=1, help="steps per device call (fast path)")
    return p.parse_args(argv)


def evaluate(cfg, model, split: str, parity: bool = False, batch: int = 8, chunk: int = 1,
             progress: bool = True) -> dict:
    """The annotations of cfg's `split` under `model`: the parity loop or the
    scene-batched one, with cfg's decision thresholds."""
    ds = build_dataset(cfg, split)
    kw = dict(fp_thresh=cfg.get("fp_elim", 0.7), decision_thresh=cfg.get("decision_thresh", 0.5),
              progress=progress)
    if parity:
        return run_affinity_eval(model, ds, **kw)
    return run_affinity_eval_batched(model, ds, batch=batch, chunk=chunk, **kw)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    os.makedirs(args.work_dir, exist_ok=True)
    model = load_model(cfg, args.checkpoint, "cpu" if args.cpu else "cuda")
    print(f"loaded {args.checkpoint}")
    annos = evaluate(cfg, model, args.split, args.parity, args.batch, args.chunk)
    out_path = os.path.join(args.work_dir, f"cp_{args.split}.json")
    with open(out_path, "w") as f:
        json.dump(annos, f)
    print(f"wrote {out_path}")

    if args.track:
        version = "v1.0-trainval" if args.split == "val" else "v1.0-test"
        frames = save_first_frame(cfg.data[args.split]["frame_info_path"], args.work_dir)
        result, fps = track(annos["results"], frames, max_age=cfg.max_age,
                            refine_confidence=False)
        res_path = os.path.join(args.work_dir, "tracking_result.json")
        with open(res_path, "w") as f:
            json.dump(result, f)
        print(f"tracking: {fps:.1f} frames/s -> {res_path}")
        eval_tracking_nuscenes(res_path, args.split, args.work_dir, version, args.root)
        # the confidence-refined variant (eval.py:351-352)
        a = args.alpha if args.alpha is not None else cfg.alpha
        b = args.beta if args.beta is not None else cfg.beta
        result_rc, _ = track(annos["results"], frames, max_age=cfg.max_age,
                             refine_confidence=True, alpha=a, beta=b)
        rc_path = os.path.join(args.work_dir, f"tracking_result_ref_alpha{a}_beta{b}.json")
        with open(rc_path, "w") as f:
            json.dump(result_rc, f)
        eval_tracking_nuscenes(rc_path, args.split, args.work_dir + "_refined", version,
                               args.root)
    return annos


if __name__ == "__main__":
    main()
