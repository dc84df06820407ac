"""Final 7-class tracking of the merged json, then the official scoring:
the port of tools/pub_test.py (tools/nusc_shasta/pub_test.py:22-203:
save_first_frame -> PubTrackerMerged per frame -> tracking_result.json ->
TrackingEval, the tracking speed printed).

    python -m shasta_tpu_torch.tools.pub_test --predictions work_dirs/merged/cp_val.json \\
        --frame_info data/nusc_preprocessed/val_frame_info.json --work_dir work_dirs/pub_test

Host code: no device.
"""
from __future__ import annotations

import argparse
import json
import os

from ..tracker.runner import eval_tracking_nuscenes, save_first_frame, track


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--predictions", required=True, help="merged cp_{split}.json")
    ap.add_argument("--frame_info", required=True)
    ap.add_argument("--work_dir", default="work_dirs/pub_test")
    ap.add_argument("--max_age", type=int, default=4)
    ap.add_argument("--hungarian", action="store_true")
    ap.add_argument("--eval_set", default="val")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--root", default="data/nuScenes")
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--repeat", type=int, default=1, help="best-of-N FPS timing")
    args = ap.parse_args(argv)

    os.makedirs(args.work_dir, exist_ok=True)
    with open(args.predictions) as f:
        predictions = json.load(f)["results"]
    frames = save_first_frame(args.frame_info, args.work_dir)

    best_fps = 0.0
    for _ in range(max(1, args.repeat)):
        result, fps = track(predictions, frames, max_age=args.max_age,
                            hungarian=args.hungarian, merged=True)
        best_fps = max(best_fps, fps)
    print(f"tracking speed: {best_fps:.1f} FPS")

    res_path = os.path.join(args.work_dir, "tracking_result.json")
    with open(res_path, "w") as f:
        json.dump(result, f)
    print(f"wrote {res_path}")

    if not args.skip_eval:
        eval_tracking_nuscenes(res_path, args.eval_set, args.work_dir, args.version, args.root)
    return result


if __name__ == "__main__":
    main()
