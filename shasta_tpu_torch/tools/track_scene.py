"""Serve a preprocessed nuScenes split with one class model: the port of
tools/track_scene.py. Each frame runs the whole step (trunk, affinity,
decision rules, tracker) on the device; the host reads back O(N) values.

    python -m shasta_tpu_torch.tools.track_scene --config configs/nusc/car.py \\
        --checkpoint work_dirs/car/latest.pth --out tracking_result.json [--cpu] \\
        [--render tracks.png]

Runs on the card unless --cpu is given; --render draws the tracks' BEV
trajectories on the host after serving (viz.visualizer2d, matplotlib).
"""
from __future__ import annotations

import argparse
import json
import os

from ..infer import track_scene_dataset
from ..utils import Config
from ..viz.visualizer2d import render_scene_tracks
from .common import build_dataset, build_pipeline, load_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/nusc/car.py")
    ap.add_argument("--checkpoint", required=True,
                    help=".pth: det3d's Shasta or bev_map checkpoint, or one "
                         "save_checkpoint wrote (orbax directories cannot be read)")
    ap.add_argument("--split", default="val")
    ap.add_argument("--out", default="work_dirs/track_scene/tracking_result.json")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    ap.add_argument("--render", default=None, help="optional BEV png path")
    args = ap.parse_args(argv)

    cfg = Config.fromfile(args.config)
    model = load_model(cfg, args.checkpoint, "cpu" if args.cpu else "cuda")
    pipe = build_pipeline(cfg, model)
    result = track_scene_dataset(pipe, build_dataset(cfg, args.split), progress=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"wrote {args.out} ({len(result['results'])} frames)")

    if args.render:
        render_scene_tracks(result["results"], args.render)
        print(f"rendered {args.render}")
    return result


if __name__ == "__main__":
    main()
