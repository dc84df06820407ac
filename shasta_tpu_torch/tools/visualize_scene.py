"""Render a tracked scene, LiDAR-on-map BEV + camera-projected boxes: the
port of tools/visualize_scene.py.

    python -m shasta_tpu_torch.tools.visualize_scene --dataroot data/nuScenes \\
        --version v1.0-trainval --scene_name scene-0270 \\
        --track_result_path results/val_tracking_result.json \\
        --save_path work_dir/visualize --render_class car

Devkit-free equivalent of the reference's nusc_visualize/visualize.py: it
reads the raw v1.0-* tables and blobs directly (preprocessing.nusc_db) and
renders on the host with matplotlib and Pillow; no card.
"""
from __future__ import annotations

import argparse

from ..preprocessing.nusc_db import NuscDB
from ..viz.scene_renderer import render_scene


def main(argv=None) -> list[str]:
    """Renders the scene; returns the written paths."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--scene_name", default="scene-0270")
    ap.add_argument("--render_class", default="car",
                    help="tracking class to render ('' = all classes)")
    ap.add_argument("--track_result_path", required=True)
    ap.add_argument("--save_path", default="work_dir/visualize")
    ap.add_argument("--channels", default="LIDAR_TOP,CAM_FRONT",
                    help="comma-separated sensor channels")
    ap.add_argument("--nsweeps", type=int, default=10)
    ap.add_argument("--no_map", action="store_true", help="skip map underlay")
    args = ap.parse_args(argv)

    db = NuscDB(args.dataroot, args.version)
    written = render_scene(
        db,
        scene_name=args.scene_name,
        tracking_result_path=args.track_result_path,
        save_path=args.save_path,
        render_class=args.render_class or None,
        channels=tuple(args.channels.split(",")),
        nsweeps=args.nsweeps,
        underlay_map=not args.no_map,
    )
    print(f"wrote {len(written)} frames under {args.save_path}")
    return written


if __name__ == "__main__":
    main()
