"""Run the full offline preprocessing chain: the port of
tools/preprocess_nuscenes.py (preprocessing.sh equivalent).

    python -m shasta_tpu_torch.tools.preprocess_nuscenes --dataroot data/nuScenes \\
        --version v1.0-trainval --results detections/cp/val.json \\
        --out data/nusc_preprocessed --split val \\
        [--scenes scene-0001 scene-0002 | --scenes_file val_scenes.txt] [--no_gt]
"""
from __future__ import annotations

import argparse

from ..preprocessing.nuscenes_chain import run_chain
from .make_scenes import read_scene_names


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--results", required=True, help="raw detector results json")
    ap.add_argument("--out", default="data/nusc_preprocessed")
    ap.add_argument("--split", default="train")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--scenes_file", default=None)
    ap.add_argument("--det_name", default="cp")
    ap.add_argument("--no_gt", action="store_true", help="test split: skip GT stages")
    ap.add_argument("--mode", default="2hz", choices=["2hz", "20hz"],
                    help="20hz: full sweep chain w/ 10 Hz selection + interpolated GT")
    args = ap.parse_args(argv)

    run_chain(
        dataroot=args.dataroot,
        version=args.version,
        results_json=args.results,
        out_dir=args.out,
        split=args.split,
        scene_names=read_scene_names(args.scenes, args.scenes_file),
        det_name=args.det_name,
        with_gt=not args.no_gt,
        mode=args.mode,
    )
    out = f"{args.out}/{args.split}_{args.mode}"
    print(f"preprocessing chain complete -> {out}")
    return out


if __name__ == "__main__":
    main()
