"""Build the multi-sweep infos pkls: the port of tools/create_data.py.

    python -m shasta_tpu_torch.tools.create_data --dataroot data/nuScenes \\
        --version v1.0-trainval \\
        --out data/nusc_preprocessed/infos_train_10sweeps_withvelo_filter_True.pkl \\
        [--scenes_file train_scenes.txt] [--nsweeps 10] [--no_gt]

The --waymo branch needs the Waymo readers, which are not ported yet
(ROADMAP.md queue 1 item 1d); it refuses.
"""
from __future__ import annotations

import argparse

from ..preprocessing.infos import create_nuscenes_infos
from .make_scenes import read_scene_names


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--waymo", action="store_true",
                    help="build Waymo infos over a {split}/{lidar,annos} pkl tree "
                         "(not ported yet: ROADMAP.md queue 1 item 1d)")
    ap.add_argument("--split", default="train", help="Waymo split (--waymo)")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--out", default=None)
    ap.add_argument("--nsweeps", type=int, default=10)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--scenes_file", default=None)
    ap.add_argument("--no_gt", action="store_true")
    args = ap.parse_args(argv)

    if args.waymo:
        ap.error("--waymo needs the port of the Waymo readers (data/waymo_decode.py), "
                 "ROADMAP.md queue 1 item 1d, which is not done yet")
    if not args.out:
        ap.error("--out is required for nuScenes infos")

    infos = create_nuscenes_infos(
        args.dataroot, args.version, args.nsweeps,
        read_scene_names(args.scenes, args.scenes_file),
        with_gt=not args.no_gt, out_path=args.out,
    )
    print(f"wrote {len(infos)} infos -> {args.out}")
    return infos


if __name__ == "__main__":
    main()
