"""Build the multi-sweep infos pkls: the port of tools/create_data.py.

    python -m shasta_tpu_torch.tools.create_data --dataroot data/nuScenes \\
        --version v1.0-trainval \\
        --out data/nusc_preprocessed/infos_train_10sweeps_withvelo_filter_True.pkl \\
        [--scenes_file train_scenes.txt] [--nsweeps 10] [--no_gt]
    python -m shasta_tpu_torch.tools.create_data --waymo --dataroot data/Waymo \\
        --split train [--nsweeps 1]

--waymo builds the infos over a {split}/{lidar,annos} pkl tree
(waymo_common.py:307-320, data.waymo_decode.create_waymo_infos).
"""
from __future__ import annotations

import argparse

from ..data.waymo_decode import create_waymo_infos
from ..preprocessing.infos import create_nuscenes_infos
from .make_scenes import read_scene_names


def main(argv=None):
    """Writes the infos; returns them (nuScenes) or the pkl's path (--waymo)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--waymo", action="store_true",
                    help="build Waymo infos over a {split}/{lidar,annos} pkl tree")
    ap.add_argument("--split", default="train", help="Waymo split (--waymo)")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--out", default=None)
    ap.add_argument("--nsweeps", type=int, default=10)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--scenes_file", default=None)
    ap.add_argument("--no_gt", action="store_true")
    args = ap.parse_args(argv)

    if args.waymo:
        out = create_waymo_infos(args.dataroot, args.split, args.nsweeps)
        print(f"wrote waymo infos -> {out}")
        return out
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
