"""Scene-indexed frame metadata json: the port of tools/make_scenes.py
(tools/nusc_shasta/make_scenes.py:35-81 equivalent, devkit-free): per scene,
the ordered tokens with timestamps and first-frame flags, the input for
scene-parallel batched inference.

    python -m shasta_tpu_torch.tools.make_scenes --dataroot data/nuScenes \\
        --version v1.0-trainval --out scenes_meta.json [--scenes_file val_scenes.txt]
"""
from __future__ import annotations

import argparse
import json
import os

from ..preprocessing.nusc_db import NuscDB


def read_scene_names(scenes, scenes_file):
    """--scenes, or the non-empty lines of --scenes_file where it is given."""
    if scenes_file:
        with open(scenes_file) as f:
            return [line.strip() for line in f if line.strip()]
    return scenes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--scenes_file", default=None)
    args = ap.parse_args(argv)

    scene_names = read_scene_names(args.scenes, args.scenes_file)
    db = NuscDB(args.dataroot, args.version)
    scenes = {}
    for scene in db.scene:
        if scene_names is not None and scene["name"] not in scene_names:
            continue
        scenes[scene["name"]] = [
            {
                "token": s["token"],
                "timestamp": s["timestamp"] * 1e-6,
                "first": s["prev"] == "",
            }
            for s in db.scene_samples(scene)
        ]
    out = {"scenes": scenes}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(scenes)} scenes -> {args.out}")
    return out


if __name__ == "__main__":
    main()
