"""Multi-class serving with ONE shared trunk pass per frame: the port of
tools/track_multiclass.py.

All released class models share one frozen trunk (bev_map.pth), so
MultiClassScenePipeline computes the BEV map once per frame and runs each
class's affinity head and tracker table on it; one pass over the split
writes the final tracking_result.json.

    python -m shasta_tpu_torch.tools.track_multiclass --classes car,pedestrian,bus \\
        --config_dir configs/nusc --checkpoints work_dirs/{cls}/latest.pth \\
        --out work_dirs/multiclass/tracking_result.json [--cpu]

Runs on the card unless --cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os

from ..data.nuscenes import collate
from ..device import resolve_device
from ..infer import (FRAME_KEYS, RESULT_META, MultiClassScenePipeline, anno_from,
                     default_tracker_params, fn_translation)
from ..utils import Config
from .common import build_dataset, load_model

# config-file names per tracking class (configs/nusc/*.py)
CFG_NAME = {
    "car": "car", "pedestrian": "ped", "truck": "truck", "trailer": "trailer",
    "bus": "bus", "motorcycle": "motorcycle", "bicycle": "bicycle",
}


def run_multiclass(class_specs: dict, out_path: str, trunk_key: str | None = None,
                   progress: bool = False, device=None) -> dict:
    """class_specs: {name: (config_path, checkpoint_path or None)}; without
    a checkpoint a class keeps build_model's seeded initial weights. The
    val split of the first class's config gives the voxels; each class's
    own config gives its detections. Writes and returns the tracking
    result. device: default "cuda"."""
    dev = resolve_device(device)
    class_models, box_datasets = {}, {}
    vox_dataset = None
    max_age = 4
    for name, (config_path, ckpt) in class_specs.items():
        cfg = Config.fromfile(config_path)
        # class models on the host: the pipeline stacks their heads and
        # copies one trunk to `dev`
        class_models[name] = load_model(cfg, ckpt, "cpu")
        box_datasets[name] = build_dataset(cfg, "val", load_points=False)
        if vox_dataset is None:
            vox_dataset = build_dataset(cfg, "val")
        max_age = cfg.get("max_age", 4)

    pipe = MultiClassScenePipeline(
        class_models, trunk_key=trunk_key or next(iter(class_models)),
        params=default_tracker_params(max_age=max_age, device=dev), device=dev)

    results: dict[str, list] = {}
    it = range(len(vox_dataset))
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(it)
        except ImportError:
            pass

    def fresh_state():
        return {"prev_cls": {n: [] for n in class_models},
                "prev_lag": {n: 0.5 for n in class_models}}

    def process(i, state):
        """Step and format dataset row i; advances state."""
        vox_sample = vox_dataset[i]
        if not vox_sample["prev_token"]:
            pipe.reset()
            state.update(fresh_state())
        frame = collate([{k: vox_sample[k] for k in FRAME_KEYS}])
        cls_samples = {name: ds[i] for name, ds in box_datasets.items()}
        class_boxes = {name: (s["det_boxes"][None], len(s["cls_det_boxes"]))
                       for name, s in cls_samples.items()}
        n_any = max(n for _, n in class_boxes.values())
        lag = float(vox_sample["det_boxes"][0, 9]) if n_any else 0.5
        token = vox_sample["token"]
        annos = []
        for name, o in pipe.step_frame(frame, class_boxes, lag).items():
            s = cls_samples[name]
            N = class_models[name].cfg.max_obj
            for k, a in enumerate(s["cls_det_boxes"]):
                if o.used[k]:
                    annos.append(anno_from(a, token, o.tid[k], o.ref[k]))
            # FN-propagated prev boxes
            for n, src in enumerate(state["prev_cls"][name]):
                if o.fn[n] and o.used[N + n]:
                    annos.append(anno_from(src, token, o.tid[N + n], o.ref[N + n],
                                           fn_translation(src, state["prev_lag"][name])))
            # next frame's FN propagation uses THIS frame's stored dt
            # (prev_det_boxes[0, 9] in the reference, eval.py:142)
            state["prev_cls"][name] = s["cls_det_boxes"]
            state["prev_lag"][name] = float(s["det_boxes"][0, 9])
        results[token] = annos

    state = fresh_state()
    for i in it:
        process(i, state)

    result = {"results": results, "meta": dict(RESULT_META)}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classes", default="car,pedestrian,truck,trailer,bus,motorcycle,bicycle")
    ap.add_argument("--config_dir", default="configs/nusc")
    ap.add_argument("--checkpoints", default=None,
                    help="pattern with {cls}, e.g. work_dirs/{cls}/latest.pth")
    ap.add_argument("--trunk_key", default="car")
    ap.add_argument("--out", default="work_dirs/multiclass/tracking_result.json")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    args = ap.parse_args(argv)

    specs = {}
    for name in args.classes.split(","):
        cfg_path = os.path.join(args.config_dir, CFG_NAME[name] + ".py")
        ckpt = args.checkpoints.format(cls=CFG_NAME[name]) if args.checkpoints else None
        specs[name] = (cfg_path, ckpt)
    result = run_multiclass(
        specs, args.out,
        trunk_key=args.trunk_key if args.trunk_key in specs else None,
        progress=True, device="cpu" if args.cpu else "cuda",
    )
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
