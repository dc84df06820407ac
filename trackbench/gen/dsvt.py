"""The DSVT traffic: scenes.py's scenes, each frame's cloud handed over as
its raw point rows [x, y, z, intensity, lag] (the key cloud and nsweeps - 1
sweeps, as stream_scenes draws them, in the same order), padded to the
mix's `cloud_rows` with a mask, for a trunk that reads points on the card.
"""
from __future__ import annotations

import numpy as np

from ..reference.points import det_row, sweep_cloud
from .mvp import rows
from .scenes import _cloud, _sweep_choice, detections, make_scene, objects_at


def dsvt_scenes(seed: int, mix: dict, pp: dict, caps: dict) -> list[list[dict]]:
    """The mix's scenes in memory, one list of frames per scene. A frame:
    `cloud` (cloud_rows, 5) f32 host rows and their mask `cloud_valid`;
    `boxes` {class: (n_c, 11) f32 det rows} for every class with a
    detection; `lag`, the time since the scene's previous frame (0 at its
    first). The same seed draws the same clouds and detections as
    scenes.stream_scenes. caps: {name: max_obj}."""
    rng = np.random.default_rng(seed)
    nsweeps = int(pp["nsweeps"])
    scenes = []
    for _ in range(mix["scenes"]):
        scene = make_scene(rng, mix, pp["pc_range"], nsweeps)
        frames = []
        for t in range(mix["frames"]):
            objs = objects_at(scene, t, mix)
            key = _cloud(scene["spots"], objs, mix["key_points"], rng)
            chosen = _sweep_choice(rng, len(scene["pool"]), nsweeps)
            use = rng.choice(len(chosen), min(nsweeps - 1, len(chosen)), replace=False)
            pts = sweep_cloud(key, [scene["pool"][chosen[i]] for i in use])
            lag = mix["frame_dt"] if t else 0.0
            boxes: dict = {}
            for name, tr, size, y, v, score in detections(rng, scene, objs, mix, caps):
                boxes.setdefault(name, []).append(det_row(tr, size, y, v, lag, score))
            frame = dict(zip(("cloud", "cloud_valid"), rows(pts, mix["cloud_rows"])))
            frame["boxes"] = {k: np.asarray(v, np.float32) for k, v in boxes.items()}
            frame["lag"] = lag
            frames.append(frame)
        scenes.append(frames)
    return scenes
