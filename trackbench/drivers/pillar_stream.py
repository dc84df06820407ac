"""Driver: one car scene stream on the pillar trunk (CenterPoint-PP under
ShaSTA's head), served frame by frame, a closed loop.

As drivers/stream.py: the entry is `ScenePipeline.step_frame`, each frame
handed over as host arrays (voxelized into pillars in set-up, reading
bypassed), its outputs read back to the host before the next frame; the
mix's scenes are cycled and the pipeline resets at each scene's start.
The model is built from every key of the configuration's model, so a
program without the pillar reader refuses the configuration in set-up.
The check runs the pillar reference (reference/pillars.py) through
reference/pipelines.stream.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import harness
from ..count import pillars as cp
from ..count import work
from ..gen.scenes import stream_scenes
from ..reference import model as rm
from ..reference import pillars as rp
from ..reference import pipelines as ref
from . import stream

# keys of a configuration's model that no ShastaConfig field takes
NOT_FIELDS = ("type", "assume_sorted_voxels")


def weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(trunk weights, {class: head weights}), drawn as harness.class_weights
    draws the sparse trunk's, from the pillar trunk's spec."""
    m = cfg["model"]
    trunk = rm.make_weights(rp.trunk_spec(m), harness.sub_seed(seed, 0), device)
    heads = {c["name"]: rm.make_weights(
        rm.head_spec(c["max_obj"], m["num_feats"], m["num_point"], m["share_conv_channel"]),
        harness.sub_seed(seed, 1 + i), device) for i, c in enumerate(cfg["classes"])}
    return trunk, heads


class Cell(stream.Cell):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        from shasta_tpu_torch.infer import ScenePipeline, default_tracker_params
        from shasta_tpu_torch.models import ShastaConfig, ShastaModel
        from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

        (cls,) = cfg["classes"]
        m = cfg["model"]
        model_cfg = ShastaConfig(**{**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in m.items() if k not in NOT_FIELDS},
                                    "max_obj": cls["max_obj"], "dtype": dtype})
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        self.max_obj = {cls["name"]: cls["max_obj"]}
        self.names = [cls["name"]]
        self.scenes = stream_scenes(seed, mix, cfg["point_pipeline"], self.max_obj, self.dev)
        trunk, heads = weights(cfg, seed, self.dev)
        model = ShastaModel(model_cfg, device=self.dev)
        model.load_state_dict({**trunk, **heads[cls["name"]]})
        del trunk, heads
        self.pipe = ScenePipeline(
            model, NUSCENES_TRACKING_NAMES.index(cls["name"]),
            default_tracker_params(max_age=cfg["max_age"], device=self.dev),
            fp_thresh=cfg["fp_elim"], decision_thresh=cfg["decision_thresh"])
        del model
        # warm-up: every shape the window uses (one step; all frames share their shapes)
        self._step(self.scenes[0][0])
        self._sync()
        self.pipe.reset()

    def check(self) -> dict:
        """The pillar reference over a sample of the scenes drawn from the
        seed, against every recorded frame of those scenes."""
        ref.plain_f32()
        trunk, heads = weights(self.cfg, self.seed, self.dev)
        th = (self.cfg["fp_elim"], self.cfg["decision_thresh"])
        k = min(self.mix["check_scenes"], len(self.scenes))
        picked = sorted(np.random.default_rng(self.seed).choice(len(self.scenes), k,
                                                               replace=False).tolist())
        tr = rp.Trunk(trunk, self.cfg["model"], self.dev)
        want = {si: ref.stream(tr, heads, self.max_obj, self.scenes[si], th, self.cfg["max_age"])
                for si in picked}
        tally = harness.Tally()
        ids = None
        for si, t, out in self.records:
            if si not in want:
                continue
            if t == 0 or ids is None:
                ids = {n: harness.IdMap() for n in self.names}
            for n in self.names:
                harness.compare_rows(tally, ids[n], out.get(n), want[si][t][n])
        si, t, got = self.last
        frame = self.scenes[si][t]
        bev = tr.bev(frame)
        for n in self.names:
            b = torch.as_tensor(ref.class_boxes(frame, n, self.max_obj[n])[0], device=self.dev)
            tally.descriptors(got[n], tr.features(bev, b).cpu().numpy())
        return tally.numbers()

    def work(self) -> dict:
        """Per recorded frame: the model's FLOPs (the reader over the kept
        pillars, the neck and shared conv, the head), and the neck's convs
        (`neck_convs`, for its roofline)."""
        m = self.cfg["model"]
        (n,) = self.names
        dense = cp.dense_flops(m) + work.head_flops(self.max_obj[n], m["num_feats"],
                                                    m["num_point"], m["share_conv_channel"])
        convs = cp.neck_convs(m)
        points = self.cfg["point_pipeline"]["max_points_in_voxel"]
        flops = [cp.reader_flops(int(np.sum(self.scenes[si][t]["voxels_valid"])), points, m)
                 + dense
                 for si, t, _ in self.records]
        return dict(flops=flops, neck_convs=[convs] * len(self.records))
