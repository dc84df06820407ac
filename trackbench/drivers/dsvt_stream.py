"""Driver: one car scene stream on DSVT-P's trunk (the dynamic pillar
reader, DSVT's rotated-set window attention, the residual neck and
TransFusion-L's plain shared conv under ShaSTA's head), fed raw clouds,
served frame by frame, a closed loop.

As drivers/mvp_stream.py: the entry is `ScenePipeline.step_frame`, its
outputs read back to the host before the next frame is handed over; the
mix's scenes are cycled and the pipeline resets at each scene's start.
Each frame is handed over as its point rows (gen/dsvt.py: the cloud's
[x, y, z, intensity, lag] rows padded to the mix's `cloud_rows`, and its
mask), so the step reads pillars on the card. The model is built from
every key of the configuration's model, before any traffic is made, so a
program without the DSVT reader refuses the configuration in set-up at
once. The check runs reference/dsvt.py through reference/pipelines.stream.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import harness
from ..count import dsvt as cd
from ..count import work
from ..gen.dsvt import dsvt_scenes
from ..reference import dsvt as rd
from ..reference import model as rm
from ..reference import pipelines as ref
from . import mvp_stream

# keys of a configuration's model that no ShastaConfig field takes
NOT_FIELDS = ("type",)


def model_config(cls, cfg: dict, max_obj: int, dtype=None):
    """The port's ShastaConfig (cls) of every key of the configuration's model."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()
          if k not in NOT_FIELDS}
    return cls(**{**kw, "max_obj": max_obj, "dtype": dtype})


def weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(trunk weights, {class: head weights}), drawn as harness.class_weights
    draws the sparse trunk's, from the DSVT trunk's spec."""
    m = cfg["model"]
    trunk = rm.make_weights(rd.trunk_spec(m), harness.sub_seed(seed, 0), device)
    heads = {c["name"]: rm.make_weights(
        rm.head_spec(c["max_obj"], m["num_feats"], m["num_point"], m["share_conv_channel"]),
        harness.sub_seed(seed, 1 + i), device) for i, c in enumerate(cfg["classes"])}
    return trunk, heads


class Cell(mvp_stream.Cell):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        from shasta_tpu_torch.infer import ScenePipeline, default_tracker_params
        from shasta_tpu_torch.models import ShastaConfig, ShastaModel
        from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

        (cls,) = cfg["classes"]
        model_cfg = model_config(ShastaConfig, cfg, cls["max_obj"], dtype)
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        self.max_obj = {cls["name"]: cls["max_obj"]}
        self.names = [cls["name"]]
        self.scenes = dsvt_scenes(seed, mix, cfg["point_pipeline"], self.max_obj)
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
        """The DSVT-P reference over a sample of the scenes drawn from the
        seed, against every recorded frame of those scenes."""
        ref.plain_f32()
        trunk, heads = weights(self.cfg, self.seed, self.dev)
        th = (self.cfg["fp_elim"], self.cfg["decision_thresh"])
        k = min(self.mix["check_scenes"], len(self.scenes))
        picked = sorted(np.random.default_rng(self.seed).choice(len(self.scenes), k,
                                                               replace=False).tolist())
        tr = rd.Trunk(trunk, self.cfg["model"], self.dev)
        want = {si: ref.stream(tr, heads, self.max_obj, self.scenes[si], th, self.cfg["max_age"])
                for si in picked}
        cap = self.cfg["model"]["max_pillars"]
        print(f"trackbench: pillars of {len(tr.counts)} frames {min(tr.counts)}-{max(tr.counts)} "
              f"against max_pillars {cap}: {'held' if max(tr.counts) <= cap else 'CUT'}",
              file=sys.stderr)
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
        """Per recorded frame: the model's FLOPs (count/dsvt.py: the reader
        over the frame's points, the partition's gathers, the encoder
        layers over its sets and pillars, the neck's convs and the shared
        conv; the head), DSVT's least time (`dsvt_least_s`) and the neck's
        convs (`neck_convs`) for their rooflines."""
        m = self.cfg["model"]
        (n,) = self.names
        head = work.head_flops(self.max_obj[n], m["num_feats"], m["num_point"],
                               m["share_conv_channel"])
        convs = cd.neck_convs(m)
        dense = sum(c["flops"] for c in convs)
        flops, least, cache = [], [], {}
        for si, t, _ in self.records:
            if (si, t) not in cache:
                frame = self.scenes[si][t]
                cache[si, t] = cd.frame_work(frame, m)
            w = cache[si, t]
            flops.append(w["flops"] + dense + head)
            least.append(w["dsvt_least_s"])
        return dict(flops=flops, dsvt_least_s=least, neck_convs=[convs] * len(self.records))
