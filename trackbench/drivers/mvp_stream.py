"""Driver: one car scene stream on CenterPoint-MVP's trunk (the dynamic
virtual-point reader and the 21-wide sparse trunk under ShaSTA's head),
fed raw clouds, served frame by frame, a closed loop.

As drivers/stream.py: the entry is `ScenePipeline.step_frame`, its
outputs read back to the host before the next frame is handed over; the
mix's scenes are cycled and the pipeline resets at each scene's start.
Each frame is handed over as its point rows (gen/mvp.py: the cloud padded
to the mix's `cloud_rows`, and its mask), so the step voxelizes it on the
card. The model is built from every key of the configuration's model,
before any traffic is made, so a program without the dynamic reader
refuses the configuration in set-up at once. The check runs
reference/mvp.py through reference/pipelines.stream.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import harness
from ..count import work
from ..gen.mvp import mvp_scenes
from ..reference import mvp as rv
from ..reference import pipelines as ref
from . import stream

# keys of a configuration's model that no ShastaConfig field takes
NOT_FIELDS = ("type", "assume_sorted_voxels")


def model_config(cls, cfg: dict, max_obj: int, dtype=None):
    """The port's ShastaConfig (cls) of every key of the configuration's
    model, at the cell's B=1 caps."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()
          if k not in NOT_FIELDS}
    return cls(**{**kw, **harness.caps(cfg, 1), "max_obj": max_obj, "dtype": dtype})


class Cell(stream.Cell):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        from shasta_tpu_torch.infer import ScenePipeline, default_tracker_params
        from shasta_tpu_torch.models import ShastaConfig, ShastaModel
        from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

        (cls,) = cfg["classes"]
        model_cfg = model_config(ShastaConfig, cfg, cls["max_obj"], dtype)
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        self.max_obj = {cls["name"]: cls["max_obj"]}
        self.names = [cls["name"]]
        self.scenes = mvp_scenes(seed, mix, cfg["point_pipeline"], self.max_obj)
        trunk, heads = harness.class_weights(cfg, seed, self.dev)
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

    def _step(self, frame: dict) -> tuple[dict, float]:
        """One frame's point rows through the entry; returns ({class:
        outputs on the host}, the seconds until the entry returned)."""
        (n,) = self.names
        boxes, n_curr = ref.class_boxes(frame, n, self.max_obj[n])
        arrays = dict(cloud=frame["cloud"][None], cloud_valid=frame["cloud_valid"][None],
                      det_boxes=boxes[None])
        lag = ref.frame_lag(frame, self.names)
        t0 = time.perf_counter()
        o = self.pipe.step_frame(arrays, n_curr, lag)
        queued = time.perf_counter() - t0
        return {n: {"tid": o.tid, "used": o.used, "ref": o.ref, "keep": o.keep, "fn": o.fn}}, \
            queued

    def check(self) -> dict:
        """The MVP reference over a sample of the scenes drawn from the
        seed, against every recorded frame of those scenes."""
        ref.plain_f32()
        trunk, heads = harness.class_weights(self.cfg, self.seed, self.dev)
        th = (self.cfg["fp_elim"], self.cfg["decision_thresh"])
        k = min(self.mix["check_scenes"], len(self.scenes))
        picked = sorted(np.random.default_rng(self.seed).choice(len(self.scenes), k,
                                                               replace=False).tolist())
        tr = rv.Trunk(trunk, self.cfg["model"], self.dev)
        want = {si: ref.stream(tr, heads, self.max_obj, self.scenes[si], th, self.cfg["max_age"])
                for si in picked}
        cap = self.cfg["model"]["max_voxels"]
        print(f"trackbench: voxels of {len(tr.counts)} frames {min(tr.counts)}-{max(tr.counts)} "
              f"against max_voxels {cap}: {'held' if max(tr.counts) <= cap else 'CUT'}",
              file=sys.stderr)
        harness.report_sets(tr.sets, harness.caps(self.cfg, 1), 1)
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
        """Per recorded frame: the trunk's convs over the reference's voxels
        (21 features in) and the model's FLOPs (the convs, the neck and
        shared conv, the head; the reader's means are left out)."""
        m = self.cfg["model"]
        (n,) = self.names
        tr = rv.Trunk({}, m, self.dev)
        dense = work.dense_flops(m) + work.head_flops(self.max_obj[n], m["num_feats"],
                                                      m["num_point"], m["share_conv_channel"])
        convs, flops, cache = [], [], {}
        for si, t, _ in self.records:
            if (si, t) not in cache:
                zyx = tr.voxels(self.scenes[si][t])[1]
                cache[si, t] = work.trunk_convs(zyx, torch.ones(len(zyx), dtype=torch.bool),
                                                m["grid_shape"], m["num_input_features"],
                                                self.dev)
            c = cache[si, t]
            convs.append(c)
            flops.append(sum(map(work.conv_flops, c)) + dense)
        return dict(convs=convs, flops=flops)
