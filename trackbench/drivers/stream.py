"""Driver: one scene stream served frame by frame, a closed loop.

The entry is the port's serving step: `ScenePipeline.step_frame` for a
configuration of one class, `MultiClassScenePipeline.step_frame` for
several classes on one shared trunk. Each frame is handed over as host
arrays (voxelized in set-up by the benchmark, reading bypassed) and its
outputs are read back to the host before the next frame is handed over.
The mix's scenes are cycled; the pipeline resets at each scene's start.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..harness import model_config
from ..count import work
from ..gen.scenes import stream_scenes
from ..reference import pipelines as ref


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        from shasta_tpu_torch.infer import (MultiClassScenePipeline, ScenePipeline,
                                            default_tracker_params)
        from shasta_tpu_torch.models import ShastaConfig, ShastaModel
        from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        self.max_obj = {c["name"]: c["max_obj"] for c in cfg["classes"]}
        self.names = [n for n in NUSCENES_TRACKING_NAMES if n in self.max_obj]
        self.scenes = stream_scenes(seed, mix, cfg["point_pipeline"], self.max_obj, self.dev)
        trunk, heads = harness.class_weights(cfg, seed, self.dev)
        m = cfg["model"]
        params = default_tracker_params(max_age=cfg["max_age"], device=self.dev)
        th = dict(fp_thresh=cfg["fp_elim"], decision_thresh=cfg["decision_thresh"])
        models = {}
        for n in self.names:
            models[n] = ShastaModel(model_config(ShastaConfig, m, max_obj=self.max_obj[n],
                                                 dtype=dtype, **harness.caps(cfg, 1)),
                                    device=self.dev)
            models[n].load_state_dict({**trunk, **heads[n]})
        del trunk, heads
        if len(self.names) == 1:
            n = self.names[0]
            self.pipe = ScenePipeline(models[n], NUSCENES_TRACKING_NAMES.index(n), params, **th)
        else:
            self.pipe = MultiClassScenePipeline(models, trunk_key=cfg["trunk_class"],
                                                params=params, device=self.dev, **th)
        del models
        # warm-up: every shape the window uses (one step; all frames share their shapes)
        self._step(self.scenes[0][0])
        self._sync()
        self.pipe.reset()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _step(self, frame: dict) -> tuple[dict, float]:
        """One frame through the entry; returns ({class: outputs on the
        host}, the seconds until the entry returned)."""
        arrays = {k: frame[k][None] for k in ("voxels", "num_points", "coordinates",
                                              "voxels_valid")}
        lag = ref.frame_lag(frame, self.names)
        t0 = time.perf_counter()
        if len(self.names) == 1:
            n = self.names[0]
            boxes, n_curr = ref.class_boxes(frame, n, self.max_obj[n])
            outs = {n: self.pipe.step_frame(dict(arrays, det_boxes=boxes[None]), n_curr, lag)}
        else:
            outs = self.pipe.step_frame(arrays, {n: (b[None], c) for n, (b, c) in (
                (n, ref.class_boxes(frame, n, self.max_obj[n])) for n in self.names)}, lag)
        queued = time.perf_counter() - t0
        return {n: {"tid": o.tid, "used": o.used, "ref": o.ref, "keep": o.keep, "fn": o.fn}
                for n, o in outs.items()}, queued

    def _frames(self, stop) -> dict:
        """Frames in scene order, cycling, until stop(frames done, elapsed)."""
        recs, lat, queue = [], [], []
        t_start = time.perf_counter()
        done = False
        while not done:
            for si, scene in enumerate(self.scenes):
                self.pipe.reset()
                for t, frame in enumerate(scene):
                    t0 = time.perf_counter()
                    out, q = self._step(frame)
                    t1 = time.perf_counter()
                    recs.append((si, t, out))
                    lat.append(t1 - t0)
                    queue.append(q)
                    if stop(len(recs), t1 - t_start):
                        done = True
                        break
                if done:
                    break
        wall = time.perf_counter() - t_start
        self.records = recs
        return dict(frames=len(recs), wall_s=wall, latency_s=lat, queue_s=queue)

    def window(self, seconds: float) -> dict:
        return self._frames(lambda n, elapsed: elapsed >= seconds)

    def trace_frames(self) -> dict:
        return self._frames(lambda n, elapsed: n >= self.mix["trace_frames"])

    def release(self) -> None:
        """Keeps the descriptors the pipeline carries out of the last frame
        (its sampled BEV features, per class), then frees the program."""
        feat = self.pipe._prev_feat
        feat = feat[None, 0] if feat.dim() == 3 else feat[:, 0]  # (C, N_max, F)
        si, t, _ = self.records[-1]
        self.last = (si, t, {n: feat[i, :self.max_obj[n]].float().cpu().numpy()
                             for i, n in enumerate(self.names)})
        del self.pipe
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The reference over a sample of the scenes drawn from the seed,
        against every recorded frame of those scenes."""
        ref.plain_f32()
        trunk, heads = harness.class_weights(self.cfg, self.seed, self.dev)
        th = (self.cfg["fp_elim"], self.cfg["decision_thresh"])
        k = min(self.mix["check_scenes"], len(self.scenes))
        picked = sorted(np.random.default_rng(self.seed).choice(len(self.scenes), k,
                                                               replace=False).tolist())
        tr = ref.Trunk(trunk, self.cfg["model"], self.dev)
        want = {si: ref.stream(tr, heads, self.max_obj, self.scenes[si], th, self.cfg["max_age"])
                for si in picked}
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
        """Per recorded frame: the trunk's convs and the model's FLOPs."""
        m = self.cfg["model"]
        convs, flops = [], []
        heads = sum(work.head_flops(self.max_obj[n], m["num_feats"], m["num_point"],
                                    m["share_conv_channel"]) for n in self.names)
        cache: dict = {}
        for si, t, _ in self.records:
            if (si, t) not in cache:
                f = self.scenes[si][t]
                cache[si, t] = work.trunk_convs(f["coordinates"], f["voxels_valid"],
                                                m["grid_shape"], m["num_input_features"],
                                                self.dev)
            c = cache[si, t]
            convs.append(c)
            flops.append(sum(map(work.conv_flops, c)) + work.dense_flops(m) + heads)
        return dict(convs=convs, flops=flops)
