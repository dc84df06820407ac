"""Driver: the offline eval of a val split, whole passes.

The entry is the port's `run_affinity_eval_batched` over a fresh
`NuScenesTrackDataset` of a split the benchmark writes in set-up: the loop
of `tools.eval --batch <lanes>`, reading and voxelizing each frame when its
row of the lane schedule is staged. A pass's frames are the split's."""
from __future__ import annotations

import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..count import work
from ..gen.scenes import write_split
from ..harness import model_config
from ..reference import pipelines as ref
from ..reference.points import SplitReader


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        from shasta_tpu_torch.models import ShastaConfig, ShastaModel

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        (cls,) = cfg["classes"]
        self.cls, self.N = cls["name"], cls["max_obj"]
        self.root = tempfile.mkdtemp(prefix="trackbench_split_")
        self.split = write_split(self.root, seed, mix, cfg["point_pipeline"],
                                 {self.cls: self.N})
        trunk, heads = harness.class_weights(cfg, seed, self.dev)
        caps = harness.caps(cfg, mix["lanes"])
        self.model = ShastaModel(model_config(ShastaConfig, cfg["model"], max_obj=self.N,
                                              dtype=dtype, **caps), device=self.dev)
        self.model.load_state_dict({**trunk, **heads[self.cls]})
        del trunk, heads
        self._warm_up()

    def _dataset(self):
        from shasta_tpu_torch.data.nuscenes import NuScenesTrackDataset, PointPipelineConfig

        pp = {k: tuple(v) if isinstance(v, list) else v
              for k, v in self.cfg["point_pipeline"].items()}
        return NuScenesTrackDataset(**self.split["kwargs"], det_type=[self.cls],
                                    max_objects=self.N,
                                    pipeline=PointPipelineConfig(**dict(pp, shuffle_points=False)))

    def _warm_up(self) -> None:
        """One step of every lane over the split's first frames: the only
        shapes a pass uses (every frame is padded to max_voxels)."""
        from shasta_tpu_torch.data.nuscenes import collate
        from shasta_tpu_torch.infer import FRAME_KEYS
        from shasta_tpu_torch.tracker.runner import EvalLanes

        ds = self._dataset()
        meta = ds.metadata()
        lanes = self.mix["lanes"]
        idx = list(range(0, len(meta), self.mix["frames"]))[:lanes]
        idx += [idx[0]] * (lanes - len(idx))
        rows = [ds.read_at(i, meta[i]["rng_state"]) for i in idx]
        frames = collate([{k: s[k] for k in FRAME_KEYS} for s in rows])
        step = EvalLanes(self.model, lanes, self.cfg["fp_elim"], self.cfg["decision_thresh"])
        step.step_chunk({k: v[None] for k, v in frames.items()}, [[True] * lanes],
                        [[len(s["cls_det_boxes"]) for s in rows]]).array()

    def _pass(self) -> tuple[dict, dict, float]:
        from shasta_tpu_torch.tracker.runner import run_affinity_eval_batched

        timings: dict = {}
        t0 = time.perf_counter()
        annos = run_affinity_eval_batched(self.model, self._dataset(), batch=self.mix["lanes"],
                                          fp_thresh=self.cfg["fp_elim"],
                                          decision_thresh=self.cfg["decision_thresh"],
                                          chunk=self.mix["chunk"], timings=timings)
        return annos["results"], timings, time.perf_counter() - t0

    def _passes(self, stop) -> dict:
        self.results, timings, frames = [], {}, 0
        t_start = time.perf_counter()
        while True:
            res, t, sec = self._pass()
            print(f"trackbench: a pass of {len(res)} frames in {sec:.3f} s "
                  f"({', '.join(f'{k} {v:.3f}' for k, v in t.items())})", file=sys.stderr)
            self.results.append(res)
            frames += len(res)
            for k, v in t.items():
                timings[k] = timings.get(k, 0.0) + v
            if stop(len(self.results), time.perf_counter() - t_start):
                break
        return dict(frames=frames, wall_s=time.perf_counter() - t_start, timings=timings)

    def window(self, seconds: float) -> dict:
        return self._passes(lambda n, elapsed: elapsed >= seconds)

    def trace_frames(self) -> dict:
        return self._passes(lambda n, elapsed: True)

    def release(self) -> None:
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _scenes(self) -> list[list[int]]:
        out: list = []
        for i, tok in enumerate(self.split["tokens"]):
            if tok.endswith("f0"):
                out.append([])
            out[-1].append(i)
        return out

    def check(self) -> dict:
        """The reference over a sample of the scenes drawn from the seed,
        read from the split's files, against every pass's annotations of
        those scenes."""
        ref.plain_f32()
        trunk, heads = harness.class_weights(self.cfg, self.seed, self.dev)
        scenes = self._scenes()
        k = min(self.mix["check_scenes"], len(scenes))
        picked = set(np.random.default_rng(self.seed).choice(len(scenes), k,
                                                            replace=False).tolist())
        reader = SplitReader(self.split["kwargs"], self.cfg["point_pipeline"], [self.cls],
                             self.N, self.dev)
        tr = ref.Trunk(trunk, self.cfg["model"], self.dev)
        th = (self.cfg["fp_elim"], self.cfg["decision_thresh"])
        want: dict = {}
        for si, idx in enumerate(scenes):
            if si in picked:
                want.update(ref.eval_scene(tr, heads[self.cls], self.N,
                                           [reader.frame(i) for i in idx], th))
            else:
                for i in idx:
                    reader.skip(i)
        harness.report_sets(tr.sets, harness.caps(self.cfg, self.mix["lanes"]), self.mix["lanes"])
        tally = harness.Tally()
        for res in self.results:
            for tok, annos in want.items():
                harness.compare_annos(tally, res.get(tok, []), annos)
        return tally.numbers()

    def work(self) -> dict:
        """Per frame of the recorded passes: the trunk's convs, from the
        split read again, and the model's FLOPs."""
        m = self.cfg["model"]
        reader = SplitReader(self.split["kwargs"], self.cfg["point_pipeline"], [self.cls],
                             self.N, self.dev)
        head = work.head_flops(self.N, m["num_feats"], m["num_point"], m["share_conv_channel"])
        convs = []
        for i in range(len(self.split["tokens"])):
            f = reader.frame(i)
            convs.append(work.trunk_convs(f["coordinates"], f["voxels_valid"], m["grid_shape"],
                                          m["num_input_features"], self.dev))
        convs = convs * len(self.results)
        return dict(convs=convs, flops=[sum(map(work.conv_flops, c)) + work.dense_flops(m) + head
                                        for c in convs])

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
