"""Scene serving, one step per frame: the port of ScenePipeline.step_frame
(shasta_tpu/infer.py:154-374), of BatchedScenePipeline.step_frames
(:377-600), which advances B scene lanes one frame each in one step, and of
MultiClassScenePipeline (:603-907), which tracks up to 7 classes of one
scene on one shared trunk.

  carry = (prev descriptors, prev boxes, track table, id counter), per lane
  step:  trunk (one frame per lane) -> BEV descriptors -> affinity vs
         carried prev -> decision rules + FN injection -> scan-tracker step
  out:   one packed (6, 2N) f32 tensor, (B, 6, 2N) for B lanes: track ids,
         used flags, refined scores, keep flags, FN flags and a row of ones

`LaneStep` writes that step once for B lanes (ScenePipeline is the
BatchedScenePipeline of one lane; runner.EvalLanes the eval's), and
`decide_and_track` the serving tail. `step_chunk` advances T frames a call.
`track_scene_dataset` (infer.py:910-1040) serves a dataset of ordered
frames through a ScenePipeline and returns the tracking result.

Everything after the upload stays on the device; the host reads the
packed outputs only when a StepOutput field is accessed. The port needs
no coverage flags or safe replay: its kernels gather by index and are
exact for any input, so the last packed row (the JAX coverage row) is
always 1.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import time
from collections import deque

import numpy as np
import torch

from . import plans as hp
from .core.bilinear import sample_bev_features
from .core.boxes import box_points_5
from .device import resolve_device, upload
from .models.affinity import AffinityNet
from .models.shasta import CLOUD_KEYS, ShastaModel, trunk_bev
from .multiclass import stack_class_heads
from .tracker import scan_tracker as st
from .tracker.decision import apply_decision_rules
from .tracker.pub_tracker import (NUSCENE_CLS_VELOCITY_ERROR,
                                  NUSCENES_TRACKING_NAMES, TRK_REF)
from .utils.profiler import annotate

FRAME_KEYS = ("voxels", "num_points", "coordinates", "voxels_valid", "det_boxes")


def default_tracker_params(max_age: int = 4, merged: bool = True,
                           device="cpu") -> st.TrackerParams:
    names = NUSCENES_TRACKING_NAMES

    def t(v):
        return torch.tensor(v, device=device)

    return st.TrackerParams(
        gates=t([float(NUSCENE_CLS_VELOCITY_ERROR[n]) for n in names]),
        alpha=t([TRK_REF[n]["alpha"] for n in names]),
        beta=t([TRK_REF[n]["beta"] for n in names]),
        refine=t([TRK_REF[n]["ref"] for n in names]),
        max_age=max_age,
        merged_mode=merged,
    )


class StepOutput:
    """Per-frame outputs around one packed (6, 2N) device tensor, or
    (B, 6, 2N) for B lanes, (T, 6, 2N) or (T, B, 6, 2N) for a chunk (each
    field then has the leading axes). Det
    rows [0, N) are the current frame's detections, rows [N, 2N) the
    FN-propagated prev boxes. The device-to-host copy starts with
    `start_fetch` (asynchronous, into pinned memory) or on first field
    access."""

    __slots__ = ("_packed", "_N", "_np", "_host", "_event")
    # the port's kernels gather by index: no window can overflow
    coverage_ok = coverage_ok_strict = True

    def __init__(self, packed: torch.Tensor, N: int):
        self._packed, self._N = packed, N
        self._np = self._host = self._event = None

    def start_fetch(self) -> "StepOutput":
        if self._packed.is_cuda and self._host is None:
            self._host = torch.empty(self._packed.shape, dtype=self._packed.dtype,
                                     pin_memory=True)
            self._host.copy_(self._packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        return self

    def array(self) -> np.ndarray:
        """The packed outputs as a host array (waits for their copy)."""
        if self._np is None:
            with annotate("step.fetch"):  # the wait for the outputs' copy
                if self._host is not None:
                    self._event.synchronize()
                    self._np = self._host.numpy()
                else:
                    self._np = self._packed.cpu().numpy()
            self._packed = None
        return self._np

    @property
    def tid(self) -> np.ndarray:  # (2N,) int32 track id per det row
        return self.array()[..., 0, :].astype(np.int32)

    @property
    def used(self) -> np.ndarray:  # (2N,) bool active-track flag
        return self.array()[..., 1, :] > 0.5

    @property
    def ref(self) -> np.ndarray:  # (2N,) f32 refined score
        return self.array()[..., 2, :]

    @property
    def keep(self) -> np.ndarray:  # (N,) bool FP-elimination survivor
        return self.array()[..., 3, : self._N] > 0.5

    @property
    def fn(self) -> np.ndarray:  # (N,) bool FN-propagation flag
        return self.array()[..., 4, : self._N] > 0.5


def _dets_with_fn(boxes, prev_boxes, dec, cls_id) -> st.FrameDets:
    """Tracker det rows of boxes (..., N, 11): kept curr dets [0, N), then
    FN-propagated prev boxes [N, 2N) moved forward by the prev frame's own
    lag prev_boxes[..., 0, 9] (eval.py:141-148), refined with 1 - P(dead).
    cls_id: an int, or an int32 tensor with one class per lane (...,)."""
    if isinstance(cls_id, torch.Tensor):
        cls_id = cls_id[..., None]
    fn_lag = prev_boxes[..., :1, 9:10]
    fn_ct = prev_boxes[..., :2] + fn_lag * prev_boxes[..., 7:9]

    def rows(a, b):  # det fields (..., N), (..., N, 2) -> (..., 2N[, 2])
        return torch.cat([a, b], dim=dec.keep.dim() - 1)

    no = torch.zeros_like(dec.keep)
    return st.FrameDets(
        ct=rows(boxes[..., :2], fn_ct),
        velocity=rows(boxes[..., 7:9], prev_boxes[..., 7:9]),
        cls=rows(torch.where(dec.keep, cls_id, -1),
                 torch.where(dec.fn, cls_id, -1)).to(torch.int32),
        score=rows(boxes[..., 10], prev_boxes[..., 10]),
        ref_score=rows(dec.ref_score, dec.fn_ref_score),
        newborn=rows(dec.newborn, no),
        dead=rows(no, no),
        valid=rows(dec.keep, dec.fn),
    )


def _packed(tid, used, ref, keep, fn) -> torch.Tensor:
    """(..., 6, 2N) f32 host-bound outputs (infer.py:254-270)."""
    pad = torch.zeros_like(ref[..., : keep.shape[-1]])
    return torch.stack([tid.float(), used.float(), ref,
                        torch.cat([keep.float(), pad], -1),
                        torch.cat([fn.float(), pad], -1),
                        torch.ones_like(ref)], dim=-2)


def _frame_on(frame: dict, dev) -> dict:
    """The frame's arrays the step reads (FRAME_KEYS, plan_*, the eval's
    points, the dynamic reader's CLOUD_KEYS) on dev; host arrays go up
    through `upload`, so a step fed from the host does not wait for the
    card's queued work."""
    return {k: upload(v, dev) for k, v in frame.items()
            if k in FRAME_KEYS or k == "points" or k in CLOUD_KEYS or k.startswith("plan_")}


def _per_lane(mask: torch.Tensor, a, b: torch.Tensor) -> torch.Tensor:
    """torch.where over a leading lane axis: a on the lanes that mask (B,)
    flags, b (B, ...) on the others."""
    return torch.where(mask.reshape(mask.shape + (1,) * (b.dim() - 1)), a, b)


def decide_and_track(pipe, m1, m2, n_prev, n_curr, boxes, prev_boxes, table: st.TrackTable,
                     id_count, lag, cls_id):
    """The step's tail over a lane axis L, at `pipe`'s thresholds and
    tracker params: decisions on m1 (L, N, N+2), m2 (L, N+2, N) and the
    counts (host ints or (L,) tensors), dead flags, FN rows and the tracker
    step from `table` and id_count (L,). Returns (the decisions,
    step_frames_core's outputs); the caller keeps its id policy."""
    dec = apply_decision_rules(m1, m2, n_prev, n_curr, fp_thresh=pipe.fp_thresh,
                               decision_thresh=pipe.decision_thresh)
    # retroactive ShaSTA dead flags: dec.dead indexes the prev frame's dets,
    # which hold slots [0, N) of their lane's table (infer.py:220-225)
    dead_pad = torch.zeros_like(table.dead)
    dead_pad[:, :dec.dead.shape[-1]] = dec.dead
    table = table._replace(dead=table.dead | (dead_pad & table.used))
    dets = _dets_with_fn(boxes, prev_boxes, dec, cls_id)
    return dec, st.step_frames_core(table, id_count, dets, lag, pipe.params)


class LaneStep:
    """The per-frame step of B lanes, for the serving pipelines and the
    eval (runner.EvalLanes). The carry: descriptors `_prev_feat` (B, N, F)
    and boxes `_prev_boxes` (B, N, 11) on the device, det counts `_n_prev`
    (B,) on the host. A step zeroes the carry of lanes starting a scene
    (only when the host flags one), runs the trunk and the affinity head,
    and the subclass's `_tail` packs the outputs from the affinities and
    the counts (host ints at one lane). `_steps` runs T steps of one upload
    (the JAX lax.scan), each in span `_STEP_SPAN` where it names one."""

    _STEP_SPAN = "step.frame"

    def __init__(self, model: ShastaModel, batch: int, fp_thresh: float, decision_thresh: float):
        self.model, self.batch = model, batch
        self.device = model.device
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        self.reset()

    def reset(self):
        """Every lane starts a scene: the carry back to zero."""
        cfg, dev, B = self.model.cfg, self.device, self.batch
        self._prev_feat = torch.zeros(
            (B, cfg.max_obj, cfg.num_point * cfg.share_conv_channel), device=dev)
        self._prev_boxes = torch.zeros((B, cfg.max_obj, 11), device=dev)
        self._n_prev = np.zeros((B,), np.int64)  # host-side, like n_curr

    def _upload(self, frames: dict, n_currs, resets, *rows):
        """Span step.upload: frames' arrays and the (T, R, B) f32 scalars
        [reset, n_prev, n_curr, *rows] of T steps (one copy; advances the
        host's n_prev). Returns (the arrays, (the scalars, their copy))."""
        with annotate("step.upload"):
            n_currs, resets = np.asarray(n_currs, np.int64), np.asarray(resets, bool)
            n_prev = np.where(resets, 0, np.concatenate([self._n_prev[None], n_currs[:-1]]))
            self._n_prev = n_currs[-1].copy()
            host = np.stack([resets, n_prev, n_currs, *rows], 1).astype(np.float32)
            return _frame_on(frames, self.device), (host, upload(host, self.device))

    def _frame(self, frame: dict, n_curr, reset, *rows) -> torch.Tensor:
        """One step of the lanes in span step.frame: frame's arrays (B, ...)
        on the host or the device, the lanes' host scalars (B,) each."""
        with annotate("step.frame"):
            f, (host, dev) = self._upload(frame, [n_curr], [reset], *([r] for r in rows))
            return self._step(f, (host[0], dev[0]))

    def _steps(self, f: dict, sc) -> torch.Tensor:
        """The T steps of one upload (f's arrays (T, B, ...), sc as
        `_upload` returns it); the T packed outputs stacked."""
        host, dev = sc
        packed = []
        for t in range(len(host)):
            with annotate(self._STEP_SPAN) if self._STEP_SPAN else contextlib.nullcontext():
                packed.append(self._step({k: v[t] for k, v in f.items()}, (host[t], dev[t])))
        return torch.stack(packed)

    def _step(self, f: dict, sc) -> torch.Tensor:
        """One step on device tensors, sc the (R, B) lane scalars on the
        host and the device; advances the carry."""
        host, dev = sc
        with torch.no_grad():
            if host[0].any():
                self._zero_lanes(dev[0] > 0.5)
            with annotate("step.trunk"):
                curr_feat = self.model.frame_features(f)
            with annotate("step.affinity"):
                m1, m2 = self.model.affinity_step(self._prev_boxes, f["det_boxes"],
                                                  self._prev_feat, curr_feat)
            counts = ([int(n) for n in host[1:3, 0]] if self.batch == 1 else (dev[1], dev[2]))
            packed = self._tail(m1, m2, f["det_boxes"], counts, dev)
        self._prev_feat, self._prev_boxes = curr_feat, f["det_boxes"]
        return packed

    def _zero_lanes(self, rz: torch.Tensor):
        """The carry of the lanes flagged in rz (B,) back to zero."""
        # False: the zero of every dtype
        self._prev_feat = _per_lane(rz, False, self._prev_feat)
        self._prev_boxes = _per_lane(rz, False, self._prev_boxes)


class BatchedScenePipeline(LaneStep):
    """Scene-parallel serving for one class model: B scene lanes advance
    one frame each per `step_frames`, every index built on the device
    (`sorted_lookup` + `gather_conv`), the tail `decide_and_track` (the
    JAX jax.vmap over scenes) on each lane's table `_table` (B, CAP, ...).
    A `reset` lane's carry and table are zeroed (a reset table's cls is 0,
    not -1) before the step. Id counters `_id_counts` start at
    lane * 1_000_000 and are never reset (infer.py:559-572)."""

    def __init__(self, model: ShastaModel, cls_id: int, batch: int,
                 params: st.TrackerParams | None = None, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5, track_cap: int | None = None):
        self.cls_id = cls_id
        self.params = params or default_tracker_params(device=model.device)
        # det-major slots hold 2N rows (curr dets + FN injections)
        self.cap = track_cap or 2 * model.cfg.max_obj * (self.params.max_age + 1)
        super().__init__(model, batch, fp_thresh, decision_thresh)

    def reset(self):
        super().reset()
        self._table = st.TrackTable.empty(self.cap, self.device, self.batch)
        self._id_counts = torch.arange(0, self.batch * 1_000_000, 1_000_000,
                                       dtype=torch.int32, device=self.device)

    def step_frames(self, frame: dict, n_curr, reset, time_lags) -> StepOutput:
        """frame: batched arrays (B, ...) of numpy arrays or tensors (the
        voxel arrays, or for the dynamic reader the points frame: rows
        `cloud` (B, N, C) and their mask `cloud_valid` (B, N)) and
        det_boxes; n_curr (B,) real det counts; reset (B,) new-scene flags;
        time_lags (B,). Returns a StepOutput whose fields have a leading
        (B,) axis."""
        return StepOutput(self._frame(frame, n_curr, reset, time_lags), self.model.cfg.max_obj)

    def step_chunk(self, frames: dict, n_currs, resets, time_lags) -> StepOutput:
        """T frames of the B lanes in one call: frames' arrays (T, B, ...),
        n_currs, resets and time_lags (T, B); one StepOutput, fetched once."""
        return StepOutput(self._steps(*self._upload(frames, n_currs, resets, time_lags)),
                          self.model.cfg.max_obj)

    def _zero_lanes(self, rz: torch.Tensor):
        super()._zero_lanes(rz)
        self._table = st.TrackTable(*(_per_lane(rz, False, t) for t in self._table))

    def _tail(self, m1, m2, boxes, counts, dev) -> torch.Tensor:
        with annotate("step.decide_track"):
            dec, (table, n_new, tid, used, ref, _) = decide_and_track(
                self, m1, m2, *counts, boxes, self._prev_boxes, self._table,
                self._id_counts, dev[3], self.cls_id)
            self._table, self._id_counts = table, self._id_counts + n_new
        return _packed(tid, used, ref, dec.keep, dec.fn)


class ScenePipeline(BatchedScenePipeline):
    """Per-frame scene inference for one class model: the
    BatchedScenePipeline of one lane, whose outputs drop the lane axis.
    A frame with plan_* arrays (shasta_tpu_torch/plans.py) runs the planned
    trunk (11 rulebook_conv + 10 keyed_conv); a frame without them builds
    every index on the device (sorted_lookup + 21 gather_conv), and nothing
    is planned on the host."""

    def __init__(self, model: ShastaModel, cls_id: int,
                 params: st.TrackerParams | None = None, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5, track_cap: int | None = None):
        super().__init__(model, cls_id, 1, params, fp_thresh, decision_thresh, track_cap)

    def step_frame(self, frame: dict, n_curr: int, time_lag: float) -> StepOutput:
        """frame: fixed-shape single-frame batch (B=1) of numpy arrays or
        tensors, with or without plan_* arrays; for the dynamic reader the
        points frame `cloud` (1, N, C), `cloud_valid` (1, N) in place of
        the voxel arrays."""
        return StepOutput(self._frame(frame, [n_curr], [False], [time_lag])[0],
                          self.model.cfg.max_obj)

    def step_chunk(self, frames: dict, n_currs, time_lags) -> StepOutput:
        """T frames of one scene in one call: frames' arrays (plan_* too, or
        none) stacked on a (T,) axis, n_currs and time_lags (T,)."""
        n = np.asarray(n_currs)[:, None]
        return StepOutput(self._steps(*self._upload(frames, n, np.zeros_like(n, bool),
                                                      np.c_[time_lags]))[:, 0],
                          self.model.cfg.max_obj)


class _ClassStepOutput(StepOutput):
    """One class's rows of a multi-class step's packed (C, 6, 2N_max)
    output: curr rows [0, N_c) and FN rows [N_max, N_max + N_c) of its
    slice (infer.py:875-907). The classes of one frame share one fetch."""

    __slots__ = ("_whole", "_index", "_cols")

    def __init__(self, whole: StepOutput, index: int, n_c: int, n_max: int):
        self._whole, self._index, self._N = whole, index, n_c
        self._cols = np.concatenate([np.arange(n_c), n_max + np.arange(n_c)])
        self._np = None

    def start_fetch(self) -> "_ClassStepOutput":
        self._whole.start_fetch()
        return self

    def array(self) -> np.ndarray:
        if self._np is None:
            self._np = self._whole.array()[self._index][:, self._cols]
        return self._np


class _SharedTrunk(torch.nn.Module):
    """The trunk of one class model (backbone or pillar reader, neck, shared
    conv) on the pipeline's device, without that model's affinity head:
    shared with the model if it lies on that device, copied there
    otherwise."""

    def __init__(self, model: ShastaModel, device: torch.device):
        super().__init__()
        self.cfg, self.names = model.cfg, model.trunk_names
        for name in self.names:
            m = getattr(model, name)
            setattr(self, name, m if model.device == device else copy.deepcopy(m).to(device))

    def bev_single(self, frame: dict) -> torch.Tensor:
        return trunk_bev(self.cfg, *(getattr(self, n) for n in self.names), frame)


class MultiClassScenePipeline:
    """Shared-trunk multi-class serving of one scene, on one device.

    The released per-class models share one frozen trunk, so the trunk runs
    once per frame (at B=1, planned or not, as ScenePipeline); the class
    heads, padded to the widest max_obj by the exact transform of
    multiclass.py, run as one class-stacked head; decisions and tracker
    steps take the classes as a leading lane axis. Each class tracks in its
    own table of 2*N_max*(max_age+1) slots; a class absent from a frame
    keeps its state from before the step. New ids are issued relative per
    class and rebased in class-major order by the global count plus the
    preceding classes' new tracks (the merged tracker's det-order numbering).

    class_models: {name: ShastaModel} over NUSCENES_TRACKING_NAMES, sharing
    the trunk geometry; they may lie on the CPU (convert.class_models_from_
    jax builds them there): the pipeline stacks their heads and copies the
    trunk of `trunk_key` to `device` (default "cuda")."""

    def __init__(self, class_models: dict, trunk_key: str = "car",
                 params: st.TrackerParams | None = None, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5, device=None):
        self.device = dev = resolve_device(device)
        self._names = tuple(n for n in NUSCENES_TRACKING_NAMES if n in class_models)
        cfgs = [class_models[n].cfg for n in self._names]
        c0 = cfgs[0]
        geom = ("pc_start", "voxel_size", "out_stride", "num_point", "share_conv_channel")
        assert all(tuple(getattr(c, g) for g in geom) == tuple(getattr(c0, g) for g in geom)
                   for c in cfgs), "class models must share the trunk geometry"
        self.max_obj = {n: c.max_obj for n, c in zip(self._names, cfgs)}
        self.n_max = N = max(self.max_obj.values())
        self.params = params or default_tracker_params(device=dev)
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        self.trunk = _SharedTrunk(class_models[trunk_key], dev)
        stacked, n_real = stack_class_heads(class_models, self._names, N)
        with torch.device(dev):
            self.head = AffinityNet(N, c0.num_feats, c0.num_point, c0.share_conv_channel,
                                    classes=len(self._names))
        self.head.load_state_dict(stacked)
        self.head.eval().requires_grad_(False)
        self._n_real = n_real.to(dev)
        self._cls_ids = torch.tensor([NUSCENES_TRACKING_NAMES.index(n) for n in self._names],
                                     dtype=torch.int32, device=dev)
        self._F = c0.num_point * c0.share_conv_channel
        self.cap = 2 * N * (self.params.max_age + 1)
        # the tracker issues each class's new ids from 0: rebased below
        self._no_ids = torch.zeros((len(self._names),), dtype=torch.int32, device=dev)
        self.reset()

    def reset(self):
        C, N, dev = len(self._names), self.n_max, self.device
        self._prev_feat = torch.zeros((C, 1, N, self._F), device=dev)
        self._prev_boxes = torch.zeros((C, 1, N, 11), device=dev)
        self._n_prev = np.zeros((C,), np.float32)  # host-side, like n_curr
        self._tables = st.TrackTable.empty(self.cap, dev, C)
        self._id_count = torch.zeros((), dtype=torch.int32, device=dev)

    def dispatch_frame(self, frame: dict, class_boxes: dict, time_lag: float):
        """Enqueue one frame's step; returns (the packed output of all
        classes, the names present) without reading anything back. frame:
        the B=1 voxel arrays, with plan_* arrays (the planned trunk) or
        without (every index built on the device); class_boxes: {name: (det boxes (1, N_c, 11),
        n_curr)} as host arrays. The tracker state has advanced on return."""
        with annotate("step.frame"):
            cfg = self.trunk.cfg
            dev, C, N = self.device, len(self._names), self.n_max
            boxes = np.zeros((C, N, 11), np.float32)
            n_curr = np.zeros((C,), np.float32)
            skip = np.ones((C,), np.float32)
            for i, n in enumerate(self._names):
                if n in class_boxes:
                    b, nc = class_boxes[n]
                    b = np.asarray(b, np.float32).reshape(-1, 11)
                    boxes[i, :b.shape[0]] = b
                    n_curr[i], skip[i] = nc, 0.0
            with annotate("step.upload"):
                f = _frame_on(frame, dev)
                # the boxes and per-class scalars in one host-to-device copy
                buf = upload(np.concatenate([boxes.reshape(-1), self._n_prev, n_curr, skip,
                                             [time_lag]]).astype(np.float32), dev)
            boxes_st = buf[:C * N * 11].view(C, 1, N, 11)
            sc = buf[C * N * 11:]
            absent = sc[2 * C:3 * C] > 0.5
            with torch.no_grad():
                with annotate("step.trunk"):
                    bev = self.trunk.bev_single(f)
                    pts = box_points_5(boxes_st[:, 0, :, :7])  # (C, N, 5, 3)
                    curr_feat = sample_bev_features(
                        bev, pts.reshape(1, C * N, *pts.shape[2:]), cfg.pc_start,
                        cfg.voxel_size, cfg.out_stride).reshape(C, 1, N, -1).float()
                with annotate("step.affinity"):
                    cb = boxes_st[:, 0]
                    m1, m2 = self.head(self._prev_boxes[:, 0, :, :7], cb[..., :7], cb[..., 7:9],
                                       cb[..., 9:10], self._prev_feat[:, 0], curr_feat[:, 0],
                                       n_real=self._n_real)
                with annotate("step.decide_track"):
                    before = self._tables
                    dec, (tables, n_new, tid, used, ref, is_new) = decide_and_track(
                        self, m1, m2, sc[:C], sc[C:2 * C], cb, self._prev_boxes[:, 0], before,
                        self._no_ids, sc[3 * C].expand(C), self._cls_ids)
                    # an absent class keeps its pre-step, pre-dead-flag table
                    tables = st.TrackTable(*(_per_lane(absent, old, new)
                                             for old, new in zip(before, tables)))
                    n_new = torch.where(absent, 0, n_new)
                    # class-major rebase of the relative new ids (infer.py:756-765)
                    base = (self._id_count + torch.cumsum(n_new, 0, dtype=torch.int32)
                            - n_new)
                    renew = is_new & ~absent[:, None]
                    tid = torch.where(renew, tid + base[:, None], tid)
                    renew_slots = torch.zeros_like(tables.used)
                    renew_slots[:, :2 * N] = renew
                    tables = tables._replace(tid=torch.where(
                        renew_slots, tables.tid + base[:, None], tables.tid))
                    id_count = self._id_count + n_new.sum().to(torch.int32)
                packed = _packed(tid, used, ref, dec.keep, dec.fn)  # (C, 6, 2N)
                self._prev_feat = _per_lane(absent, self._prev_feat, curr_feat)
                self._prev_boxes = _per_lane(absent, self._prev_boxes, boxes_st)
            self._n_prev = np.where(skip > 0.5, self._n_prev, n_curr)
            self._tables = tables
            self._id_count = id_count
            return StepOutput(packed, N), tuple(n for n in self._names if n in class_boxes)

    def step_frame(self, frame: dict, class_boxes: dict, time_lag: float) -> dict:
        """One frame of all classes present: {name: StepOutput} with the
        class's own 2*N_c rows (FN rows at [N_c, 2*N_c)). Nothing is read
        back until a field is read; then one packed tensor for all classes."""
        return self.unpack_frame(*self.dispatch_frame(frame, class_boxes, time_lag))

    def unpack_frame(self, packed: StepOutput, names) -> dict:
        """{name: StepOutput} over one dispatch_frame result, re-sliced to
        each class's rows; no fetch until a field is read."""
        return {n: _ClassStepOutput(packed, i, self.max_obj[n], self.n_max)
                for i, n in enumerate(self._names) if n in names}


RESULT_META = {"use_camera": False, "use_lidar": True, "use_radar": False,
               "use_map": False, "use_external": False}


def anno_from(src: dict, token: str, tid: int, score: float, translation=None) -> dict:
    """One tracking annotation of a detection dict (a cls_det_boxes entry)."""
    return {
        "sample_token": token,
        "translation": list(translation if translation is not None
                            else src["translation"]),
        "size": list(src["size"]),
        "rotation": list(src["rotation"]),
        "velocity": list(src["velocity"]),
        "tracking_id": str(int(tid)),
        "tracking_name": src["detection_name"],
        "tracking_score": float(score),
        "attribute_name": src.get("attribute_name"),
    }


def fn_translation(src: dict, fn_lag: float) -> list:
    """An FN-propagated prev box's translation, moved forward by the prev
    frame's stored dt times its velocity (eval.py:141-148)."""
    tr = list(src["translation"])
    tr[0] += fn_lag * src["velocity"][0]
    tr[1] += fn_lag * src["velocity"][1]
    return tr


def _progress(total: int, progress: bool):
    """A tqdm bar over `total` frames where asked for and installed, else None."""
    if not progress:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total)


def _timed(timings: dict | None, span: str | None, part: str, fn, *args):
    """fn(*args), in profiler span `span` + part where span is given; where
    timings is given, its host seconds also go to timings[part]."""
    with annotate(span + part) if span else contextlib.nullcontext():
        if timings is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        timings[part] = timings.get(part, 0.0) + time.perf_counter() - t0
        return out


def track_scene_dataset(pipeline: ScenePipeline, dataset, progress: bool = False,
                        use_host_plans: bool = False, timings: dict | None = None) -> dict:
    """Run the pipeline over a dataset of ordered frames (a
    data.nuscenes.NuScenesTrackDataset in test mode, or a list of its
    samples); returns the tracking result
    {"results": {token: [annos]}, "meta": ...} from the dataset's detection
    dicts. The pipeline resets at every scene start (a sample without
    prev_token).

    Frames run without host plans (the unplanned trunk: sorted_lookup +
    gather_conv), as the JAX CLI serves them; use_host_plans builds each
    frame's plans on the host (plans.frame_plans) and runs the planned
    trunk. Formatting is deferred two frames deep: frame i's packed output
    starts its copy to the host (StepOutput.start_fetch) as soon as its step
    is queued and is read after frame i+2's step is queued. timings, if
    given, accumulates host seconds under "read" (dataset[i]: reading and
    voxelization), "step" (queueing the step) and "format" (reading the
    outputs back and building the annotations)."""
    results: dict[str, list] = {}
    bar = _progress(len(dataset), progress)
    N = pipeline.model.cfg.max_obj
    timed = functools.partial(_timed, timings, None)

    def step(sample):
        frame = {k: sample[k][None] for k in FRAME_KEYS}
        n_curr = len(sample["cls_det_boxes"])
        lag = float(sample["det_boxes"][0, 9]) if n_curr else 0.5
        if use_host_plans:
            frame = hp.attach_plans(frame, hp.frame_plans(
                frame["coordinates"][0], frame["voxels_valid"][0], pipeline.model.cfg))
        out = pipeline.step_frame(frame, n_curr, lag)
        out.start_fetch()
        return out

    def format_out(sample, out):
        annos = []
        for k in range(len(sample["cls_det_boxes"])):
            if out.used[k]:
                annos.append(anno_from(sample["cls_det_boxes"][k], sample["token"],
                                       out.tid[k], out.ref[k]))
        # FN-propagated prev boxes tracked this frame
        prev_cls = sample.get("prev_cls_det_boxes") or []
        if prev_cls:
            fn_lag = float(sample["prev_det_boxes"][0, 9])
            for n, src in enumerate(prev_cls):
                if out.fn[n] and out.used[N + n]:
                    annos.append(anno_from(src, sample["token"], out.tid[N + n],
                                           out.ref[N + n], fn_translation(src, fn_lag)))
        results[sample["token"]] = annos

    DEPTH = 2
    pending: deque = deque()

    def drain(all_: bool = False):
        while pending and (all_ or len(pending) > DEPTH):
            format_out(*pending.popleft())

    pipeline.reset()
    for i in range(len(dataset)):
        sample = timed("read", dataset.__getitem__, i)
        if not sample["prev_token"]:
            timed("format", drain, True)
            pipeline.reset()
        pending.append((sample, timed("step", step, sample)))
        timed("format", drain)
        if bar:
            bar.update(1)
    timed("format", drain, True)
    if bar:
        bar.close()
    return {"results": results, "meta": dict(RESULT_META)}
