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

`step_chunk` advances T frames per call (the JAX lax.scan as a Python
loop over the step) and returns the T packed outputs as one tensor.
`track_scene_dataset` (infer.py:910-1040) serves a dataset of ordered
frames through a ScenePipeline and returns the tracking result.

Everything after the upload stays on the device; the host reads the
packed outputs only when a StepOutput field is accessed. The port needs
no coverage flags or safe replay: its kernels gather by index and are
exact for any input, so the last packed row (the JAX coverage row) is
always 1.
"""
from __future__ import annotations

import copy
import time
from collections import deque

import numpy as np
import torch

from . import plans as hp
from .core.bilinear import sample_bev_features
from .core.boxes import box_points_5
from .device import resolve_device, upload
from .models.affinity import AffinityNet
from .models.shasta import ShastaModel, trunk_bev
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
        return self._arr()

    def _arr(self) -> np.ndarray:
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
        return self._arr()[..., 0, :].astype(np.int32)

    @property
    def used(self) -> np.ndarray:  # (2N,) bool active-track flag
        return self._arr()[..., 1, :] > 0.5

    @property
    def ref(self) -> np.ndarray:  # (2N,) f32 refined score
        return self._arr()[..., 2, :]

    @property
    def keep(self) -> np.ndarray:  # (N,) bool FP-elimination survivor
        return self._arr()[..., 3, : self._N] > 0.5

    @property
    def fn(self) -> np.ndarray:  # (N,) bool FN-propagation flag
        return self._arr()[..., 4, : self._N] > 0.5


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
    """The frame's arrays the step reads (FRAME_KEYS and any plan_*), as
    tensors on dev; host arrays go up through `upload`, so a step fed from
    the host does not wait for the card's queued work."""
    return {k: upload(v, dev) for k, v in frame.items()
            if k in FRAME_KEYS or k.startswith("plan_")}


class ScenePipeline:
    """Per-frame scene inference for one class model, on the model's device.

    A frame with plan_* arrays (shasta_tpu_torch/plans.py) runs the planned
    trunk (11 rulebook_conv + 10 keyed_conv); a frame without them builds
    every index on the device (sorted_lookup + 21 gather_conv), and nothing
    is planned on the host."""

    def __init__(self, model: ShastaModel, cls_id: int,
                 params: st.TrackerParams | None = None, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5, track_cap: int | None = None):
        self.model, self.cls_id = model, cls_id
        self.device = model.device
        self.params = params or default_tracker_params(device=self.device)
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        N = model.cfg.max_obj
        # det-major slots hold 2N rows (curr dets + FN injections)
        self.cap = track_cap or 2 * N * (self.params.max_age + 1)
        self.reset()

    def reset(self):
        cfg, dev = self.model.cfg, self.device
        self._prev_feat = torch.zeros(
            (1, cfg.max_obj, cfg.num_point * cfg.share_conv_channel), device=dev)
        self._prev_boxes = torch.zeros((1, cfg.max_obj, 11), device=dev)
        self._n_prev = 0
        self._table = st.TrackTable.empty(self.cap, dev)
        self._id_count = torch.zeros((), dtype=torch.int32, device=dev)

    def step_frame(self, frame: dict, n_curr: int, time_lag: float) -> StepOutput:
        """frame: fixed-shape single-frame batch (B=1) of numpy arrays or
        tensors, with or without plan_* arrays."""
        with annotate("step.frame"):
            with annotate("step.upload"):
                lag = upload(np.float32(time_lag), self.device)
                f = _frame_on(frame, self.device)
            return StepOutput(self._step(f, int(n_curr), lag), self.model.cfg.max_obj)

    def step_chunk(self, frames: dict, n_currs, time_lags) -> StepOutput:
        """T consecutive frames of one scene in one call: frames' arrays
        carry a leading (T,) axis over the step_frame shapes (stacked plan_*
        arrays too, or none); n_currs and time_lags have length T. The carry
        stays on the device across the T steps (the JAX lax.scan), and the
        (T, 6, 2N) outputs come back as one StepOutput, fetched once."""
        with annotate("step.upload"):
            f = _frame_on(frames, self.device)
            lags = upload(np.asarray(time_lags, np.float32), self.device)
        packed = []
        for t, n in enumerate(n_currs):
            with annotate("step.frame"):
                packed.append(self._step({k: v[t] for k, v in f.items()}, int(n), lags[t]))
        return StepOutput(torch.stack(packed), self.model.cfg.max_obj)

    def _step(self, f: dict, n_curr: int, lag: torch.Tensor) -> torch.Tensor:
        """One step on device tensors; advances the carry and returns the
        packed (6, 2N) outputs."""
        N = self.model.cfg.max_obj
        with torch.no_grad():
            with annotate("step.trunk"):
                curr_feat = self.model.frame_features(f)
            with annotate("step.affinity"):
                m1, m2 = self.model.affinity_step(self._prev_boxes, f["det_boxes"],
                                                  self._prev_feat, curr_feat)
            with annotate("step.decide_track"):
                dec = apply_decision_rules(m1[0], m2[0], self._n_prev, n_curr,
                                           fp_thresh=self.fp_thresh,
                                           decision_thresh=self.decision_thresh)
                # retroactive ShaSTA dead flags: dec.dead indexes the prev
                # frame's dets, which hold table slots 0..N-1 (infer.py:220-225)
                table = self._table
                dead_pad = torch.zeros_like(table.dead)
                dead_pad[:N] = dec.dead
                table = table._replace(dead=table.dead | (dead_pad & table.used))
                dets = _dets_with_fn(f["det_boxes"][0], self._prev_boxes[0], dec,
                                     self.cls_id)
                table, id_count, tid, used, ref = st.step_frame(
                    table, self._id_count, dets, lag, self.params)
            packed = _packed(tid, used, ref, dec.keep, dec.fn)
        self._prev_feat = curr_feat
        self._prev_boxes = f["det_boxes"]
        self._n_prev = n_curr
        self._table = table
        self._id_count = id_count
        return packed


class BatchedScenePipeline:
    """Scene-parallel serving for one class model: B independent scene
    lanes advance one frame each per `step_frames`, on the model's device.

    The trunk and affinity head run batched over the lanes, with no host
    plans: every sparse index is built on the device (`sorted_lookup`) and
    every conv runs `gather_conv`. The decision rules and the tracker step
    take the lanes as a leading axis (the JAX jax.vmap over scenes). Scenes
    of different lengths use the per-lane `reset` mask: a True entry zeroes
    that lane's carried descriptors, boxes, n_prev and every track-table
    field (zeros_like, so a reset table's cls is 0, not -1) before the
    step. Id counters start at lane * 1_000_000 and are never reset, which
    keeps ids unique across lanes (infer.py:559-572)."""

    def __init__(self, model: ShastaModel, cls_id: int, batch: int,
                 params: st.TrackerParams | None = None, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5, track_cap: int | None = None):
        self.model, self.cls_id, self.batch = model, cls_id, batch
        self.device = model.device
        self.params = params or default_tracker_params(device=self.device)
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        self.cap = track_cap or 2 * model.cfg.max_obj * (self.params.max_age + 1)
        self.reset()

    def reset(self):
        cfg, dev, B = self.model.cfg, self.device, self.batch
        self._prev_feat = torch.zeros(
            (B, cfg.max_obj, cfg.num_point * cfg.share_conv_channel), device=dev)
        self._prev_boxes = torch.zeros((B, cfg.max_obj, 11), device=dev)
        self._n_prev = np.zeros((B,), np.int64)  # host-side, like n_curr
        self._tables = st.TrackTable(*(t.expand((B,) + t.shape).clone()
                                       for t in st.TrackTable.empty(self.cap, dev)))
        self._id_counts = torch.arange(B, dtype=torch.int32, device=dev) * 1_000_000

    def _scalars(self, n_currs, resets, time_lags) -> np.ndarray:
        """(T, 4, B) f32 per-step lane scalars [reset, n_prev, n_curr, lag]
        for T steps from the carried n_prev; advances the host-side n_prev."""
        n_currs = np.asarray(n_currs, np.int64)
        resets = np.asarray(resets, bool)
        rows = []
        for n_curr, reset, lags in zip(n_currs, resets, np.asarray(time_lags)):
            rows.append(np.stack([reset, np.where(reset, 0, self._n_prev), n_curr, lags]))
            self._n_prev = n_curr
        return np.stack(rows).astype(np.float32)

    def step_frames(self, frame: dict, n_curr, reset, time_lags) -> StepOutput:
        """frame: batched arrays (B, ...) of numpy arrays or tensors; n_curr
        (B,) real det counts; reset (B,) new-scene flags; time_lags (B,).
        Returns a StepOutput whose fields have a leading (B,) axis."""
        with annotate("step.frame"):
            with annotate("step.upload"):
                # the per-lane scalars in one host-to-device copy
                sc = upload(self._scalars([n_curr], [reset], [time_lags])[0], self.device)
                f = _frame_on(frame, self.device)
            return StepOutput(self._step(f, sc), self.model.cfg.max_obj)

    def step_chunk(self, frames: dict, n_currs, resets, time_lags) -> StepOutput:
        """All B lanes through T frames in one call: frames' arrays are
        (T, B, ...); n_currs, resets and time_lags (T, B). The carry stays
        on the device across the T steps; the (T, B, 6, 2N) outputs come
        back as one StepOutput, fetched once."""
        with annotate("step.upload"):
            f = _frame_on(frames, self.device)
            sc = upload(self._scalars(n_currs, resets, time_lags), self.device)
        packed = []
        for t in range(sc.shape[0]):
            with annotate("step.frame"):
                packed.append(self._step({k: v[t] for k, v in f.items()}, sc[t]))
        return StepOutput(torch.stack(packed), self.model.cfg.max_obj)

    def _step(self, f: dict, sc: torch.Tensor) -> torch.Tensor:
        """One step on device tensors, sc the (4, B) lane scalars; advances
        the device carry and returns the packed (B, 6, 2N) outputs."""
        N, B = self.model.cfg.max_obj, self.batch
        rz = sc[0] > 0.5
        with torch.no_grad():
            prev_feat = torch.where(rz[:, None, None], 0.0, self._prev_feat)
            prev_boxes = torch.where(rz[:, None, None], 0.0, self._prev_boxes)
            tables = st.TrackTable(*(
                torch.where(rz.reshape((B,) + (1,) * (t.dim() - 1)), torch.zeros_like(t), t)
                for t in self._tables))
            with annotate("step.trunk"):
                curr_feat = self.model.frame_features(f)
            with annotate("step.affinity"):
                m1, m2 = self.model.affinity_step(prev_boxes, f["det_boxes"],
                                                  prev_feat, curr_feat)
            with annotate("step.decide_track"):
                dec = apply_decision_rules(m1, m2, sc[1].to(torch.int32),
                                           sc[2].to(torch.int32),
                                           fp_thresh=self.fp_thresh,
                                           decision_thresh=self.decision_thresh)
                # retroactive dead flags onto each lane's prev-det slots
                dead_pad = torch.zeros_like(tables.dead)
                dead_pad[:, :N] = dec.dead
                tables = tables._replace(dead=tables.dead | (dead_pad & tables.used))
                dets = _dets_with_fn(f["det_boxes"], prev_boxes, dec, self.cls_id)
                tables, id_counts, tid, used, ref = st.step_frames(
                    tables, self._id_counts, dets, sc[3], self.params)
            packed = _packed(tid, used, ref, dec.keep, dec.fn)
        self._prev_feat = curr_feat
        self._prev_boxes = f["det_boxes"]
        self._tables = tables
        self._id_counts = id_counts
        return packed


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

    def _arr(self) -> np.ndarray:
        if self._np is None:
            self._np = self._whole._arr()[self._index][:, self._cols]
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
        self.reset()

    def reset(self):
        C, N, dev = len(self._names), self.n_max, self.device
        self._prev_feat = torch.zeros((C, 1, N, self._F), device=dev)
        self._prev_boxes = torch.zeros((C, 1, N, 11), device=dev)
        self._n_prev = np.zeros((C,), np.float32)  # host-side, like n_curr
        self._tables = st.TrackTable(*(t.expand((C,) + t.shape).clone()
                                       for t in st.TrackTable.empty(self.cap, dev)))
        self._id_count = torch.zeros((), dtype=torch.int32, device=dev)

    def dispatch_frame(self, frame: dict, class_boxes: dict, time_lag: float):
        """Enqueue one frame's step; returns (the packed output of all
        classes, the names present) without reading anything back. frame:
        the B=1 voxel arrays, with plan_* arrays (the planned trunk) or
        without (every index built on the device); class_boxes: {name: (det boxes (1, N_c, 11),
        n_curr)} as host arrays. The tracker state has advanced on return."""
        with annotate("step.frame"):
            return self._dispatch(frame, class_boxes, time_lag)

    def _dispatch(self, frame: dict, class_boxes: dict, time_lag: float):
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
                dec = apply_decision_rules(m1, m2, sc[:C].to(torch.int32),
                                           sc[C:2 * C].to(torch.int32),
                                           fp_thresh=self.fp_thresh,
                                           decision_thresh=self.decision_thresh)
                # retroactive dead flags: prev dets hold slots [0, N) of their
                # class table (infer.py:737-742)
                before = self._tables
                dead_pad = torch.zeros_like(before.dead)
                dead_pad[:, :N] = dec.dead
                tables = before._replace(dead=before.dead | (dead_pad & before.used))
                dets = _dets_with_fn(cb, self._prev_boxes[:, 0], dec, self._cls_ids)
                tables, n_new, tid, used, ref, is_new = st.step_frames_core(
                    tables, torch.zeros((C,), dtype=torch.int32, device=dev), dets,
                    sc[3 * C].expand(C), self.params)
                # an absent class keeps its pre-step, pre-dead-flag table
                tables = st.TrackTable(*(
                    torch.where(absent.reshape((C,) + (1,) * (new.dim() - 1)), old, new)
                    for new, old in zip(tables, before)))
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
            keep_prev = absent[:, None, None, None]
            self._prev_feat = torch.where(keep_prev, self._prev_feat, curr_feat)
            self._prev_boxes = torch.where(keep_prev, self._prev_boxes, boxes_st)
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
    it = range(len(dataset))
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(it)
        except ImportError:
            pass
    N = pipeline.model.cfg.max_obj
    spent = timings if timings is not None else {}

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0
        return out

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
    for i in it:
        sample = timed("read", dataset.__getitem__, i)
        if not sample["prev_token"]:
            timed("format", drain, True)
            pipeline.reset()
        pending.append((sample, timed("step", step, sample)))
        timed("format", drain)
    timed("format", drain, True)
    return {"results": results, "meta": dict(RESULT_META)}
