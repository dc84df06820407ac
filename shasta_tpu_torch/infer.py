"""Single-class scene serving, one step per frame: the port of
ScenePipeline.step_frame (shasta_tpu/infer.py:154-374) and of
BatchedScenePipeline.step_frames (:377-600), which advances B scene lanes
one frame each in one step.

  carry = (prev descriptors, prev boxes, track table, id counter), per lane
  step:  trunk (one frame per lane) -> BEV descriptors -> affinity vs
         carried prev -> decision rules + FN injection -> scan-tracker step
  out:   one packed (6, 2N) f32 tensor, (B, 6, 2N) for B lanes: track ids,
         used flags, refined scores, keep flags, FN flags and a row of ones

Everything after the upload stays on the device; the host reads the
packed outputs only when a StepOutput field is accessed. The port needs
no coverage flags or safe replay: its kernels gather by index and are
exact for any input, so the last packed row (the JAX coverage row) is
always 1.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .device import upload
from .models.shasta import ShastaModel
from .plans import attach_plans, frame_plans
from .tracker import scan_tracker as st
from .tracker.decision import apply_decision_rules
from .tracker.pub_tracker import (NUSCENE_CLS_VELOCITY_ERROR,
                                  NUSCENES_TRACKING_NAMES, TRK_REF)

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
    (B, 6, 2N) for B lanes (each field then has a leading (B,) axis). Det
    rows [0, N) are the current frame's detections, rows [N, 2N) the
    FN-propagated prev boxes. The device-to-host copy starts with
    `start_fetch` (asynchronous, into pinned memory) or on first field
    access."""

    __slots__ = ("_packed", "_N", "_np", "_host", "_event")

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

    def _arr(self) -> np.ndarray:
        if self._np is None:
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


def _dets_with_fn(boxes, prev_boxes, dec, cls_id: int) -> st.FrameDets:
    """Tracker det rows of boxes (..., N, 11): kept curr dets [0, N), then
    FN-propagated prev boxes [N, 2N) moved forward by the prev frame's own
    lag prev_boxes[..., 0, 9] (eval.py:141-148), refined with 1 - P(dead)."""
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


class ScenePipeline:
    """Per-frame scene inference for one class model, on the model's device."""

    def __init__(self, model: ShastaModel, cls_id: int,
                 params: st.TrackerParams | None = None, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5):
        self.model, self.cls_id = model, cls_id
        self.device = model.device
        self.params = params or default_tracker_params(device=self.device)
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        N = model.cfg.max_obj
        # det-major slots hold 2N rows (curr dets + FN injections)
        self.cap = 2 * N * (self.params.max_age + 1)
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
        tensors; plan_* arrays are built on the host when absent."""
        if not any(k.startswith("plan_") for k in frame):
            frame = attach_plans(frame, frame_plans(
                np.asarray(torch.as_tensor(frame["coordinates"]).cpu())[0],
                np.asarray(torch.as_tensor(frame["voxels_valid"]).cpu())[0],
                self.model.cfg))
        dev, N = self.device, self.model.cfg.max_obj
        f = {k: torch.as_tensor(v, device=dev) for k, v in frame.items()
             if k in FRAME_KEYS or k.startswith("plan_")}
        lag = upload(np.float32(time_lag), dev)
        with torch.no_grad():
            with record_function("step.trunk"):
                curr_feat = self.model.frame_features(f)
            with record_function("step.affinity"):
                m1, m2 = self.model.affinity_step(self._prev_boxes, f["det_boxes"],
                                                  self._prev_feat, curr_feat)
            with record_function("step.decide_track"):
                dec = apply_decision_rules(m1[0], m2[0], self._n_prev, int(n_curr),
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
        self._n_prev = int(n_curr)
        self._table = table
        self._id_count = id_count
        return StepOutput(packed, N)


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
                 decision_thresh: float = 0.5):
        self.model, self.cls_id, self.batch = model, cls_id, batch
        self.device = model.device
        self.params = params or default_tracker_params(device=self.device)
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        self.cap = 2 * model.cfg.max_obj * (self.params.max_age + 1)
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

    def step_frames(self, frame: dict, n_curr, reset, time_lags) -> StepOutput:
        """frame: batched arrays (B, ...) of numpy arrays or tensors; n_curr
        (B,) real det counts; reset (B,) new-scene flags; time_lags (B,).
        Returns a StepOutput whose fields have a leading (B,) axis."""
        dev, N, B = self.device, self.model.cfg.max_obj, self.batch
        f = {k: torch.as_tensor(v, device=dev) for k, v in frame.items() if k in FRAME_KEYS}
        reset = np.asarray(reset, bool)
        n_curr = np.asarray(n_curr, np.int64)
        n_prev = np.where(reset, 0, self._n_prev)
        # the per-lane scalars in one host-to-device copy
        sc = upload(np.stack([reset, n_prev, n_curr, np.asarray(time_lags)])
                    .astype(np.float32), dev)
        rz = sc[0] > 0.5
        with torch.no_grad():
            prev_feat = torch.where(rz[:, None, None], 0.0, self._prev_feat)
            prev_boxes = torch.where(rz[:, None, None], 0.0, self._prev_boxes)
            tables = st.TrackTable(*(
                torch.where(rz.reshape((B,) + (1,) * (t.dim() - 1)), torch.zeros_like(t), t)
                for t in self._tables))
            with record_function("step.trunk"):
                curr_feat = self.model.frame_features(f)
            with record_function("step.affinity"):
                m1, m2 = self.model.affinity_step(prev_boxes, f["det_boxes"],
                                                  prev_feat, curr_feat)
            with record_function("step.decide_track"):
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
        self._n_prev = n_curr
        self._tables = tables
        self._id_counts = id_counts
        return StepOutput(packed, N)
