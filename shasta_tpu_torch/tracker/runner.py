"""The affinity eval and the host tracking runs of the eval CLIs, and their
scoring: the port of shasta_tpu/tracker/runner.py.

Behavioral reference: tools/nusc_shasta/eval.py:61-195 (the per-pair eval
loop: FN propagation, retroactive dead marking), eval.py:197-305
(save_first_frame, track), validate.py:24-301.

- `run_affinity_eval`: the reference-shaped loop, the two-frame forward
  (`ShastaModel.forward`) on every (prev, curr) pair.
- `run_affinity_eval_batched`: B scene lanes (`EvalLanes`), the trunk once
  per frame with each lane's descriptors carried; frames are read from
  the dataset only when their row of the lane schedule is staged.
Both run the decision rules on the model's device and fetch one packed
(6, N) row block per pair or lane; this module assembles the nuScenes
annotation dicts around them on the host. The port has no coverage flags
(its kernels gather by index and are exact for any input), so the JAX
loop's safe replay and its packed `ok` row have no counterpart.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from ..data.nuscenes import collate
from ..device import upload
from ..infer import FRAME_KEYS, RESULT_META, StepOutput, _frame_on
from ..mot.amota import evaluate_amota, frames_from_tracking_result
from .decision import apply_decision_rules
from .pub_tracker import PubTracker, PubTrackerMerged

# the two-frame forward's arrays: the curr frame's and their prev_ mirrors
PAIR_KEYS = FRAME_KEYS + tuple("prev_" + k for k in FRAME_KEYS)


def _decision_rows(dec) -> torch.Tensor:
    """(..., 6, N) f32 host-bound rows of the decisions: dead, fn, fn_ref,
    keep, newborn, ref (the JAX packed rows without the coverage row)."""
    return torch.stack([dec.dead.float(), dec.fn.float(), dec.fn_ref_score,
                        dec.keep.float(), dec.newborn.float(), dec.ref_score], dim=-2)


def _unpack(p: np.ndarray) -> dict:
    """One pair's or lane's (6, N) rows -> the decision arrays."""
    return {"dead": p[0] > 0.5, "fn": p[1] > 0.5, "fn_ref": p[2],
            "keep": p[3] > 0.5, "newborn": p[4] > 0.5, "ref": p[5]}


def _progress(total: int, progress: bool):
    """A tqdm bar over `total` frames where asked for and installed, else None."""
    if not progress:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total)


def run_affinity_eval(model, dataset, fp_thresh: float = 0.7, decision_thresh: float = 0.5,
                      progress: bool = False) -> dict:
    """The reference-shaped eval (eval.py:103-193): for every sample of
    `dataset` (read in index order), the two-frame forward of `model` (a
    ShastaModel: both frames' trunks as one sparse batch), the decision
    rules on its device and the refined annotation lists. Each pair's
    decisions are fetched once, one pair behind the next pair's forward."""
    dev, N = model.device, model.cfg.max_obj
    nusc_annos: dict[str, Any] = {"results": {}, "meta": None}
    dead_tracker: dict[str, dict] = {}
    bar = _progress(len(dataset), progress)
    pending = None
    for i in range(len(dataset)):
        sample = dataset[i]
        batch = collate([sample])
        with torch.no_grad():
            m1, m2 = model({k: upload(batch[k], dev) for k in PAIR_KEYS})
            dec = apply_decision_rules(m1[0], m2[0], len(sample["prev_cls_det_boxes"]),
                                       len(sample["cls_det_boxes"]), fp_thresh=fp_thresh,
                                       decision_thresh=decision_thresh)
        out = StepOutput(_decision_rows(dec), N).start_fetch()
        if pending is not None:
            _assemble_frame_annos(pending[0], _unpack(pending[1].array()), nusc_annos,
                                  dead_tracker)
        pending = (sample, out)
        if bar:
            bar.update(1)
    if pending is not None:
        _assemble_frame_annos(pending[0], _unpack(pending[1].array()), nusc_annos, dead_tracker)
    if bar:
        bar.close()
    return _finalize_annos(nusc_annos, dead_tracker)


def _assemble_frame_annos(sample, dec_np, nusc_annos, dead_tracker):
    """The annotations of one (prev, curr) pair (eval.py:103-193): FN
    propagation, the FP survivors, newborn flags, dead bookkeeping."""
    token = sample["token"]
    dead_tracker.setdefault(token, {"dead_idx": [], "keep_idx": []})
    cls_det_boxes = sample["cls_det_boxes"]
    prev_cls = sample["prev_cls_det_boxes"]
    n_prev, n_curr = len(prev_cls), len(cls_det_boxes)

    annos: list[dict] = []
    fn_annos: list[dict] = []
    if n_prev > 0:
        prev_token = sample["prev_token"]
        dead_tracker.setdefault(prev_token, {"dead_idx": [], "keep_idx": []})
        time_lag = float(sample["prev_det_boxes"][0, 9])
        for n in range(n_prev):
            if dec_np["dead"][n]:
                dead_tracker[prev_token]["dead_idx"].append(n)
            elif dec_np["fn"][n]:
                a = dict(prev_cls[n])
                a["translation"] = list(a["translation"])
                a["translation"][:2] = [t + time_lag * v
                                        for t, v in zip(a["translation"][:2], a["velocity"])]
                a["FN"] = True
                a["token"] = token
                a["ref_detection_score"] = float(dec_np["fn_ref"][n])
                fn_annos.append(a)

    keep_idx = []
    for k in range(n_curr):
        if not dec_np["keep"][k]:
            continue
        a = dict(cls_det_boxes[k])
        if dec_np["newborn"][k]:
            a["newborn"] = True
        a["ref_detection_score"] = float(dec_np["ref"][k])
        keep_idx.append(k)
        annos.append(a)
    dead_tracker[token]["keep_idx"] = keep_idx
    annos.extend(fn_annos)
    nusc_annos["results"][token] = annos


def _finalize_annos(nusc_annos, dead_tracker):
    """Retroactive dead marking (eval.py:175-181) and the meta."""
    for token, annos in nusc_annos["results"].items():
        keep_idx = dead_tracker[token]["keep_idx"]
        for i in dead_tracker[token]["dead_idx"]:
            if i in keep_idx:
                annos[keep_idx.index(i)]["dead"] = True
    nusc_annos["meta"] = dict(RESULT_META)
    return nusc_annos


def lane_schedule(scene_lengths: list[int], batch: int) -> list[list]:
    """The lane schedule of the batched eval (runner.py:261-339): rows of
    per-lane (scene, frame position), None for an idle lane. Scenes start
    on lanes 0.. in order; a lane whose scene ends takes the next scene
    of the queue at its next row, or idles once the queue is empty."""
    queue = list(range(len(scene_lengths)))
    lane_scene = [queue.pop(0) if queue else -1 for _ in range(batch)]
    lane_pos = [0] * batch
    rows = []
    while any(si >= 0 for si in lane_scene):
        rows.append([(si, lane_pos[li]) if si >= 0 else None
                     for li, si in enumerate(lane_scene)])
        for li in range(batch):
            if lane_scene[li] < 0:
                continue
            lane_pos[li] += 1
            if lane_pos[li] >= scene_lengths[lane_scene[li]]:
                lane_scene[li] = queue.pop(0) if queue else -1
                lane_pos[li] = 0
    return rows


class EvalLanes:
    """The scene-batched eval step (runner.py:167-245) on the model's
    device: B scene lanes advance one frame each per step. The trunk runs
    once per frame (`frame_features`, every index built on the device:
    12 sorted_lookup + 21 gather_conv per step), the affinity head scores
    each lane's frame against its carried descriptors and boxes, and the
    decision rules take the lanes as a leading axis. A lane that resets
    starts its scene: its carried descriptors, boxes and n_prev count as
    zero. n_prev is carried on the host, as n_curr is given."""

    def __init__(self, model, batch: int, fp_thresh: float = 0.7,
                 decision_thresh: float = 0.5):
        self.model, self.batch = model, batch
        self.device = model.device
        self.fp_thresh, self.decision_thresh = fp_thresh, decision_thresh
        cfg = model.cfg
        self._prev_feat = torch.zeros(
            (batch, cfg.max_obj, cfg.num_point * cfg.share_conv_channel), device=self.device)
        self._prev_boxes = torch.zeros((batch, cfg.max_obj, 11), device=self.device)
        self._n_prev = np.zeros((batch,), np.int64)

    def step_chunk(self, frames: dict, resets, n_currs) -> StepOutput:
        """T steps in one call: frames' FRAME_KEYS arrays are (T, B, ...)
        numpy arrays or tensors, resets and n_currs (T, B). The carry stays
        on the device across the T steps (the JAX lax.scan); the (T, B, 6,
        N) decision rows come back as one StepOutput (`array()`), not
        fetched until asked."""
        rows = []
        for reset, n_curr in zip(np.asarray(resets, bool), np.asarray(n_currs, np.int64)):
            rows.append(np.stack([reset, np.where(reset, 0, self._n_prev), n_curr]))
            self._n_prev = n_curr
        # the per-lane scalars of all T steps in one host-to-device copy
        sc = upload(np.stack(rows).astype(np.float32), self.device)
        f = _frame_on(frames, self.device)
        packed = [self._step({k: v[t] for k, v in f.items()}, sc[t])
                  for t in range(sc.shape[0])]
        return StepOutput(torch.stack(packed), self.model.cfg.max_obj)

    def _step(self, f: dict, sc: torch.Tensor) -> torch.Tensor:
        """One step on device tensors, sc the (3, B) [reset, n_prev, n_curr]
        lane scalars; advances the carry, returns the (B, 6, N) rows."""
        rz = (sc[0] > 0.5)[:, None, None]
        with torch.no_grad():
            prev_feat = torch.where(rz, 0.0, self._prev_feat)
            prev_boxes = torch.where(rz, 0.0, self._prev_boxes)
            with record_function("step.trunk"):
                curr_feat = self.model.frame_features(f)
            with record_function("step.affinity"):
                m1, m2 = self.model.affinity_step(prev_boxes, f["det_boxes"], prev_feat,
                                                  curr_feat)
            with record_function("step.decide"):
                dec = apply_decision_rules(m1, m2, sc[1].to(torch.int32), sc[2].to(torch.int32),
                                           fp_thresh=self.fp_thresh,
                                           decision_thresh=self.decision_thresh)
                packed = _decision_rows(dec)
        self._prev_feat, self._prev_boxes = curr_feat, f["det_boxes"]
        return packed


def run_affinity_eval_batched(model, dataset, batch: int = 8, fp_thresh: float = 0.7,
                              decision_thresh: float = 0.5, progress: bool = False,
                              chunk: int = 1, timings: dict | None = None) -> dict:
    """The scene-batched eval (runner.py:136-470) of a NuScenesTrackDataset
    in test mode: B = `batch` scene lanes through `EvalLanes`, `chunk`
    steps per call. Returns the annotations run_affinity_eval gives, where
    two conditions hold, as in the JAX package:
    - the stage caps hold every lane's sets. The caps count the whole
      batch and keep the smallest keys, which are the first lanes' (keys
      are batch-major), so at many lanes the later lanes' sets are cut;
    - the frame is not a scene's first. There the step zeroes the carried
      descriptors, while the pair forward samples the frame's own map at
      the zero prev boxes; the head's softmax spans those rows, so scores
      and decisions may differ.

    The lane schedule (`lane_schedule`) comes from the samples' metadata
    (`dataset.metadata()`: no cloud read); a frame is read
    (`dataset.read_at`, bit-equal to an in-order read) when its row is
    staged. An idle lane runs a copy of the row's first active frame with
    reset set and no dets. Each call's decisions start their copy to the
    host as soon as it is queued and are assembled after the next call is
    queued. timings, if given, accumulates host seconds under "read"
    (metadata and reading frames, voxelization included), "step" (staging
    and queueing calls) and "assemble" (reading decisions back, building
    the annotations)."""
    spent = timings if timings is not None else {}

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[part] = spent.get(part, 0.0) + time.perf_counter() - t0
        return out

    meta = timed("read", dataset.metadata)
    scenes: list[list[int]] = []
    for i, m in enumerate(meta):
        if not m["prev_token"] or not scenes:
            scenes.append([])
        scenes[-1].append(i)
    sched = lane_schedule([len(s) for s in scenes], batch)
    lanes = EvalLanes(model, batch, fp_thresh, decision_thresh)

    def read_row(row):
        """(lane samples, None where idle, and each lane's FRAME_KEYS arrays)."""
        samples = [None if e is None else dataset.read_at(scenes[e[0]][e[1]],
                                                          meta[scenes[e[0]][e[1]]]["rng_state"])
                   for e in row]
        template = next(s for s in samples if s is not None)
        return samples, [{k: (template if s is None else s)[k] for k in FRAME_KEYS}
                         for s in samples]

    nusc_annos: dict[str, Any] = {"results": {}, "meta": None}
    dead_tracker: dict[str, dict] = {}
    bar = _progress(len(meta), progress)

    def assemble(entry):
        row_samples, out = entry
        arr = out.array()  # (T, B, 6, N)
        for t, samples in enumerate(row_samples):
            for li, s in enumerate(samples):
                if s is not None:
                    _assemble_frame_annos(s, _unpack(arr[t, li]), nusc_annos, dead_tracker)
                    if bar:
                        bar.update(1)

    def stage(lane_frames, T):
        """(T, B, ...) arrays; collate pads occupancy-tiered frames to the
        call's widest voxel count (padded rows are invalid: no result
        changes)."""
        return {k: v.reshape((T, batch) + v.shape[1:]) for k, v in collate(lane_frames).items()}

    # the tail group is padded with idle rows, which rerun the last frames
    sched = sched + [[None] * batch] * ((-len(sched)) % chunk)
    pending, frames = None, None
    for t0 in range(0, len(sched), chunk):
        row_samples, lane_frames, resets, n_currs = [], [], [], []
        for row in sched[t0:t0 + chunk]:
            if any(e is not None for e in row):
                samples, frames = timed("read", read_row, row)
            else:
                samples = [None] * batch
            row_samples.append(samples)
            lane_frames += frames
            resets.append([e is None or e[1] == 0 for e in row])
            n_currs.append([0 if s is None else len(s["cls_det_boxes"]) for s in samples])
        out = timed("step", lambda: lanes.step_chunk(stage(lane_frames, len(resets)), resets,
                                                     n_currs).start_fetch())
        if pending is not None:
            timed("assemble", assemble, pending)
        pending = (row_samples, out)
    if pending is not None:
        timed("assemble", assemble, pending)
    if bar:
        bar.close()
    if len(nusc_annos["results"]) != len(meta):
        raise RuntimeError(f"assembled {len(nusc_annos['results'])} of {len(meta)} frames")
    return _finalize_annos(nusc_annos, dead_tracker)


def save_first_frame(frame_info_path: str, save_path: str) -> list[dict]:
    """frames_meta.json from the frame_info artifact, ordered by timestamp
    (eval.py:197-223, without the devkit: a scene starts where prev is
    empty). Returns the frames."""
    with open(frame_info_path) as f:
        frame_info = json.load(f)
    frames = [{"token": tok, "timestamp": fi["timestamp"] * 1e-6, "first": fi["prev"] == ""}
              for tok, fi in frame_info.items()]
    frames.sort(key=lambda f: f["timestamp"])
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "frames_meta.json"), "w") as f:
        json.dump({"frames": frames}, f)
    return frames


def track(predictions: dict, frames: list[dict], max_age: int = 4, hungarian: bool = False,
          refine_confidence: bool = False, alpha: float = 0.5, beta: float = 0.5,
          merged: bool = False) -> tuple[dict, float]:
    """Host tracking over the ordered frames (eval.py:226-305) with
    PubTracker, or PubTrackerMerged where `merged`. Returns (the tracking
    result, frames/s of the loop)."""
    if merged:
        tracker = PubTrackerMerged(max_age=max_age, hungarian=hungarian)
    else:
        tracker = PubTracker(max_age=max_age, hungarian=hungarian,
                             refine_confidence=refine_confidence, alpha=alpha, beta=beta)
    nusc_annos: dict[str, Any] = {"results": {}, "meta": None}
    start = time.time()
    last_ts = 0.0
    for fr in frames:
        token = fr["token"]
        if fr["first"]:
            tracker.reset()
            last_ts = fr["timestamp"]
        time_lag = fr["timestamp"] - last_ts
        last_ts = fr["timestamp"]
        outputs = tracker.step_centertrack(predictions.get(token, []), time_lag)
        annos = []
        for item in outputs:
            if item["active"] == 0:
                continue
            a = {
                "sample_token": token,
                "translation": list(item["translation"]),
                "size": list(item["size"]),
                "rotation": list(item["rotation"]),
                "velocity": list(item["velocity"]),
                "tracking_id": str(item["tracking_id"]),
                "tracking_name": item["detection_name"],
                "tracking_score": item["detection_score"],
                "attribute_name": item.get("attribute_name"),
            }
            if refine_confidence or merged:
                a["tracking_score"] = item["ref_detection_score"]
            annos.append(a)
        nusc_annos["results"][token] = annos
    fps = len(frames) / max(time.time() - start, 1e-9)
    nusc_annos["meta"] = dict(RESULT_META)
    return nusc_annos, fps


GENERAL_TO_TRACKING = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.bus": "bus",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
}


def eval_tracking_lite(results: dict, gt_info_dir: str, classes=None) -> dict:
    """Devkit-free AMOTA over the gt_info per-frame artifacts
    ({gt_info_dir}/{token}.json with frame_ids, frame_types and
    frame_bboxes). A development metric: the official TrackingEval remains
    the reporting path. results: {token: [annos]} of a tracking result."""
    gt: dict[str, list] = {}
    for tok in results:
        path = os.path.join(gt_info_dir, tok + ".json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            d = json.load(f)
        annos = []
        for gid, gtype, box in zip(d["frame_ids"], d["frame_types"], d["frame_bboxes"]):
            name = GENERAL_TO_TRACKING.get(gtype)
            if name is None:
                continue
            annos.append({
                "instance_id": gid,
                "translation": list(box[:3]),
                "tracking_name": name,
            })
        gt[tok] = annos

    classes = classes or sorted({a["tracking_name"] for v in gt.values() for a in v})
    out = {}
    for cls in classes:
        gt_frames, hyp_frames = frames_from_tracking_result(results, gt, cls)
        out[cls] = evaluate_amota(gt_frames, hyp_frames)
    if out:
        out["mean_amota"] = float(
            sum(v["amota"] for k, v in out.items() if isinstance(v, dict)) / len(out)
        )
    return out


def eval_tracking_nuscenes(res_path, eval_set, output_dir, nusc_version, root_path):
    """The official TrackingEval (eval.py:322-339). The nuScenes devkit is
    optional: without it this prints that it skips and returns None."""
    try:
        from nuscenes.eval.common.config import config_factory as track_configs
        from nuscenes.eval.tracking.evaluate import TrackingEval
    except ImportError:
        print("nuscenes devkit not available; skipping official TrackingEval")
        return None
    nusc_eval = TrackingEval(config=track_configs("tracking_nips_2019"), result_path=res_path,
                             eval_set=eval_set, output_dir=output_dir, verbose=True,
                             nusc_version=nusc_version, nusc_dataroot=root_path)
    return nusc_eval.main()
