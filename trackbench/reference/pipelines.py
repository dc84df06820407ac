"""The reference's runs of the three entries the cells drive, built on
model.py and tracker.py: a scene stream of one class or of several classes
on one shared trunk (the serving step), and the per-pair decisions of the
offline eval. Everything runs in float32 with TF32 off, one frame at a
time."""
from __future__ import annotations

import numpy as np
import torch

from . import model as rm
from . import tracker as rt
from .annos import assemble_frame, finalize


def plain_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev)


class Trunk:
    """The trunk's weights and geometry; `bev(frame)` -> (H, W, 64)."""

    def __init__(self, sd: dict, model_cfg: dict, device):
        self.sd, self.cfg, self.dev = sd, model_cfg, device
        self.sets: list = []  # per frame: the size of each stage's active set

    def bev(self, frame: dict) -> torch.Tensor:
        d = self.dev
        dense, sizes = rm.sparse_trunk(
            self.sd, _t(frame["voxels"], d), _t(frame["num_points"], d),
            _t(frame["coordinates"], d), _t(frame["voxels_valid"], d),
            self.cfg["grid_shape"], self.cfg["num_input_features"])
        self.sets.append(sizes)
        return rm.neck(self.sd, dense)[0]

    def features(self, bev: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return rm.sample(bev, rm.box_points_5(boxes[:, :7]), c["pc_start"], c["voxel_size"],
                         c["out_stride"])


class ClassTracker:
    """One class's carry: previous descriptors and boxes, their count, the
    track table of 2N(max_age + 1) slots."""

    def __init__(self, head: dict, n: int, cls_name: str, F: int, params, thresholds, device):
        self.head, self.N, self.params = head, n, params
        self.cls_id = rt.NAMES.index(cls_name)
        self.fp, self.dthresh = thresholds
        self.prev_feat = torch.zeros((n, F), device=device)
        self.prev_boxes = torch.zeros((n, 11), device=device)
        self.n_prev = 0
        self.table = rt.TrackTable.empty(2 * n * (params.max_age + 1), device)

    def step(self, feat, boxes, n_curr: int, lag: float, id_count: int):
        """One frame; new ids count on from id_count. Returns ((6, 2N)
        [tid, used, ref, keep, fn, 1] rows, the number of new tracks)."""
        N, dev = self.N, feat.device
        m1, m2 = rm.affinity(self.head, self.prev_boxes[:, :7], boxes[:, :7], boxes[:, 7:9],
                             boxes[:, 9:10], self.prev_feat, feat)
        dec = rt.apply_decision_rules(m1, m2, self.n_prev, n_curr, self.fp, self.dthresh)
        dead_pad = torch.zeros_like(self.table.dead)
        dead_pad[:N] = dec.dead
        table = self.table._replace(dead=self.table.dead | (dead_pad & self.table.used))
        dets = rt.dets_with_fn(boxes, self.prev_boxes, dec, self.cls_id)
        table, n_new, tid, used, ref, _ = rt.step_frames_core(
            rt.TrackTable(*(x[None] for x in table)),
            torch.tensor([id_count], dtype=torch.int32, device=dev),
            rt.FrameDets(*(x[None] for x in dets)),
            torch.tensor([lag], dtype=torch.float32, device=dev), self.params)
        self.table = rt.TrackTable(*(x[0] for x in table))
        self.prev_feat, self.prev_boxes, self.n_prev = feat, boxes, n_curr
        pad = torch.zeros(N, device=dev)
        rows = torch.stack([tid[0].float(), used[0].float(), ref[0],
                            torch.cat([dec.keep.float(), pad]), torch.cat([dec.fn.float(), pad]),
                            torch.ones(2 * N, device=dev)])
        return rows, int(n_new[0])


def stream(trunk: Trunk, heads: dict, max_obj: dict, frames: list, thresholds,
           max_age: int) -> list[dict]:
    """One scene through a fresh carry: for each frame, {class: (6, 2N_c)
    host rows}. frames: the generator's frames (voxel arrays, `boxes`,
    `lag`); every class of `heads` steps every frame, in NAMES order, with
    its new ids numbered on from the classes before it."""
    dev = trunk.dev
    F = trunk.cfg["num_point"] * trunk.cfg["share_conv_channel"]
    params = rt.tracker_params(max_age, dev)
    names = [n for n in rt.NAMES if n in heads]
    trackers = {n: ClassTracker(heads[n], max_obj[n], n, F, params, thresholds, dev)
                for n in names}
    id_count, out = 0, []
    for frame in frames:
        bev = trunk.bev(frame)
        lag = frame_lag(frame, names)
        rows = {}
        for n in names:
            boxes, n_curr = class_boxes(frame, n, max_obj[n])
            b = _t(boxes, dev)
            rows[n], n_new = trackers[n].step(trunk.features(bev, b), b, n_curr, lag, id_count)
            id_count += n_new
        out.append({n: r.cpu().numpy() for n, r in rows.items()})
    return out


def class_boxes(frame: dict, name: str, n: int) -> tuple[np.ndarray, int]:
    """(N, 11) det rows of a class, zero-padded, and their count."""
    b = frame["boxes"].get(name, np.zeros((0, 11), np.float32))
    out = np.zeros((n, 11), np.float32)
    out[:len(b)] = b
    return out, len(b)


def frame_lag(frame: dict, names) -> float:
    """The lag a step takes: the detections' dt, 0.5 when no class has one."""
    return float(frame["lag"]) if any(len(frame["boxes"].get(n, ())) for n in names) else 0.5


def eval_scene(trunk: Trunk, head: dict, n: int, samples: list, thresholds) -> dict:
    """One scene's pair decisions and annotations: each frame's
    descriptors scored against its previous frame's carried ones (zeros at
    the scene's start). samples: SplitReader frames. Returns {token: annos}."""
    dev = trunk.dev
    F = trunk.cfg["num_point"] * trunk.cfg["share_conv_channel"]
    prev_feat, prev_boxes, n_prev = torch.zeros((n, F), device=dev), torch.zeros(
        (n, 11), device=dev), 0
    results, dead = {}, {}
    for s in samples:
        b = _t(s["det_boxes"], dev)
        feat = trunk.features(trunk.bev(s), b)
        n_curr = len(s["cls_det_boxes"])
        m1, m2 = rm.affinity(head, prev_boxes[:, :7], b[:, :7], b[:, 7:9], b[:, 9:10],
                             prev_feat, feat)
        d = rt.apply_decision_rules(m1, m2, n_prev, n_curr, *thresholds)
        dec = {"dead": d.dead.cpu().numpy(), "fn": d.fn.cpu().numpy(),
               "fn_ref": d.fn_ref_score.cpu().numpy(), "keep": d.keep.cpu().numpy(),
               "newborn": d.newborn.cpu().numpy(), "ref": d.ref_score.cpu().numpy()}
        assemble_frame(s, dec, results, dead)
        prev_feat, prev_boxes, n_prev = feat, b, n_curr
    return finalize(results, dead)
