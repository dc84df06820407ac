"""Waymo tracking support (artifact-level); the port of
shasta_tpu/data/waymo.py.

Behavioral reference: det3d/datasets/waymo/waymo.py:19 (WaymoDataset) and
preprocessing/waymo_data/*.py (per-scene npz extraction: dets, ego, gt,
point clouds, timestamps). The classical-MOT and gt-association paths run
on the extracted npz tree (mot.MOTModel, its geometry on the model's
device), and the raw extraction is implemented: TFRecord framing
(data/tfrecord.py) and the Frame/Objects protos (data/waymo_protos.py) are
read by the port's own code. Where the JAX module prefers the optional
waymo-open-dataset parser when it is installed, the port always parses with
its own codec, so its artifacts do not depend on the installation.

Artifact contract per scene (matching the reference's extraction):
  detections/{name}/dets/{segment}.npz      bboxes/types[/velos] per frame
  ego_info/{segment}.npz                    4x4 ego poses per frame
  gt_info/{segment}.npz                     bboxes/ids/types per frame
  ts_info/{segment}.json                    frame timestamps
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

WAYMO_CLASSES = ("vehicle", "pedestrian", "cyclist")


@dataclass
class WaymoScene:
    segment: str
    dets: list[np.ndarray]  # per frame (N, 8) mot arrays
    det_types: list[list[str]]
    gts: list[np.ndarray]
    gt_types: list[list[str]]
    gt_ids: list[list]
    ego: list[np.ndarray]  # per frame 4x4
    timestamps: list[float]


def load_waymo_scene(data_dir: str, segment: str, det_name: str = "cp") -> WaymoScene:
    det = np.load(
        os.path.join(data_dir, "detections", det_name, "dets", segment + ".npz"),
        allow_pickle=True,
    )
    gt = np.load(os.path.join(data_dir, "gt_info", segment + ".npz"), allow_pickle=True)
    ego = np.load(os.path.join(data_dir, "ego_info", segment + ".npz"), allow_pickle=True)
    with open(os.path.join(data_dir, "ts_info", segment + ".json")) as f:
        timestamps = json.load(f)

    def rows(arr):
        return [np.asarray(a, np.float64).reshape(-1, 8) if len(a) else np.zeros((0, 8))
                for a in arr]

    n = len(det["bboxes"])
    return WaymoScene(
        segment=segment,
        dets=rows(det["bboxes"]),
        det_types=[list(t) for t in det["types"]],
        gts=rows(gt["bboxes"]),
        gt_types=[list(t) for t in gt["types"]],
        gt_ids=[list(i) for i in gt["ids"]],
        ego=[np.asarray(ego[str(i)]).reshape(4, 4) for i in range(n)],
        timestamps=list(timestamps)[:n],
    )


def waymo_scene_to_mot_frames(scene: WaymoScene):
    """FrameData stream for mot.MOTModel over one segment."""
    from ..mot.mot_model import FrameData

    for i in range(len(scene.dets)):
        yield FrameData(
            dets=scene.dets[i],
            det_types=scene.det_types[i],
            gt_dets=scene.gts[i],
            gt_types=scene.gt_types[i],
            gt_ids=scene.gt_ids[i],
            ego=scene.ego[i],
            time_stamp=scene.timestamps[i],
        )


# Waymo label-type ints (dataset.proto Label.Type) -> tracking names
WAYMO_TYPE_NAMES = {1: "vehicle", 2: "pedestrian", 3: "sign", 4: "cyclist"}


def write_objects_bin(segments: dict, out_path: str) -> int:
    """Tracking/detection results -> metrics_pb2.Objects .bin for the
    official Waymo evaluator (det3d/datasets/waymo/waymo_common.py:52-116).

    segments: {segment_name: {"timestamps": [us...], "frames": [[{
        "bbox": mot row [x,y,z,heading,l,w,h,score], "type": int,
        "id": str (optional, tracking)}]]}}.
    Returns the object count. Wire bytes come from the in-repo codec
    (data/waymo_protos.py, protoc-cross-validated) so no waymo-open-dataset
    install is needed; the output parses in the official evaluator.
    """
    from .waymo_protos import encode_objects

    rows = []
    n = 0
    for seg, data in segments.items():
        ts = data["timestamps"]
        for fi, frame in enumerate(data["frames"]):
            for d in frame:
                b = d["bbox"]
                label = {
                    "box": {
                        "center_x": float(b[0]),
                        "center_y": float(b[1]),
                        "center_z": float(b[2]),
                        "heading": float(b[3]),
                        "length": float(b[4]),
                        "width": float(b[5]),
                        "height": float(b[6]),
                    },
                    "type": int(d["type"]),
                }
                if d.get("id") is not None:
                    label["id"] = str(d["id"])
                rows.append({
                    "object": label,
                    "score": float(b[7]),
                    "context_name": seg,
                    "frame_timestamp_micros": int(ts[fi]),
                })
                n += 1
    with open(out_path, "wb") as f:
        f.write(encode_objects(rows))
    return n


def eval_waymo_tracking(
    data_dir: str,
    results: dict,
    types=(1, 2, 4),
    dist_threshold: float = 2.0,
    det_name: str = "cp",
) -> dict:
    """Devkit-free CLEAR-MOT over the extracted Waymo npz tree.

    The reference defers Waymo scoring to the official compute_tracking
    binary (waymo_common.py); this local evaluator scores directly against
    gt_info npz so development loops need no Waymo tooling.
    results: {segment: [[{"id", "bbox" mot row, "type" int}] per frame]}.
    """
    from ..mot.metrics import MOTAccumulator

    out: dict = {}
    for typ in types:
        acc = MOTAccumulator(dist_threshold=dist_threshold)
        for seg, frames in results.items():
            gt = np.load(
                os.path.join(data_dir, "gt_info", seg + ".npz"), allow_pickle=True
            )
            for fi, hyps in enumerate(frames):
                g_ids = [
                    i for i, t in zip(gt["ids"][fi], gt["types"][fi]) if int(t) == typ
                ]
                g_ct = np.asarray([
                    b[:2] for b, t in zip(gt["bboxes"][fi], gt["types"][fi])
                    if int(t) == typ
                ], np.float64).reshape(-1, 2)
                h_ids = [h["id"] for h in hyps if int(h["type"]) == typ]
                h_ct = np.asarray([
                    h["bbox"][:2] for h in hyps if int(h["type"]) == typ
                ], np.float64).reshape(-1, 2)
                acc.update(g_ids, g_ct, h_ids, h_ct)
        out[WAYMO_TYPE_NAMES.get(typ, str(typ))] = acc.summary()
    return out


def _segment_name(path: str) -> str:
    return os.path.basename(path).split(".")[0]


def extract_waymo_segment(tfrecord_path: str, out_dir: str,
                          with_gt: bool = True) -> str:
    """TFRecord -> per-segment npz/json artifacts.

    Equivalent of preprocessing/waymo_data/testset/{time_stamp,ego_info}.py
    plus in-record GT labels (the gt.bin path is decode_objects_bin):
      ts_info/{segment}.json    frame.timestamp_micros list
      ego_info/{segment}.npz    {str(i): 4x4 frame.pose.transform}
      gt_info/{segment}.npz     bboxes (mot rows [x,y,z,o,l,w,h,s]) /
                                types (Label.Type ints) / ids, per frame

    Both the record framing (data.tfrecord) and the Frame proto subset
    (data.waymo_protos) are read by the port's own code.
    Returns the segment name.
    """
    from .tfrecord import read_tfrecord
    from .waymo_protos import parse_frame

    segment = _segment_name(tfrecord_path)
    timestamps: list[int] = []
    ego: dict[str, np.ndarray] = {}
    gt_boxes, gt_types, gt_ids = [], [], []
    for i, payload in enumerate(read_tfrecord(tfrecord_path)):
        frame = parse_frame(payload)
        timestamps.append(int(frame.timestamp_micros))
        ego[str(i)] = np.asarray(list(frame.pose.transform), np.float64).reshape(4, 4)
        fb, ft, fi = [], [], []
        if with_gt:
            for label in frame.laser_labels:
                b = label.box
                # mot layout [x, y, z, heading, l, w, h, score]
                fb.append([
                    b.center_x, b.center_y, b.center_z, b.heading,
                    b.length, b.width, b.height, 1.0,
                ])
                ft.append(int(label.type))
                fi.append(str(label.id))
        gt_boxes.append(fb)
        gt_types.append(ft)
        gt_ids.append(fi)

    os.makedirs(os.path.join(out_dir, "ts_info"), exist_ok=True)
    with open(os.path.join(out_dir, "ts_info", segment + ".json"), "w") as f:
        json.dump(timestamps, f)
    os.makedirs(os.path.join(out_dir, "ego_info"), exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "ego_info", segment + ".npz"), **ego)
    if with_gt:
        os.makedirs(os.path.join(out_dir, "gt_info"), exist_ok=True)
        np.savez_compressed(
            os.path.join(out_dir, "gt_info", segment + ".npz"),
            bboxes=np.asarray(gt_boxes, dtype=object),
            types=np.asarray(gt_types, dtype=object),
            ids=np.asarray(gt_ids, dtype=object),
        )
    return segment


def decode_objects_bin(bin_path: str, data_dir: str, out_subdir: str,
                       with_velocity: bool = False) -> list[str]:
    """metrics_pb2.Objects .bin -> per-segment npz, aligned to ts_info.

    Covers both the GT decode (gt_bin_decode.py:30-120 -> gt_info layout)
    and the detection decode (waymo_data/detection.py:55-189 -> dets layout
    incl. velos from object.metadata when with_velocity). Segments and
    frame indices come from the previously extracted ts_info jsons.
    Parses via the in-repo codec (data/waymo_protos.py) — no
    waymo-open-dataset install required.
    """
    from .waymo_protos import parse_objects

    ts_dir = os.path.join(data_dir, "ts_info")
    ts_info = {}
    for fn in sorted(os.listdir(ts_dir)):
        with open(os.path.join(ts_dir, fn)) as f:
            ts_info[fn.split(".")[0]] = json.load(f)

    with open(bin_path, "rb") as f:
        objects = parse_objects(f.read())

    acc = {
        seg: {"bboxes": {}, "types": {}, "ids": {}, "velos": {}}
        for seg in ts_info
    }
    for inst in objects.objects:
        seg = next((s for s in ts_info if inst.context_name in s), None)
        if seg is None:
            continue
        try:
            fi = ts_info[seg].index(inst.frame_timestamp_micros)
        except ValueError:
            continue
        a = acc[seg]
        key = str(fi)
        b = inst.object.box
        a["bboxes"].setdefault(key, []).append([
            b.center_x, b.center_y, b.center_z, b.heading,
            b.length, b.width, b.height, float(inst.score),
        ])
        a["types"].setdefault(key, []).append(int(inst.object.type))
        a["ids"].setdefault(key, []).append(str(inst.object.id))
        if with_velocity:
            md = inst.object.metadata
            a["velos"].setdefault(key, []).append([md.speed_x, md.speed_y])

    out_dir = os.path.join(data_dir, out_subdir)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for seg, a in acc.items():
        n = len(ts_info[seg])
        result = {
            "bboxes": np.asarray([a["bboxes"].get(str(i), []) for i in range(n)], dtype=object),
            "types": np.asarray([a["types"].get(str(i), []) for i in range(n)], dtype=object),
            "ids": np.asarray([a["ids"].get(str(i), []) for i in range(n)], dtype=object),
        }
        if with_velocity:
            result["velos"] = np.asarray(
                [a["velos"].get(str(i), []) for i in range(n)], dtype=object
            )
        np.savez_compressed(os.path.join(out_dir, seg + ".npz"), **result)
        written.append(seg)
    return written
