"""Minimal nuScenes raw-table reader (replaces the nuscenes-devkit): the
port of shasta_tpu/preprocessing/nusc_db.py.

The reference preprocessing imports `nuscenes.NuScenes` for table access
(token_info.py, ego_pose.py, gt_info.py, ...). The devkit is a heavy
dependency; everything those scripts need is plain JSON-table joins, so we
read the v1.0-* tables directly:

  scene.json, sample.json, sample_data.json, ego_pose.json,
  calibrated_sensor.json, sample_annotation.json, instance.json,
  category.json, attribute.json

API shape mirrors the devkit's `get(table, token)` so the CLIs read like
their reference counterparts behaviorally while being dependency-free.
"""
from __future__ import annotations

import json
import os
from functools import cached_property

import numpy as np

from ..core.transforms import quat_slerp


TABLES = (
    "scene",
    "sample",
    "sample_data",
    "ego_pose",
    "calibrated_sensor",
    "sample_annotation",
    "instance",
    "category",
    "attribute",
)


class NuscDB:
    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        self._tables: dict[str, list[dict]] = {}
        self._index: dict[str, dict[str, dict]] = {}
        self._lidar_key: dict[str, dict] | None = None
        self._anns_of: dict[str, list[dict]] | None = None

    def table(self, name: str) -> list[dict]:
        if name not in self._tables:
            path = os.path.join(self.dataroot, self.version, name + ".json")
            with open(path) as f:
                self._tables[name] = json.load(f)
        return self._tables[name]

    def get(self, name: str, token: str) -> dict:
        if name not in self._index:
            self._index[name] = {r["token"]: r for r in self.table(name)}
        return self._index[name][token]

    @cached_property
    def scene(self):
        return self.table("scene")

    @cached_property
    def sample(self):
        return self.table("sample")

    def scene_samples(self, scene_record: dict) -> list[dict]:
        """Ordered samples of a scene via the prev/next chain."""
        out = []
        token = scene_record["first_sample_token"]
        while token:
            s = self.get("sample", token)
            out.append(s)
            token = s["next"]
        return out

    def sample_lidar_data(self, sample: dict) -> dict:
        """The LIDAR_TOP sample_data record for a (key-frame) sample."""
        if "data" in sample and "LIDAR_TOP" in sample.get("data", {}):
            return self.get("sample_data", sample["data"]["LIDAR_TOP"])
        # raw tables have no 'data' map: the first key LIDAR_TOP record of
        # the sample in table order, from an index built on first use
        if self._lidar_key is None:
            self._lidar_key = {}
            for sd in self.table("sample_data"):
                if sd.get("is_key_frame") and "LIDAR_TOP" in sd.get("filename", ""):
                    self._lidar_key.setdefault(sd["sample_token"], sd)
        if sample["token"] not in self._lidar_key:
            raise KeyError(f"no LIDAR_TOP sample_data for {sample['token']}")
        return self._lidar_key[sample["token"]]

    def lidar_sd_chain(self, scene_record: dict) -> list[dict]:
        """Full 20 Hz LIDAR_TOP sample_data chain of a scene (key + sweep
        frames), walked via prev/next from the first key frame."""
        first = self.get("sample", scene_record["first_sample_token"])
        sd = self.sample_lidar_data(first)
        out = []
        while True:
            out.append(sd)
            nxt = sd.get("next", "")
            if not nxt:
                return out
            sd = self.get("sample_data", nxt)

    def boxes_at_sample_data(self, sd: dict) -> list[dict]:
        """Annotation boxes at a sample_data frame; non-key frames get
        boxes interpolated between the surrounding key frames (linear
        center/size, slerp rotation) — the devkit get_boxes() behavior the
        reference's 20 Hz gt_info relies on. Ids are instance tokens so
        identity linking works across interpolated frames."""
        def anns_of(sample_token):
            return {
                a["instance_token"]: a
                for a in self.annotations_for_sample(sample_token)
            }

        if sd.get("is_key_frame"):
            return [
                {
                    "instance_token": a["instance_token"],
                    "category_name": self.category_name(a["instance_token"]),
                    "translation": list(a["translation"]),
                    "size": list(a["size"]),
                    "rotation": list(a["rotation"]),
                    "ann_token": a["token"],
                }
                for a in self.annotations_for_sample(sd["sample_token"])
            ]

        # neighbouring key frames along the sd chain
        prev_sd, next_sd = sd, sd
        while prev_sd and not prev_sd.get("is_key_frame"):
            tok = prev_sd.get("prev", "")
            prev_sd = self.get("sample_data", tok) if tok else None
        while next_sd and not next_sd.get("is_key_frame"):
            tok = next_sd.get("next", "")
            next_sd = self.get("sample_data", tok) if tok else None
        if prev_sd is None and next_sd is None:
            return []
        if prev_sd is None or next_sd is None:
            return self.boxes_at_sample_data(prev_sd or next_sd)

        t0, t1, t = prev_sd["timestamp"], next_sd["timestamp"], sd["timestamp"]
        frac = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        prev_anns = anns_of(prev_sd["sample_token"])
        next_anns = anns_of(next_sd["sample_token"])
        out = []
        for inst in sorted(set(prev_anns) | set(next_anns)):
            a0, a1 = prev_anns.get(inst), next_anns.get(inst)
            if a0 is not None and a1 is not None:
                tr = (1 - frac) * np.asarray(a0["translation"]) + frac * np.asarray(a1["translation"])
                sz = (1 - frac) * np.asarray(a0["size"]) + frac * np.asarray(a1["size"])
                rot = quat_slerp(a0["rotation"], a1["rotation"], frac)
                src = a1  # token of the upcoming key frame (devkit choice)
            else:
                src = a0 or a1
                tr = np.asarray(src["translation"])
                sz = np.asarray(src["size"])
                rot = np.asarray(src["rotation"], np.float64)
            out.append({
                "instance_token": inst,
                "category_name": self.category_name(inst),
                "translation": [float(v) for v in tr],
                "size": [float(v) for v in sz],
                "rotation": [float(v) for v in rot],
                "ann_token": src["token"],
            })
        return out

    def annotations_for_sample(self, sample_token: str) -> list[dict]:
        """The sample's annotations in table order (an index built on first
        use; the JAX reader scans the table on every call)."""
        if self._anns_of is None:
            self._anns_of = {}
            for a in self.table("sample_annotation"):
                self._anns_of.setdefault(a["sample_token"], []).append(a)
        return list(self._anns_of.get(sample_token, ()))

    def category_name(self, instance_token: str) -> str:
        inst = self.get("instance", instance_token)
        return self.get("category", inst["category_token"])["name"]
