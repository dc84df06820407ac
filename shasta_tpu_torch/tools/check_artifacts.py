"""Sanity-check a preprocessed artifact tree: the port of tools/check_artifacts.py.

Behavioral reference: preprocessing/nuscenes_data/check_gt_info.py (GT
artifact inspection) + the commented token-order sanity check in
eval.py:248-250. Verifies per-scene/file consistency: token ordering vs
frame_info, det/gt frame counts, gt_shasta matrix shapes vs det counts,
sensor-frame det json row widths. Exits with 1 when it finds a problem.

    python -m shasta_tpu_torch.tools.check_artifacts --data data/nusc_preprocessed --split val
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    """Prints each problem and the count; returns the count (the exit code
    of `python -m` is 1 when it is not 0)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--det_name", default="cp")
    args = ap.parse_args(argv)

    split_dir = os.path.join(args.data, f"{args.split}_2hz")
    problems = 0

    with open(os.path.join(args.data, f"{args.split}_frame_info.json")) as f:
        frame_info = json.load(f)

    token_dir = os.path.join(split_dir, "token_info")
    for fn in sorted(os.listdir(token_dir)):
        scene = fn[:-5]
        with open(os.path.join(token_dir, fn)) as f:
            tokens = json.load(f)
        # token chain consistency
        for i, tok in enumerate(tokens):
            fi = frame_info.get(tok)
            if fi is None:
                print(f"[{scene}] token {tok} missing from frame_info")
                problems += 1
                continue
            want_prev = tokens[i - 1] if i > 0 else ""
            if fi["prev"] != want_prev:
                print(f"[{scene}] frame {i}: prev mismatch {fi['prev']} != {want_prev}")
                problems += 1
        # det npz frame counts
        det_path = os.path.join(split_dir, "detections", args.det_name, "dets", scene + ".npz")
        if os.path.exists(det_path):
            d = np.load(det_path, allow_pickle=True)
            if len(d["bboxes"]) != len(tokens):
                print(f"[{scene}] det npz frames {len(d['bboxes'])} != tokens {len(tokens)}")
                problems += 1
        # gt_shasta shapes
        gs_dir = os.path.join(split_dir, "gt_shasta", args.det_name, "individual_frames")
        if os.path.isdir(gs_dir) and os.path.exists(det_path):
            d = np.load(det_path, allow_pickle=True)
            for i, tok in enumerate(tokens):
                p = os.path.join(gs_dir, tok + ".npz")
                if not os.path.exists(p):
                    continue
                lbl = np.load(p, allow_pickle=True)
                K = len(d["bboxes"][i])
                if len(lbl["newborn"]) != K:
                    print(f"[{scene}] {tok}: newborn len {len(lbl['newborn'])} != dets {K}")
                    problems += 1
                m = lbl["matched"]
                if m.ndim == 2 and i > 0:
                    N = len(d["bboxes"][i - 1])
                    if m.shape != (N, K + 2):
                        print(f"[{scene}] {tok}: matched {m.shape} != ({N}, {K + 2})")
                        problems += 1
        # sensor det row widths
        sd_dir = os.path.join(split_dir, "detections", args.det_name, "sensor_individual_frames")
        if os.path.isdir(sd_dir) and tokens:
            p = os.path.join(sd_dir, tokens[0] + ".json")
            if os.path.exists(p):
                with open(p) as f:
                    rows = json.load(f)
                for r in rows[:3]:
                    if len(r) != 13:
                        print(f"[{scene}] sensor det row width {len(r)} != 13")
                        problems += 1

    print(f"check complete: {problems} problem(s)")
    return problems


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
