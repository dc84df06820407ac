"""Waymo raw-data extraction, TFRecords + Objects bins -> MOT npz tree: the
port of tools/extract_waymo.py.

    python -m shasta_tpu_torch.tools.extract_waymo --data_folder waymo/validation \\
        --output_folder waymo/mot [--gt_bin gt.bin] \\
        [--det_bin dets.bin --det_name cp] [--no_frame_gt] \\
        [--raw_pc] [--ground_removal]   # testset chain (raw_pc.py + GPF)

Per segment it writes ts_info/, ego_info/, gt_info/ and
detections/{name}/dets/ (the reference's preprocessing/waymo_data drivers:
testset/{time_stamp,ego_info}.py, gt_bin_decode.py, detection.py), and with
--raw_pc and --ground_removal pc/{raw_pc,clean_pc,ground_pc}/. The TFRecord
framing and the Frame/Objects protos are read by the port's own code
(data.tfrecord, data.waymo_protos); numpy on the host, no card.
"""
from __future__ import annotations

import argparse
import os

from ..data.waymo import decode_objects_bin, extract_waymo_segment
from ..data.waymo_decode import extract_raw_pc
from ..preprocessing.waymo_ground import remove_ground_tree


def main(argv=None) -> list[str]:
    """Runs the extraction; returns the segment names, in record order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_folder", required=True, help="dir of .tfrecord files")
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--gt_bin", default=None, help="GT Objects .bin (gt_bin_decode)")
    ap.add_argument("--det_bin", default=None, help="detection Objects .bin")
    ap.add_argument("--det_name", default="cp")
    ap.add_argument("--no_frame_gt", action="store_true",
                    help="skip in-record laser_labels GT (use --gt_bin instead)")
    ap.add_argument("--raw_pc", action="store_true",
                    help="decode range images -> pc/raw_pc/{seg}.npz "
                         "(testset/raw_pc.py chain)")
    ap.add_argument("--ground_removal", action="store_true",
                    help="GPF split of pc/raw_pc -> pc/{clean_pc,ground_pc}")
    args = ap.parse_args(argv)

    records = sorted(f for f in os.listdir(args.data_folder) if "tfrecord" in f)
    segments = []
    for i, rec in enumerate(records):
        seg = extract_waymo_segment(
            os.path.join(args.data_folder, rec), args.output_folder,
            with_gt=not (args.no_frame_gt or args.gt_bin),
        )
        segments.append(seg)
        print(f"[{i + 1}/{len(records)}] extracted {seg}")

    if args.gt_bin:
        segs = decode_objects_bin(args.gt_bin, args.output_folder, "gt_info")
        print(f"decoded GT bin -> gt_info/ ({len(segs)} segments)")
    if args.det_bin:
        segs = decode_objects_bin(
            args.det_bin, args.output_folder,
            os.path.join("detections", args.det_name, "dets"),
            with_velocity=True,
        )
        print(f"decoded detection bin -> detections/{args.det_name}/dets/ "
              f"({len(segs)} segments)")

    if args.raw_pc:
        raw_dir = os.path.join(args.output_folder, "pc", "raw_pc")
        for i, rec in enumerate(records):
            seg = extract_raw_pc(os.path.join(args.data_folder, rec), raw_dir)
            print(f"[{i + 1}/{len(records)}] raw pc {seg}")
    if args.ground_removal:
        pc = os.path.join(args.output_folder, "pc")
        done = remove_ground_tree(
            os.path.join(pc, "raw_pc"), os.path.join(pc, "clean_pc"),
            os.path.join(pc, "ground_pc"),
        )
        print(f"ground removal over {len(done)} segments")
    return segments


if __name__ == "__main__":
    main()
