"""The eval's annotations from each frame's decisions: a frozen copy of
shasta_tpu_torch/tracker/runner.py's `_assemble_frame_annos` and
`_finalize_annos` (FN propagation, FP survivors, newborn flags, the
retroactive dead marks)."""
from __future__ import annotations


def assemble_frame(sample: dict, dec: dict, results: dict, dead_tracker: dict) -> None:
    token = sample["token"]
    dead_tracker.setdefault(token, {"dead_idx": [], "keep_idx": []})
    cls_det_boxes, prev_cls = sample["cls_det_boxes"], sample["prev_cls_det_boxes"]
    annos, fn_annos = [], []
    if prev_cls:
        prev_token = sample["prev_token"]
        dead_tracker.setdefault(prev_token, {"dead_idx": [], "keep_idx": []})
        time_lag = float(sample["prev_det_boxes"][0, 9])
        for n in range(len(prev_cls)):
            if dec["dead"][n]:
                dead_tracker[prev_token]["dead_idx"].append(n)
            elif dec["fn"][n]:
                a = dict(prev_cls[n])
                a["translation"] = list(a["translation"])
                a["translation"][:2] = [t + time_lag * v
                                        for t, v in zip(a["translation"][:2], a["velocity"])]
                a["FN"] = True
                a["token"] = token
                a["ref_detection_score"] = float(dec["fn_ref"][n])
                fn_annos.append(a)
    keep_idx = []
    for k in range(len(cls_det_boxes)):
        if not dec["keep"][k]:
            continue
        a = dict(cls_det_boxes[k])
        if dec["newborn"][k]:
            a["newborn"] = True
        a["ref_detection_score"] = float(dec["ref"][k])
        keep_idx.append(k)
        annos.append(a)
    dead_tracker[token]["keep_idx"] = keep_idx
    results[token] = annos + fn_annos


def finalize(results: dict, dead_tracker: dict) -> dict:
    for token, annos in results.items():
        keep_idx = dead_tracker[token]["keep_idx"]
        for i in dead_tracker[token]["dead_idx"]:
            if i in keep_idx:
                annos[keep_idx.index(i)]["dead"] = True
    return results
