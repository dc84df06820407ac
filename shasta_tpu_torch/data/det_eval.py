"""Detection evaluation: nuScenes-protocol center-distance mAP, self-contained;
the port of shasta_tpu/data/det_eval.py (numpy, on the host).

Behavioral reference: det3d/datasets/nuscenes/nuscenes.py:416-555 +
nusc_common.py:610-622 wrap the devkit's detection eval. The devkit is
optional here; this module implements the same protocol core (AP averaged
over center-distance thresholds 0.5/1/2/4 m, 101-point interpolated
precision over recall in [0.1, 1], per class) for closed-loop development.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
MIN_RECALL = 0.1
MIN_PRECISION = 0.1


def _ap_single(gt_by_frame, det_list, dist_th):
    """det_list: [(frame, center (2,), score)] sorted desc by score.
    gt_by_frame: {frame: [centers]}. Returns interpolated AP."""
    npos = sum(len(v) for v in gt_by_frame.values())
    if npos == 0:
        return np.nan
    taken = defaultdict(set)
    tps, fps = [], []
    for frame, c, s in det_list:
        gts = gt_by_frame.get(frame, [])
        best, best_d = None, np.inf
        for gi, g in enumerate(gts):
            if gi in taken[frame]:
                continue
            d = np.hypot(c[0] - g[0], c[1] - g[1])
            if d < best_d:
                best_d, best = d, gi
        if best is not None and best_d < dist_th:
            taken[frame].add(best)
            tps.append(1)
            fps.append(0)
        else:
            tps.append(0)
            fps.append(1)
    tp = np.cumsum(tps)
    fp = np.cumsum(fps)
    recall = tp / npos
    precision = tp / np.maximum(tp + fp, 1)

    # 101-point interpolation, clipped at min recall/precision (devkit)
    r_grid = np.linspace(0, 1, 101)
    p_interp = np.interp(r_grid, recall, precision, right=0)
    mask = r_grid >= MIN_RECALL
    p = np.maximum(p_interp[mask] - MIN_PRECISION, 0) / (1 - MIN_PRECISION)
    return float(np.mean(p))


def evaluate_detection(
    gt: dict[str, list[dict]],
    results: dict[str, list[dict]],
    classes: list[str],
) -> dict:
    """gt/results: {token: [{translation, detection_name, (detection_score)}]}.
    Returns {class: {dist@th: ap}, 'mean_ap': float}."""
    out: dict = {}
    all_aps = []
    for cls in classes:
        gt_by_frame = {
            tok: [np.asarray(g["translation"][:2]) for g in annos
                  if g["detection_name"] == cls]
            for tok, annos in gt.items()
        }
        dets = []
        for tok, annos in results.items():
            for a in annos:
                if a["detection_name"] == cls:
                    dets.append(
                        (tok, np.asarray(a["translation"][:2]),
                         float(a.get("detection_score", 0.5)))
                    )
        dets.sort(key=lambda x: -x[2])
        cls_aps = {}
        for th in DIST_THRESHOLDS:
            ap = _ap_single(gt_by_frame, dets, th)
            cls_aps[f"dist@{th}"] = ap
            if not np.isnan(ap):
                all_aps.append(ap)
        out[cls] = cls_aps
    out["mean_ap"] = float(np.nanmean(all_aps)) if all_aps else 0.0
    return out


def evaluate_detection_official(res_path, version, eval_set, output_dir, dataroot):
    """Devkit wrapper (nusc_common.py eval_main), optional dependency."""
    try:
        from nuscenes import NuScenes
        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import NuScenesEval
    except ImportError:
        print("nuscenes devkit not available; use evaluate_detection instead")
        return None
    nusc = NuScenes(version=version, dataroot=dataroot, verbose=False)
    cfg = config_factory("detection_cvpr_2019")
    ev = NuScenesEval(
        nusc, config=cfg, result_path=res_path, eval_set=eval_set,
        output_dir=output_dir, verbose=True,
    )
    return ev.main(plot_examples=0)
