"""Tracker constants: a copy of those in shasta_tpu/tracker/pub_tracker.py."""

NUSCENES_TRACKING_NAMES = [
    "bicycle",
    "bus",
    "car",
    "motorcycle",
    "pedestrian",
    "trailer",
    "truck",
]

# 99.9-percentile L2 velocity-error gates per class (pub_tracker.py:23-31).
NUSCENE_CLS_VELOCITY_ERROR = {
    "car": 2,
    "truck": 2,
    "bus": 4,
    "trailer": 2,
    "pedestrian": 0.75,
    "motorcycle": 2,
    "bicycle": 1.5,
}

# Per-class confidence-refinement table (pub_tracker_merged.py:34-42).
TRK_REF = {
    "bicycle": {"alpha": 0.5, "beta": 0.4, "ref": True},
    "bus": {"alpha": 0.5, "beta": 0.7, "ref": True},
    "car": {"alpha": 0.5, "beta": 0.5, "ref": True},
    "motorcycle": {"alpha": 0.5, "beta": 0.5, "ref": True},
    "pedestrian": {"alpha": 0.5, "beta": 0.5, "ref": True},
    "trailer": {"alpha": 0.5, "beta": 0.4, "ref": True},
    "truck": {"alpha": 0.5, "beta": 0.5, "ref": True},
}
