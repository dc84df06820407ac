"""Populate the component registries for config-driven construction: the
port of shasta_tpu/registry_setup.py.

The reference builds everything through registries + build_from_cfg
(det3d/utils/registry.py, det3d/models/builder.py build_simp_track). Here
construction is usually explicit; calling :func:`register_all` once makes
`build_from_cfg(dict(type="ShastaModel", ...), MODELS)` style configs
work. The model factories take an optional `device` (default: the card,
as every entry point).
"""
from __future__ import annotations

from .utils.registry import DATASETS, MODELS, TRACKERS


def register_all():
    from .data.loader import ConcatDataset, RepeatDataset
    from .data.nuscenes import NuScenesTrackDataset
    from .models import BEVMap, ShastaConfig, ShastaModel
    from .mot.mot_model import MOTModel
    from .tracker.pub_tracker import PubTracker, PubTrackerMerged

    if "NuScenesTrackDataset" not in DATASETS:
        DATASETS.register_module(NuScenesTrackDataset)
        DATASETS.register_module(ConcatDataset)
        DATASETS.register_module(RepeatDataset)

    def _config(kwargs) -> ShastaConfig:
        return ShastaConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in kwargs.items()})

    def _shasta_from_cfg(device=None, **kwargs):
        return ShastaModel(_config(kwargs), device=device)

    def _bevmap_from_cfg(device=None, **kwargs):
        return BEVMap(_config(kwargs), device=device)

    if "ShastaModel" not in MODELS:
        MODELS.register_module(_shasta_from_cfg, name="ShastaModel")
        MODELS.register_module(_bevmap_from_cfg, name="BEVMap")
    if "PubTracker" not in TRACKERS:
        TRACKERS.register_module(PubTracker)
        TRACKERS.register_module(PubTrackerMerged)
        TRACKERS.register_module(MOTModel)
    return {"datasets": DATASETS, "models": MODELS, "trackers": TRACKERS}
