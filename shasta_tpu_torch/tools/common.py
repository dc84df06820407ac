"""What the serving CLIs share: the model from a config
(`build_model`, the port of tools/train.py:47-57), its weights from a
checkpoint, the dataset of a split and the single-class pipeline."""
from __future__ import annotations

import torch

from ..data.nuscenes import NuScenesTrackDataset, PointPipelineConfig
from ..infer import ScenePipeline, default_tracker_params
from ..models import ShastaConfig, ShastaModel
from ..tracker.pub_tracker import NUSCENES_TRACKING_NAMES
from ..train.checkpoint import load_checkpoint, merge_pretrained

# cfg.model keys that only the JAX model reads, dropped here
JAX_ONLY_KEYS = (
    "type",  # the JAX registry's class name
    "use_pallas_gather",  # the JAX trunk's Pallas route (the port picks its route by the frame)
    "assume_sorted_voxels",  # lets the JAX trunk skip its stage-0 argsort
)


def model_config(cfg) -> ShastaConfig:
    """The ShastaConfig of cfg.model."""
    return ShastaConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg.model.items() if k not in JAX_ONLY_KEYS})


def build_model(cfg, device=None, seed: int = 0) -> ShastaModel:
    """The port's ShastaModel of cfg.model on `device` (default "cuda"),
    its weights initialised from torch seed `seed` (the global generator is
    left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return ShastaModel(model_config(cfg), device=device)


def load_model(cfg, checkpoint: str | None, device=None) -> ShastaModel:
    """build_model with a checkpoint's matching tensors merged in."""
    model = build_model(cfg, device)
    if checkpoint:
        model.load_state_dict(merge_pretrained(model.state_dict(),
                                               load_checkpoint(checkpoint)))
    return model


def build_dataset(cfg, split: str, load_points: bool = True) -> NuScenesTrackDataset:
    """The serving dataset of cfg.data[split], points in file order."""
    pp = dict(cfg.point_pipeline)
    pp["shuffle_points"] = False
    return NuScenesTrackDataset(
        **dict(cfg.data[split]),
        det_type=list(cfg.det_type),
        max_objects=cfg.max_objects,
        pipeline=PointPipelineConfig(**pp),
        load_points=load_points,
    )


def build_pipeline(cfg, model: ShastaModel) -> ScenePipeline:
    """The single-class serving pipeline of cfg's class, on the model's device."""
    return ScenePipeline(
        model,
        cls_id=NUSCENES_TRACKING_NAMES.index(cfg.det_type[0]),
        params=default_tracker_params(max_age=cfg.max_age, device=model.device),
        fp_thresh=cfg.get("fp_elim", 0.7),
        decision_thresh=cfg.get("decision_thresh", 0.5),
    )
