"""Train a per-class ShaSTA affinity model: the port of tools/train.py.

Behavioral reference: tools/nusc_shasta/train.py:44-257 (a custom loop:
Adam, frozen BEV trunk, masked bidirectional CE, a checkpoint and an
optional validation per epoch).

    python -m shasta_tpu_torch.tools.train --config configs/nusc/car.py \\
        [--work_dir work_dirs/car] [--cached_features DIR] [--smoke] [--cpu]
    torchrun --nproc_per_node N -m shasta_tpu_torch.tools.train --config ...

Runs on the card unless --cpu is given; under torchrun one process per
card, each loading its shard of every epoch (parallel/dist.py), grads and
loss all-reduced as means. A frozen trunk (freeze_bev) runs the CUDA
kernels under torch.no_grad(); a trained one the kernels' plain versions
with autograd; the log names the route. --pallas_trunk is accepted for
the JAX flag's sake: the port's standard step already keeps the frozen
trunk out of the graph. Each epoch writes epoch_{N}.pth (parameters and BN
statistics, which the JAX package's load_checkpoint also reads) and
appends one row per step to train_log.jsonl; --resume restarts from the
latest epoch_{N}.pth with fresh Adam moments, as the JAX tool does.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np

from ..data.loader import DataLoader
from ..data.nuscenes import CachedFeatureDataset, NuScenesTrackDataset, PointPipelineConfig
from ..data.synthetic import make_batch
from ..device import resolve_device
from ..parallel import dist as pdist
from ..train.checkpoint import load_checkpoint, merge_pretrained, save_checkpoint
from ..train.loop import (create_train_state, make_optimizer, make_train_step,
                          one_cycle_schedule, trunk_route)
from ..utils import Config
from .common import build_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the ShaSTA affinity model")
    p.add_argument("--config", default="configs/nusc/car.py")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--checkpoint", default=None, help="init checkpoint (.pth)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest epoch_N.pth in work_dir")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--smoke", action="store_true", help="synthetic data smoke run")
    p.add_argument("--smoke_steps", type=int, default=3)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--validate", action="store_true", help="run validation per epoch")
    p.add_argument("--cached_features", default=None,
                   help="dir of precomputed BEV descriptors (tools.cache_features); "
                        "trains the affinity head alone")
    p.add_argument("--pallas_trunk", action="store_true",
                   help="the JAX frozen-trunk fast path; requires freeze_bev (the port's "
                        "standard step is that path already)")
    return p.parse_args(argv)


def _latest_epoch(work_dir: str):
    found = sorted((int(m.group(1)), d) for d in os.listdir(work_dir)
                   if (m := re.fullmatch(r"epoch_(\d+)\.pth", d)))
    return found[-1] if found else None


def main(argv=None) -> dict:
    """Returns {"route", "steps_per_epoch", "losses" (per epoch, per step),
    "checkpoints", "wait_s" and "step_s" (per step: waiting for the loader,
    the step until its loss is read)}."""
    args = parse_args(argv)
    device = resolve_device(pdist.init_from_env("cpu" if args.cpu else "cuda"))
    rank, world = pdist.rank(), pdist.world_size()
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or f"work_dirs/{os.path.basename(args.config)[:-3]}"
    os.makedirs(work_dir, exist_ok=True)
    epochs = args.epochs or cfg.total_epochs
    seed = args.seed if args.seed is not None else cfg.get("seed", 0)
    if args.pallas_trunk and not cfg.freeze_bev:
        raise SystemExit("--pallas_trunk requires freeze_bev in the config")

    model = build_model(cfg, device, seed=seed)
    print(f"devices: {world} x {device.type} ({device}), work_dir: {work_dir}")

    # ---- data ----
    if args.smoke:
        steps_per_epoch = args.smoke_steps
        smoke = make_batch(model.cfg, batch_size=1, num_voxels_cap=2048,
                           n_dets=min(8, model.cfg.max_obj), with_gt=True, seed=seed + rank)

        def batches(epoch):
            return iter([smoke] * steps_per_epoch)
    else:
        ds = NuScenesTrackDataset(
            **dict(cfg.data.train), det_type=list(cfg.det_type),
            max_objects=cfg.max_objects, fp_ratio=cfg.fp_ratio,
            dead_trk_ratio=cfg.dead_trk_ratio,
            pipeline=PointPipelineConfig(**dict(cfg.point_pipeline)), seed=seed,
            load_points=args.cached_features is None)
        if args.cached_features:
            ds = CachedFeatureDataset(ds, args.cached_features)
        loader = DataLoader(ds, batch_size=cfg.data.samples_per_device,
                            num_workers=cfg.data.workers, seed=seed, shard_id=rank,
                            num_shards=world)
        steps_per_epoch = len(loader)

        def batches(epoch):
            loader.epoch = epoch  # a fresh shuffle per epoch (the sampler's reseed)
            return iter(loader)

    # ---- init ----
    start_epoch = 0
    if args.resume and (latest := _latest_epoch(work_dir)):
        start_epoch, name = latest
        model.load_state_dict(merge_pretrained(model.state_dict(),
                                               load_checkpoint(os.path.join(work_dir, name))))
        print(f"resumed from {name} (epoch {start_epoch})")
    pretrained = cfg.get("pretrained_bev_map")
    if args.checkpoint:
        model.load_state_dict(merge_pretrained(model.state_dict(),
                                               load_checkpoint(args.checkpoint)))
        print(f"loaded checkpoint {args.checkpoint}")
    elif pretrained and os.path.exists(pretrained):
        model.load_state_dict(merge_pretrained(model.state_dict(), load_checkpoint(pretrained)))
        print(f"loaded pretrained BEV trunk {pretrained}")

    schedule = (one_cycle_schedule(epochs * steps_per_epoch, **dict(cfg.scheduler))
                if cfg.get("use_scheduler") else None)
    tx = make_optimizer(model, learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                        freeze_bev=cfg.freeze_bev, schedule=schedule,
                        grad_clip_norm=cfg.get("grad_clip"))
    state = create_train_state(model, tx)
    cached = args.cached_features is not None
    step_fn = make_train_step(model, tx, cached=cached,
                              frozen_trunk_fast=args.pallas_trunk and not cached)
    route = "cached descriptors: the affinity head alone" if cached else trunk_route(model)
    print(f"train step: {route}; {steps_per_epoch} steps per epoch")

    # ---- loop ----
    log_path = os.path.join(work_dir, "train_log.jsonl")
    out = {"route": route, "steps_per_epoch": steps_per_epoch, "losses": [],
           "checkpoints": [], "wait_s": [], "step_s": []}
    for epoch in range(start_epoch, epochs):
        losses = []
        t0 = time.time()
        it = batches(epoch)
        while True:
            t_wait = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            out["wait_s"].append(t_step - t_wait)
            out["step_s"].append(time.perf_counter() - t_step)
            if rank == 0:
                with open(log_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "step": len(losses), "loss": loss}) + "\n")
            losses.append(loss)
        out["losses"].append(losses)
        print(f"epoch {epoch}: loss={np.mean(losses):.4f} ({len(losses)} steps, "
              f"{time.time() - t0:.1f}s)")
        ckpt_path = os.path.join(work_dir, f"epoch_{epoch + 1}.pth")
        if rank == 0:
            save_checkpoint(ckpt_path, state.state_dict())
            print(f"saved {ckpt_path}")
            out["checkpoints"].append(ckpt_path)
            if args.validate and not args.smoke:
                from .validate import validate

                validate(args.config, ckpt_path,
                         os.path.join(work_dir, f"val_epoch{epoch + 1}"), device=device)
    pdist.shutdown()
    print("done")
    return out


if __name__ == "__main__":
    main()
