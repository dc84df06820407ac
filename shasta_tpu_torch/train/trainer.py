"""Hook-based epoch trainer (the torchie Trainer equivalent): the port of
shasta_tpu/train/trainer.py.

Behavioral reference: det3d/torchie/trainer/trainer.py:129-594 (a priority
hook system with before/after run/epoch/iter callbacks; checkpoint, timer
and text-logger hooks). tools/train.py rolls its own loop, as the
reference's ShaSTA training does; this Trainer is the config-driven
alternative with the same extension points. The state is any object with
a state_dict() (train/loop.py's TrainState); checkpoints are .pth files
that the port and the JAX package both load.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..parallel import dist as pdist
from .checkpoint import save_checkpoint


class Hook:
    priority: int = 50

    def before_run(self, t: "Trainer"):
        pass

    def after_run(self, t: "Trainer"):
        pass

    def before_epoch(self, t: "Trainer"):
        pass

    def after_epoch(self, t: "Trainer"):
        pass

    def before_iter(self, t: "Trainer"):
        pass

    def after_iter(self, t: "Trainer"):
        pass


class CheckpointHook(Hook):
    """epoch_{N}.pth in the work dir every `interval` epochs (rank 0 alone
    in a process group: the ranks hold the same parameters)."""

    priority = 30

    def __init__(self, interval: int = 1):
        self.interval = interval

    def after_epoch(self, t: "Trainer"):
        if (t.epoch + 1) % self.interval == 0 and pdist.rank() == 0:
            path = os.path.join(t.work_dir, f"epoch_{t.epoch + 1}.pth")
            save_checkpoint(path, t.state.state_dict())
            t.log(f"saved checkpoint {path}")


class IterTimerHook(Hook):
    priority = 60

    def before_iter(self, t: "Trainer"):
        self._t0 = time.perf_counter()

    def after_iter(self, t: "Trainer"):
        t.metrics["iter_time"] = time.perf_counter() - self._t0


class TextLoggerHook(Hook):
    priority = 90

    def __init__(self, interval: int = 10):
        self.interval = interval

    def after_iter(self, t: "Trainer"):
        if (t.iter + 1) % self.interval == 0:
            t.log(f"epoch {t.epoch} iter {t.iter + 1}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in t.metrics.items()))


class JsonlLoggerHook(Hook):
    priority = 85

    def after_iter(self, t: "Trainer"):
        with open(os.path.join(t.work_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": t.epoch, "iter": t.iter, **t.metrics}) + "\n")


class WandbHook(Hook):
    """Optional wandb logging (reference train.py:246-256)."""

    priority = 85

    def __init__(self, project: str, group: str | None = None, config=None):
        import wandb  # gated import: not installed with the port

        self.run = wandb.init(project=project, group=group, config=config, reinit=True)

    def after_iter(self, t: "Trainer"):
        self.run.log({"batch_loss": t.metrics.get("loss")})

    def after_epoch(self, t: "Trainer"):
        self.run.log({"epoch": t.epoch})

    def after_run(self, t: "Trainer"):
        self.run.finish()


class EpochSeedHook(Hook):
    """Reseed the loader's shuffle per epoch (the DistSamplerSeedHook
    equivalent: without it every epoch replays the same order)."""

    def __init__(self, loader):
        self.loader = loader

    def before_epoch(self, t: "Trainer"):
        self.loader.epoch = t.epoch


class NanGuardHook(Hook):
    """On a non-finite loss, save rescue_nan.pth and stop, instead of
    training on garbage (absent in the reference, SURVEY §5)."""

    priority = 10  # before the loggers

    def after_iter(self, t: "Trainer"):
        loss = t.metrics.get("loss")
        if loss is not None and not math.isfinite(loss):
            path = os.path.join(t.work_dir, "rescue_nan.pth")
            save_checkpoint(path, t.state.state_dict())
            raise FloatingPointError(f"non-finite loss {loss} at epoch {t.epoch} iter {t.iter}; "
                                     f"state saved to {path}")


@dataclass
class Trainer:
    """Epoch loop driving a train step with prioritized hooks."""

    step_fn: Callable  # (state, batch) -> (state, metrics)
    state: Any
    data_fn: Callable  # () -> iterable of batches
    work_dir: str
    max_epochs: int = 3
    hooks: list[Hook] = field(default_factory=list)

    epoch: int = 0
    iter: int = 0
    metrics: dict = field(default_factory=dict)

    def register_hook(self, hook: Hook):
        self.hooks.append(hook)
        self.hooks.sort(key=lambda h: h.priority)

    def call(self, name: str):
        for h in self.hooks:
            getattr(h, name)(self)

    def log(self, msg: str):
        print(f"[trainer] {msg}")

    def run(self):
        os.makedirs(self.work_dir, exist_ok=True)
        self.call("before_run")
        for self.epoch in range(self.epoch, self.max_epochs):
            self.call("before_epoch")
            for self.iter, batch in enumerate(self.data_fn()):
                self.call("before_iter")
                self.state, metrics = self.step_fn(self.state, batch)
                self.metrics = {k: float(v) for k, v in metrics.items()}
                self.call("after_iter")
            self.call("after_epoch")
        self.call("after_run")
        return self.state
