"""Training step: masked bidirectional CE, Adam with L2, data parallelism
over a torch.distributed process group. The port of
shasta_tpu/train/loop.py.

Behavioral reference: tools/nusc_shasta/train.py:141-224: Adam(lr=1e-4,
weight_decay=1e-2) (torch Adam + L2, not AdamW), an optional OneCycle
schedule (configs/nusc/car.py:223-229), the frozen BEV trunk (backbone +
neck, train.py:184-191), and the loss: the mean of row-CE(matched1 |
gt[:, :-2, :]) and col-CE(matched2 | gt[:, :, :-2]), each normalised by the
GT mass (train.py:208-211).

The frozen trunk runs under torch.no_grad(): on the card it launches the
CUDA kernels, 12 sorted_lookup and 21 gather_conv on the doubled batch of
2B frames. So the standard step and `frozen_trunk_fast` compute the same
thing here. A trunk that trains (freeze_bev False) runs the kernels' plain
versions with autograd (SparseBackbone.trains); `trunk_route` names the
route. Frozen parameters are not in the optimizer at all: torch Adam with
weight_decay would move a parameter whose grad is zero, where optax's
set_to_zero leaves it alone.

Where a process group is initialised (parallel/dist.py), grads and loss
are all-reduced as means before the update, the JAX pmean (loop.py:190-192).

    tx = make_optimizer(model, learning_rate, weight_decay, freeze_bev=True)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx)
    state, metrics = step(state, batch)   # batch: numpy arrays or tensors
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import upload
from ..infer import FRAME_KEYS
from ..parallel import dist as pdist
from ..utils.profiler import annotate

EPS = 1e-10
FROZEN_TRUNK_KEYS = ("backbone", "neck")
# batch keys each mode reads; anything else (tokens, metadata) stays on the host
PAIR_KEYS = ("gt",) + FRAME_KEYS + tuple("prev_" + k for k in FRAME_KEYS)
CACHED_KEYS = ("det_boxes", "prev_det_boxes", "gt", "feat", "prev_feat")


def bidirectional_ce(matched1: torch.Tensor, matched2: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Masked bidirectional cross-entropy (train.py:201-211). gt: (B, N+2,
    N+2) with rows = prev dets + [newborn, fp], cols = curr dets + [dead,
    fn]. Zero rows and columns contribute nothing."""
    gt1, gt2 = gt[:, :-2, :], gt[:, :, :-2]
    f = torch.sum(gt1 * -torch.log(matched1 + EPS))
    b = torch.sum(gt2 * -torch.log(matched2 + EPS))
    s1, s2 = torch.sum(gt1), torch.sum(gt2)
    loss_f = torch.where(s1 > 0, f / torch.clamp(s1, min=1.0), f)
    loss_b = torch.where(s2 > 0, b / torch.clamp(s2, min=1.0), b)
    return (loss_f + loss_b) / 2.0


def _param_labels(model: nn.Module, freeze_bev: bool) -> dict[str, str]:
    """{parameter name: "train" | "frozen"}: with freeze_bev the top-level
    backbone and neck are frozen (loop.py:54-61)."""
    return {n: "frozen" if freeze_bev and n.split(".")[0] in FROZEN_TRUNK_KEYS else "train"
            for n, _ in model.named_parameters()}


def one_cycle_schedule(total_steps: int, max_lr: float = 1e-3, pct_start: float = 0.4,
                       div_factor: float = 10.0) -> Callable[[int], float]:
    """torch OneCycleLR(cos) equivalent (configs/nusc/car.py:223-229): the
    value of optax.cosine_onecycle_schedule at each count (count 0 is the
    first update), written out: from max_lr/div_factor up to max_lr over
    int(pct_start * total_steps) counts, then down to max_lr/(div_factor *
    1e4) at total_steps, each leg a half cosine, flat after."""
    if total_steps <= 0:
        raise ValueError("a onecycle schedule needs total_steps > 0")
    bounds = np.array([0, int(pct_start * total_steps), int(total_steps)], np.float64)
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * 1e4)])

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (count - bounds[:-1]) / (bounds[1:] - bounds[:-1])
        interp = values[1:] + (values[:-1] - values[1:]) / 2.0 * (np.cos(np.pi * pct) + 1)
        inside = (bounds[:-1] <= count) & (count < bounds[1:])
        return float(inside.dot(interp) + (bounds[-1] <= count) * values[-1])
    return schedule


class Optimizer:
    """The optax chain of make_optimizer (loop.py:64-87) over the trainable
    parameters: clip_by_global_norm (optional), add_decayed_weights, Adam
    (b1 0.9, b2 0.999, eps 1e-8), the learning rate or schedule. Adam with
    L2 added to the grad before the moments is torch.optim.Adam's
    weight_decay."""

    def __init__(self, params: list[nn.Parameter], learning_rate: float,
                 weight_decay: float, schedule: Callable[[int], float] | None = None,
                 grad_clip_norm: float | None = None):
        self.params = params
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.adam = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)
        self.count = 0  # updates applied: the schedule's count

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def grads(self) -> list[torch.Tensor]:
        """Every trainable parameter's grad, zeros where the backward left
        none: optax hands each leaf a grad (zero when unused) and decays it,
        where torch Adam would skip a parameter without one. So in the
        cached step the shared conv, which the head never reaches, still
        decays by L2 as it does in the JAX package."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self) -> None:
        grads = self.grads()
        if self.grad_clip_norm is not None:
            clip_by_global_norm(grads, self.grad_clip_norm)
        if self.schedule is not None:
            for group in self.adam.param_groups:
                group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: with the norm over all grads at
    or above max_norm, each grad becomes grad / norm * max_norm (not
    clip_grad_norm_'s max / (norm + 1e-6))."""
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:  # a select, as optax's: no wait for the card
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4, weight_decay: float = 1e-2,
                   freeze_bev: bool = True, schedule: Callable[[int], float] | None = None,
                   grad_clip_norm: float | None = None) -> Optimizer:
    """Adam(+L2) over the parameters `_param_labels` calls trainable, with
    grads turned on for them and off for the frozen ones."""
    labels = _param_labels(model, freeze_bev)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if labels[name] == "train":
            params.append(p)
    return Optimizer(params, learning_rate, weight_decay, schedule, grad_clip_norm)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer and the
    number of steps taken (loop.py:30-34)."""

    model: nn.Module
    tx: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        """What a checkpoint holds: parameters and BN statistics (as in the
        JAX package, not the optimizer's moments)."""
        return self.model.state_dict()


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    """TrainState at step 0; in a process group every rank starts from
    rank 0's parameters and statistics."""
    pdist.broadcast_module(model)
    return TrainState(model, tx)


def trunk_trains(model: nn.Module) -> bool:
    """Whether a parameter of the backbone or the neck requires grad."""
    return any(p.requires_grad for k in FROZEN_TRUNK_KEYS
               for p in getattr(model, k).parameters())


def trunk_route(model: nn.Module) -> str:
    """The route the trunk takes in a train step."""
    if trunk_trains(model):
        return "trained trunk: the kernels' plain versions with autograd, no kernel launch"
    return ("frozen trunk under torch.no_grad(): the CUDA kernels on the card (on the CPU "
            "their plain versions)")


def _head(model, maps: torch.Tensor, batch: dict):
    """Shared conv, box sampling and affinity head on the neck's maps of the
    doubled batch (2B, 512, H, W)."""
    bev = model.shared_conv(maps).permute(0, 2, 3, 1)
    B = bev.shape[0] // 2
    return model.pair_head(bev[:B], bev[B:], batch)


def pair_forward(model, batch: dict, remat: bool = False):
    """The two-frame forward of a train step -> (matched1, matched2). A
    frozen trunk runs under no_grad; remat recomputes the part that has
    gradients (the whole forward when the trunk trains) in the backward."""
    def trunk():
        with annotate("train.trunk"):
            return model.neck(model.backbone(model.pair_tensor(batch)))

    if trunk_trains(model):
        def full():
            return _head(model, trunk(), batch)
        return checkpoint(full, use_reentrant=False) if remat else full()
    with torch.no_grad():
        maps = trunk()
    with annotate("train.head"):
        if remat:
            return checkpoint(lambda m: _head(model, m, batch), maps, use_reentrant=False)
        return _head(model, maps, batch)


def make_train_step(model, tx: Optimizer, bn_train: bool = False, remat: bool = False,
                    cached: bool = False, frozen_trunk_fast: bool = False):
    """The train step (loop.py:114-220): (state, batch) -> (state,
    {"loss"}), the state updated in place.

    - standard: the two-frame forward (`pair_forward`), then the loss;
    - cached: the affinity head alone on precomputed descriptors (batch
      keys feat / prev_feat, tools/cache_features.py);
    - frozen_trunk_fast: the standard step, which already leaves the frozen
      trunk out of the graph;
    - bn_train: the whole model in train mode, BN on batch statistics with
      its running statistics updated (a frozen trunk's parameters stay);
    - remat: torch.utils.checkpoint around the part that has gradients.
    """
    assert not (cached and bn_train), "cached training never runs the trunk"
    assert not (frozen_trunk_fast and bn_train), (
        "frozen_trunk_fast keeps the trunk constant; BN must run in eval mode")
    assert not (frozen_trunk_fast and trunk_trains(model)), (
        "frozen_trunk_fast needs the trunk frozen (freeze_bev)")
    keys = CACHED_KEYS if cached else PAIR_KEYS

    def forward(batch):
        if cached:
            def head():
                return model.affinity_step(batch["prev_det_boxes"], batch["det_boxes"],
                                           batch["prev_feat"], batch["feat"])
            return checkpoint(head, use_reentrant=False) if remat else head()
        return pair_forward(model, batch, remat)

    def step(state: TrainState, batch: dict):
        batch = {k: upload(batch[k], model.device) for k in keys}
        model.train(bn_train)
        tx.zero_grad()
        m1, m2 = forward(batch)
        loss = bidirectional_ce(m1, m2, batch["gt"])
        # the recompute of a checkpointed forward would move the BN running
        # statistics a second time: keep the forward's
        stats = ({k: v.clone() for k, v in model.state_dict().items() if "running" in k}
                 if remat and bn_train else None)
        with annotate("train.backward"):
            loss.backward()
        if stats:
            sd = model.state_dict()
            with torch.no_grad():
                for k, v in stats.items():
                    sd[k].copy_(v)
        loss = loss.detach()
        with annotate("train.update"):
            if pdist.world_size() > 1:
                pdist.all_reduce_mean(tx.grads() + [loss])
            tx.step()
        state.step += 1
        return state, {"loss": loss}

    return step
