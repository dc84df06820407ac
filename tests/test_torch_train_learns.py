"""Closed-loop training sanity of the port (CPU): on a learnable synthetic
association task (curr dets = prev dets + noise, diagonal GT matching) the
train step cuts the loss below 0.7x its start within 30 steps, in the
standard mode (the frozen trunk, as tests/test_training_learns.py:37) and
in the cached mode (random per-slot descriptors shared by matched pairs, as
tests/test_cached_training.py:105)."""
import numpy as np
import torch

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.train import loop

CFG = ShastaConfig(max_obj=6, grid_shape=(41, 48, 48), cap_conv2=512, cap_conv3=256,
                   cap_conv4=128, cap_extra=128)


def _learnable(rng, B=4):
    b = make_batch(CFG, batch_size=B, num_voxels_cap=256, n_dets=CFG.max_obj, with_gt=True,
                   seed=int(rng.integers(1 << 30)))
    N = CFG.max_obj
    curr = b["prev_det_boxes"].copy()
    curr[:, :, :2] += rng.normal(0, 0.3, (B, N, 2)).astype(np.float32)
    curr[:, :, 9] = 0.5
    b["det_boxes"] = curr
    b["gt"] = np.zeros((B, N + 2, N + 2), np.float32)
    b["gt"][:, np.arange(N), np.arange(N)] = 1.0
    return b


def _model(seed):
    """flax's default init, which the JAX tests train from: weights ~
    N(0, 1/fan_in), biases 0, every BN the identity (torch's default Linear
    init learns far slower)."""
    model = ShastaModel(CFG, device="cpu")
    load_jax_variables(model, random_jax_variables(model, seed))
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("bias", "running_mean")):
                v.zero_()
            elif k.endswith("running_var") or (v.dim() == 1 and k.endswith("weight")):
                v.fill_(1.0)
    return model


def _learns(losses):
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(last) and last < 0.7 * first, (first, last, losses)


def test_standard_training_learns():
    model = _model(0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = loop.make_optimizer(model, learning_rate=3e-4, freeze_bev=True)
    state, step = loop.create_train_state(model, tx), loop.make_train_step(model, tx)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(30):
        state, m = step(state, _learnable(rng))
        losses.append(float(m["loss"]))
    _learns(losses)
    sd = model.state_dict()
    assert torch.equal(sd["backbone.conv_input.0.weight"], before["backbone.conv_input.0.weight"])
    assert not torch.equal(sd["aff.0.weight"], before["aff.0.weight"])


def test_cached_training_learns():
    model = _model(1)
    tx = loop.make_optimizer(model, learning_rate=1e-3, freeze_bev=True)
    state, step = loop.create_train_state(model, tx), loop.make_train_step(model, tx, cached=True)
    rng = np.random.default_rng(0)
    F = CFG.num_point * CFG.share_conv_channel
    losses = []
    for _ in range(30):
        b = _learnable(rng)
        emb = rng.normal(0, 1, (4, CFG.max_obj, F)).astype(np.float32)
        b.update(feat=emb, prev_feat=emb)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    _learns(losses)
