"""The port's train step (shasta_tpu_torch/train/loop.py) against the JAX
package's (CPU, f32; the JAX trunk on its XLA route, use_pallas_gather
False, the port's on the kernels' plain versions).

Weights: a seeded random JAX tree loaded into the port (load_jax_variables);
JAX results come back through the same loader, so both are compared in the
port's names. The config is tests/test_torch_forward.py's: caps that hold
every set of the doubled batch (so each frame's map is that frame's
alone), box centres on the small map.
Tolerances: the loss at rtol 1e-5; grads scaled to their largest value at
atol 2e-3 (tests/test_cached_training.py:92-101); updated parameters
within 2*lr of one step (Adam's first step moves each by about lr); BN
running statistics at rtol 1e-5 of each tensor's largest value (a running
mean near 0 is the difference of two numbers of ~0.1, so its own last bits
are noise); the frozen backbone and neck bit-equal before and after on
both sides.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
from shasta_tpu.train import loop as jloop

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.infer import FRAME_KEYS
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.ops import sparse as sp
from shasta_tpu_torch.train import loop

CFG = dict(max_obj=6, grid_shape=(41, 48, 48), pc_start=(-3.0, -3.0),
           cap_conv2=8192, cap_conv3=8192, cap_conv4=2048, cap_extra=1024)
LR, WD = 1e-3, 1e-2


def _batch(seed=0, B=2):
    b = make_batch(ShastaConfig(**CFG), B, 256, n_dets=6, with_gt=True, seed=seed)
    span = 0.075 * CFG["grid_shape"][2] * 0.9  # centres on the 3.6 m map
    for key in ("det_boxes", "prev_det_boxes"):
        b[key][:, :, :2] = CFG["pc_start"][0] + (b[key][:, :, :2] + 50.0) / 100.0 * span
    return b


def _port(tree, **opt):
    model = ShastaModel(ShastaConfig(**CFG), device="cpu")
    load_jax_variables(model, tree)
    tx = loop.make_optimizer(model, LR, WD, **opt)
    return loop.create_train_state(model, tx), tx


def _as_port(tree):
    """A JAX {'params', 'batch_stats'} tree as the port's state_dict."""
    m = ShastaModel(ShastaConfig(**CFG), device="cpu")
    load_jax_variables(m, jax.tree.map(np.asarray, tree))
    return m.state_dict()


@pytest.fixture(scope="module")
def setup():
    tree = random_jax_variables(ShastaModel(ShastaConfig(**CFG), device="cpu"), seed=2)
    jmodel = JModel(JConfig(**CFG))
    jvars = jax.tree.map(jnp.asarray, tree)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtx = jloop.make_optimizer(LR, WD, True, params=jvars["params"])
    out = {}
    for bn_train in (False, True):
        s = jloop.create_train_state(jmodel, jvars, jtx)
        s, m = jloop.make_train_step(jmodel, jtx, donate=False, bn_train=bn_train)(s, jbatch)
        out[bn_train] = (s, float(m["loss"]))

    @jax.jit
    def grads(params):
        def f(p):
            m1, m2 = jmodel.apply({"params": p, "batch_stats": jvars["batch_stats"]}, jbatch)
            return jloop.bidirectional_ce(m1, m2, jbatch["gt"])
        return jax.grad(f)(params)
    g = grads(jvars["params"])
    return dict(tree=tree, jvars=jvars, batch=batch, jax_steps=out,
                jax_grads=_as_port({"params": g, "batch_stats": jvars["batch_stats"]}))


def _trainable(sd):
    return [k for k in sd if k.split(".")[0] not in loop.FROZEN_TRUNK_KEYS
            and "running" not in k and "num_batches" not in k]


def test_standard_step_matches_jax(setup):
    state, tx = _port(setup["tree"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = loop.make_train_step(state.model, tx)(state, setup["batch"])
    js, jloss = setup["jax_steps"][False]
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    named = dict(state.model.named_parameters())
    sd, want = state.model.state_dict(), _as_port({"params": js.params,
                                                  "batch_stats": js.batch_stats})
    checked = 0
    for k in _trainable(sd):
        g, jg = named[k].grad.numpy(), setup["jax_grads"][k].numpy()
        scale = max(1e-3, float(np.abs(jg).max()))
        np.testing.assert_allclose(g / scale, jg / scale, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=2 * LR, rtol=0,
                                   err_msg=k)
        assert not torch.equal(sd[k], before[k]), k
        checked += 1
    assert checked > 40
    for k in sd:  # the frozen trunk, on both sides
        if k.split(".")[0] in loop.FROZEN_TRUNK_KEYS:
            assert named.get(k) is None or named[k].grad is None
            assert torch.equal(sd[k], before[k]), k
    for part in loop.FROZEN_TRUNK_KEYS:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     js.params[part], setup["jvars"]["params"][part])


def test_bn_train_step_matches_jax(setup):
    """bn_train: batch statistics in every BN, running statistics updated
    (the sparse trunk's masked ones, the neck's and shared conv's flax ones)."""
    state, tx = _port(setup["tree"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = loop.make_train_step(state.model, tx, bn_train=True)(state, setup["batch"])
    js, jloss = setup["jax_steps"][True]
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    sd, want = state.model.state_dict(), _as_port({"params": js.params,
                                                  "batch_stats": js.batch_stats})
    running = [k for k in sd if "running" in k]
    assert len(running) == 2 * (1 + 4 + 3 * 5 + 1 + 12 + 2 + 1)  # every BN of the model
    for k in running:
        assert not torch.equal(sd[k], before[k]), k
        w = want[k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)
    for k in _trainable(sd):
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=2 * LR, rtol=0,
                                   err_msg=k)
    for k in sd:
        if k.split(".")[0] in loop.FROZEN_TRUNK_KEYS and "running" not in k:
            assert torch.equal(sd[k], before[k]), k


def _one_step(tree, batch, **kw):
    state, tx = _port(tree)
    state, m = loop.make_train_step(state.model, tx, **kw)(state, batch)
    return float(m["loss"]), state.model.state_dict()


@pytest.mark.parametrize("mode", [dict(frozen_trunk_fast=True), dict(remat=True),
                                  dict(remat=True, bn_train=True)])
def test_modes_equal_their_plain_step(setup, mode):
    """frozen_trunk_fast equals the standard step; remat equals the same
    step without it, BN running statistics included (the recompute must
    not move them twice)."""
    base = {k: v for k, v in mode.items() if k == "bn_train"}
    loss, sd = _one_step(setup["tree"], setup["batch"], **mode)
    want_loss, want = _one_step(setup["tree"], setup["batch"], **base)
    assert loss == want_loss
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], atol=1e-7, rtol=0, msg=k)


def test_cached_step_equals_full_step(setup):
    """With caps that hold every set, the cached step (descriptors from
    frame_features, as tools.cache_features makes them) equals the full step."""
    batch = setup["batch"]
    model = ShastaModel(ShastaConfig(**CFG), device="cpu")
    load_jax_variables(model, setup["tree"])
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        feats = {p + "feat": model.frame_features({k: t[p + k] for k in FRAME_KEYS})
                 for p in ("", "prev_")}
    cached = {k: batch[k] for k in ("det_boxes", "prev_det_boxes", "gt")} | feats
    loss_c, sd_c = _one_step(setup["tree"], cached, cached=True)
    loss, sd = _one_step(setup["tree"], batch)
    np.testing.assert_allclose(loss_c, loss, rtol=1e-5)
    for k in _trainable(sd):
        if k.split(".")[0] == "shared_conv":
            continue  # no grad reaches it in the cached step
        np.testing.assert_allclose(sd_c[k].numpy(), sd[k].numpy(), atol=2 * LR, rtol=0,
                                   err_msg=k)


def test_trained_trunk_gets_grads_without_kernels(setup, monkeypatch):
    """freeze_bev=False: the trunk takes the plain versions with autograd
    (a launch of a kernel wrapper would fail here), grads reach the trunk
    and its parameters move."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a trunk that trains launched a kernel")
    monkeypatch.setattr(sp, "sorted_lookup", no_kernel)
    monkeypatch.setattr(sp, "gather_conv", no_kernel)
    state, tx = _port(setup["tree"], freeze_bev=False)
    assert loop.trunk_trains(state.model) and "autograd" in loop.trunk_route(state.model)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = loop.make_train_step(state.model, tx)(state, setup["batch"])
    assert np.isfinite(float(m["loss"]))
    named = dict(state.model.named_parameters())
    sd = state.model.state_dict()
    for k in ("backbone.conv_input.0.weight", "backbone.conv4.4.conv2.weight",
              "neck.blocks.0.1.weight", "neck.deblocks.1.0.weight"):
        assert float(named[k].grad.abs().max()) > 0, k
        assert not torch.equal(sd[k], before[k]), k
