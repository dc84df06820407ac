"""The parts of the port's training around the step, against the JAX
package's: the loss (rtol 1e-6), the one-cycle schedule (rtol 1e-6 at every
count), the optimizer against the optax chain (parameters at atol 1e-7
over 5 updates on fixed grads), the hook trainer (tests/test_trainer_
registry.py:27-120), the data loader and its dataset wrappers (the same
batches, exactly), and the kernel wrappers' refusal of inputs that require
grad.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from torch import nn

from shasta_tpu.data import loader as jloader
from shasta_tpu.train import loop as jloop

from shasta_tpu_torch.data import loader
from shasta_tpu_torch.train import loop
from shasta_tpu_torch.train.trainer import (CheckpointHook, EpochSeedHook, IterTimerHook,
                                            JsonlLoggerHook, NanGuardHook, TextLoggerHook,
                                            Trainer)


def _gt(rng, B=2, N=5):
    gt = np.zeros((B, N + 2, N + 2), np.float32)
    for b in range(B):
        for i in range(N):
            gt[b, i, rng.choice([rng.integers(N), N, N + 1])] = 1.0
        gt[b, N, rng.integers(N)] = 1.0
        gt[b, N + 1, rng.integers(N)] = 1.0
    return gt


@pytest.mark.parametrize("case", ["labels", "no prev rows", "empty"])
def test_bidirectional_ce_matches_jax(case):
    rng = np.random.default_rng(3)
    B, N = 2, 5
    m1 = rng.dirichlet(np.ones(N + 2), (B, N)).astype(np.float32)
    m2 = rng.dirichlet(np.ones(N + 2), (B, N)).transpose(0, 2, 1).astype(np.float32)
    gt = _gt(rng, B, N)
    if case == "no prev rows":
        gt[:, :N, :] = 0
    elif case == "empty":
        gt[:] = 0
    got = loop.bidirectional_ce(*(torch.as_tensor(a) for a in (m1, m2, gt)))
    want = jloop.bidirectional_ce(*(jnp.asarray(a) for a in (m1, m2, gt)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(max_lr=3e-4, pct_start=0.25, div_factor=25.0)])
def test_one_cycle_schedule_matches_optax(kw):
    """optax's schedule evaluated in double precision: in float32 its
    cos(pi * pct) + 1 cancels near the end of each leg (up to 2e-5 relative
    at counts 91-99), round-off that is not part of the schedule."""
    got, want = loop.one_cycle_schedule(100, **kw), jloop.one_cycle_schedule(100, **kw)
    with jax.enable_x64(True):
        values = [float(want(np.int64(count))) for count in range(105)]
    for count, v in enumerate(values):
        np.testing.assert_allclose(got(count), v, rtol=1e-6, err_msg=count)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone, self.neck, self.aff = nn.Linear(3, 2), nn.Linear(2, 2), nn.Linear(2, 1)


@pytest.mark.parametrize("opts", [dict(freeze_bev=True), dict(freeze_bev=False),
                                  dict(freeze_bev=True, grad_clip_norm=0.5),
                                  dict(freeze_bev=True, schedule="onecycle")])
def test_optimizer_matches_optax_chain(opts):
    """L2 before Adam, frozen backbone/neck left exactly as they are, the
    global-norm clip, a schedule: 5 updates on fixed grads."""
    opts = dict(opts)
    if opts.get("schedule"):
        opts["schedule"] = loop.one_cycle_schedule(5)
        jsched = jloop.one_cycle_schedule(5)
    torch.manual_seed(0)
    net = _Net()
    params = {f"{m}": {"w": net.get_submodule(m).weight.detach().numpy().copy(),
                       "b": net.get_submodule(m).bias.detach().numpy().copy()}
              for m in ("backbone", "neck", "aff")}
    jparams = {m: {k: jnp.asarray(v) for k, v in p.items()} for m, p in params.items()}
    tx = loop.make_optimizer(net, 1e-4, 1e-2, **opts)  # the configs' lr and L2
    jtx = jloop.make_optimizer(1e-4, 1e-2, opts["freeze_bev"], params=jparams,
                               schedule=jsched if opts.get("schedule") else None,
                               grad_clip_norm=opts.get("grad_clip_norm"))
    jstate = jtx.init(jparams)
    rng = np.random.default_rng(0)
    for _ in range(5):
        grads = {m: {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in p.items()}
                 for m, p in params.items()}
        for m in params:
            mod = net.get_submodule(m)
            if mod.weight.requires_grad:
                mod.weight.grad = torch.as_tensor(grads[m]["w"])
                mod.bias.grad = torch.as_tensor(grads[m]["b"])
        tx.step()
        jg = {m: {k: jnp.asarray(v) for k, v in g.items()} for m, g in grads.items()}
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for m in params:
        mod = net.get_submodule(m)
        for k, t in (("w", mod.weight), ("b", mod.bias)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[m][k]),
                                       atol=1e-7, rtol=0, err_msg=f"{m}.{k}")
            if opts["freeze_bev"] and m != "aff":
                np.testing.assert_array_equal(t.detach().numpy(), params[m][k])
                assert not t.requires_grad


class _State:
    def __init__(self):
        self.model = nn.Linear(2, 2)

    def state_dict(self):
        return self.model.state_dict()


def test_trainer_hooks_order_and_logs(tmp_path):
    calls = []

    class Spy:
        priority = 10

        def __getattr__(self, name):
            if name.startswith(("before_", "after_")):
                return lambda t: calls.append((name, t.epoch))
            raise AttributeError(name)

    tr = Trainer(step_fn=lambda s, b: (s + 1, {"loss": torch.tensor(b)}), state=0,
                 data_fn=lambda: iter([1.0, 2.0]), work_dir=str(tmp_path), max_epochs=2)
    for h in (IterTimerHook(), TextLoggerHook(interval=1), JsonlLoggerHook(), Spy()):
        tr.register_hook(h)
    assert [h.priority for h in tr.hooks] == [10, 60, 85, 90]
    assert tr.run() == 4
    iters = [("before_iter", e) for e in (0, 1)]
    assert [c[0] for c in calls] == (["before_run"] + 2 * (
        ["before_epoch"] + 2 * ["before_iter", "after_iter"] + ["after_epoch"]) + ["after_run"])
    assert calls.count(iters[0]) == calls.count(iters[1]) == 2
    log = (tmp_path / "train_log.jsonl").read_text().strip().splitlines()
    assert len(log) == 4 and '"loss": 2.0' in log[-1] and '"iter_time"' in log[-1]


def test_checkpoint_hook_writes_a_loadable_pth(tmp_path):
    state = _State()
    tr = Trainer(step_fn=lambda s, b: (s, {"loss": 0.0}), state=state,
                 data_fn=lambda: iter([0]), work_dir=str(tmp_path), max_epochs=1)
    tr.register_hook(CheckpointHook(interval=1))
    tr.run()
    sd = torch.load(tmp_path / "epoch_1.pth")
    assert torch.equal(sd["weight"], state.model.weight.detach())


def test_nan_guard_saves_and_raises(tmp_path):
    losses = iter([1.0, float("nan")])
    t = Trainer(step_fn=lambda s, b: (s, {"loss": next(losses)}), state=_State(),
                data_fn=lambda: [{}, {}, {}], work_dir=str(tmp_path), max_epochs=1)
    t.register_hook(NanGuardHook())
    with pytest.raises(FloatingPointError, match="non-finite"):
        t.run()
    assert os.path.isfile(tmp_path / "rescue_nan.pth") and t.iter == 1


def _rows(n):
    return [{"det_boxes": np.full((2, 11), i, np.float32), "token": f"t{i}"} for i in range(n)]


def test_epoch_seed_hook_reshuffles():
    ds = _rows(16)
    ld = loader.DataLoader(ds, batch_size=4, num_workers=1, seed=0, prefetch=1)

    def order(epoch):
        EpochSeedHook(ld).before_epoch(type("T", (), {"epoch": epoch})())
        return [int(v) for b in ld for v in b["det_boxes"][:, 0, 0]]
    assert order(0) != order(1) and order(1) == order(1)
    assert sorted(order(2)) == list(range(16))


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_loader_matches_jax(shard):
    """The same batches as the JAX DataLoader for epochs 0 and 1 (one worker),
    over a ConcatDataset of a RepeatDataset."""
    def build(mod):
        ds = mod.ConcatDataset([mod.RepeatDataset(_rows(5), 2), _rows(7)])
        return mod.DataLoader(ds, batch_size=3, num_workers=1, seed=5, shard_id=shard[0],
                              num_shards=shard[1])
    got, want = build(loader), build(jloader)
    assert len(got) == len(want) > 0
    for epoch in (0, 1):
        got.epoch = want.epoch = epoch
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(want)
        for x, y in zip(a, b):
            assert x["token"] == y["token"]
            np.testing.assert_array_equal(x["det_boxes"], y["det_boxes"])


def test_dataset_wrappers_index_as_jax():
    parts = [_rows(3), _rows(4)]
    for mk in (lambda m: m.ConcatDataset(parts), lambda m: m.RepeatDataset(parts[1], 3)):
        got, want = mk(loader), mk(jloader)
        assert len(got) == len(want)
        negative = [-1, -len(want)] if isinstance(want, jloader.ConcatDataset) else []
        for i in list(range(len(want))) + negative:
            assert got[i]["token"] == want[i]["token"]


def test_loader_raises_the_dataset_error():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(i)
    with pytest.raises(KeyError):
        list(loader.DataLoader(Bad(), batch_size=2, num_workers=1))


def test_kernel_wrappers_refuse_autograd():
    """Each wrapper stands for a kernel with no backward: with grad mode on
    it refuses an input that requires grad, on the CPU as on the card (the
    plain version stands in for the kernel there), and runs under no_grad."""
    from shasta_tpu_torch.ops.kernels import block_conv, gather_conv, window_conv
    from shasta_tpu_torch.ops.kernels import block_extract as be
    from shasta_tpu_torch.ops.kernels import lookup

    g = torch.Generator().manual_seed(0)
    V, M, K, C = 40, 12, 27, 16
    f = torch.randn(V, C, generator=g).requires_grad_()
    w = torch.randn(K, C, C, generator=g).requires_grad_()
    idx = torch.randint(-1, V, (M, K), generator=g, dtype=torch.int32)
    keys = torch.sort(torch.randint(0, 4 * V, (V,), generator=g, dtype=torch.int32))[0]
    perm = torch.randperm(V, generator=g).to(torch.int32)
    q = torch.randint(0, 4 * V, (M, K), generator=g, dtype=torch.int32)
    calls = {"rulebook_conv": lambda: block_conv.rulebook_conv(f, idx, w),
             "gather_conv": lambda: gather_conv.gather_conv(f, idx, w),
             "keyed_conv": lambda: window_conv.keyed_conv(keys, perm, q, f, w)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        with torch.no_grad():
            assert call().shape == (M, C)
    # the refusal comes before the other checks: the lookup's int32 inputs
    # cannot require grad, so a float stand-in shows it
    with pytest.raises(RuntimeError, match="sorted_lookup has no backward"):
        lookup.sorted_lookup(keys, perm, q.float().requires_grad_(), "plain")
    assert lookup.sorted_lookup(keys, perm, q, "plain").shape == (M, K)
    with pytest.raises(RuntimeError, match="block_extract has no backward"):
        be.block_extract(*[torch.zeros(1)] * 5, torch.zeros(1, requires_grad=True),
                         torch.zeros(1), H=1, C=1, tile=128, variant="full")
