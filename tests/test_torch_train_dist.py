"""Data parallelism of the port's train step over torch.distributed: two
gloo processes on the CPU, each with its half of the batch, take one cached
step. It must equal the JAX package's step over a 2-device mesh
(make_train_step(mesh=make_mesh(2)), the conftest's fake CPU devices):
loss at rtol 1e-5, parameters within 2*lr; the two ranks' parameters are
bit-equal. In the same processes a SparseBN with sync (the config's
bn_axis_name) in train mode over each rank's half of the rows equals one
process's over all of them (rtol 1e-6). The spawn has its own time limit.
"""
import os
import socket

import numpy as np
import torch
import torch.multiprocessing as mp

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.models.backbone import SparseBN
from shasta_tpu_torch.parallel import dist as pdist
from shasta_tpu_torch.train import loop

CFG = dict(max_obj=6, grid_shape=(41, 48, 48))
LR, WD, WORLD, B = 1e-3, 1e-2, 2, 4
SPAWN_TIMEOUT_S = 120


def _data():
    cfg = ShastaConfig(**CFG)
    b = make_batch(cfg, B, 64, n_dets=5, with_gt=True, seed=3)
    rng = np.random.default_rng(4)
    F = cfg.num_point * cfg.share_conv_channel
    batch = {k: b[k] for k in ("det_boxes", "prev_det_boxes", "gt")}
    batch.update(feat=rng.normal(0, 1, (B, cfg.max_obj, F)).astype(np.float32),
                 prev_feat=rng.normal(0, 1, (B, cfg.max_obj, F)).astype(np.float32))
    rows = rng.normal(1.0, 2.0, (2 * 50, 8)).astype(np.float32)
    valid = rng.random(2 * 50) < 0.8
    return batch, rows, valid


def _rank(rank, port, out_dir):
    """One rank: join the group from torchrun's variables, one cached step
    on this rank's half of the batch, one synced SparseBN pass."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    assert pdist.init_from_env("cpu").type == "cpu" and pdist.world_size() == WORLD
    model = ShastaModel(ShastaConfig(**CFG), device="cpu")
    load_jax_variables(model, random_jax_variables(model, seed=6))
    tx = loop.make_optimizer(model, LR, WD)
    state = loop.create_train_state(model, tx)
    batch, rows, valid = _data()
    h = B // WORLD
    mine = {k: v[rank * h:(rank + 1) * h] for k, v in batch.items()}
    state, m = loop.make_train_step(model, tx, cached=True)(state, mine)
    bn = SparseBN(rows.shape[1], sync=True).train()
    n = rows.shape[0] // WORLD
    with torch.no_grad():
        bn(torch.as_tensor(rows[rank * n:(rank + 1) * n]),
           torch.as_tensor(valid[rank * n:(rank + 1) * n]))
    torch.save({"sd": model.state_dict(), "loss": float(m["loss"]),
                "bn": (bn.running_mean, bn.running_var)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    pdist.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_the_jax_mesh_step(tmp_path):
    import jax
    import jax.numpy as jnp

    from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
    from shasta_tpu.parallel import make_mesh
    from shasta_tpu.train import loop as jloop

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(tmp_path))) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPAWN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, f"a rank outlived {SPAWN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD))
    assert r0["loss"] == r1["loss"]
    for k in r0["sd"]:
        assert torch.equal(r0["sd"][k], r1["sd"][k]), k

    model = ShastaModel(ShastaConfig(**CFG), device="cpu")
    tree = random_jax_variables(model, seed=6)
    load_jax_variables(model, tree)
    assert not torch.equal(r0["sd"]["aff.0.weight"], model.state_dict()["aff.0.weight"])
    jmodel = JModel(JConfig(**CFG))
    jvars = jax.tree.map(jnp.asarray, tree)
    jtx = jloop.make_optimizer(LR, WD, True, params=jvars["params"])
    batch, rows, valid = _data()
    step = jloop.make_train_step(jmodel, jtx, mesh=make_mesh(WORLD), donate=False, cached=True)
    js, m = step(jloop.create_train_state(jmodel, jvars, jtx),
                 {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(r0["loss"], float(m["loss"]), rtol=1e-5)
    load_jax_variables(model, jax.tree.map(np.asarray, {"params": js.params,
                                                        "batch_stats": js.batch_stats}))
    want = model.state_dict()
    for k, v in r0["sd"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2 * LR, rtol=0, err_msg=k)
    one = SparseBN(rows.shape[1]).train()
    with torch.no_grad():
        one(torch.as_tensor(rows), torch.as_tensor(valid))
    for got, exp in zip(r0["bn"], (one.running_mean, one.running_var)):
        torch.testing.assert_close(got, exp, rtol=1e-6, atol=0)
    for a, b in zip(r0["bn"], r1["bn"]):
        assert torch.equal(a, b)
