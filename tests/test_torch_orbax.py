"""tools/orbax_to_pth.py: an orbax checkpoint that the JAX package wrote,
converted into a .pth that the port serves with the JAX forward's results.

For a full ShastaModel tree and a backbone + neck (BEVMap) tree: the JAX
save_checkpoint writes the orbax directory, the converter's `main` writes
the .pth, and then
- the .pth's tensors equal load_jax_variables of the same tree, bit for bit;
- the JAX load_checkpoint of the .pth gives the original tree back exactly;
- the port model loaded from it (load_checkpoint + merge_pretrained, as
  the CLIs load) equals the JAX forward: the two-frame forward's
  matched1/2 at 1e-4 (as tests/test_torch_forward.py), BEVMap's map at
  the trunk tolerance (atol 2e-3 / rtol 1e-3, tests/test_block_conv.py:127).
"""
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
from shasta_tpu.models.bevmap import BEVMap as JBEVMap
from shasta_tpu.train import checkpoint as jckpt

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch, write_split_config
from shasta_tpu_torch.models import BEVMap, ShastaConfig, ShastaModel
from shasta_tpu_torch.train.checkpoint import load_checkpoint, merge_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_pth", os.path.join(REPO, "tools", "orbax_to_pth.py"))
orbax_to_pth = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_pth)

CFG = dict(max_obj=6, grid_shape=(41, 48, 48), pc_start=(-3.0, -3.0),
           cap_conv2=8192, cap_conv3=8192, cap_conv4=2048, cap_extra=1024)


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """A config file whose model section is CFG (the converter's --config)."""
    out = str(tmp_path_factory.mktemp("cfg") / "small.py")
    return write_split_config(os.path.join(REPO, "configs", "nusc", "car.py"), {}, out,
                              model={k: list(v) if isinstance(v, tuple) else v
                                     for k, v in CFG.items()})


def _convert(tree, tmp_path, config):
    """The tree saved by the JAX package's orbax save_checkpoint, then the
    converter: (model type, .pth path)."""
    ckpt = str(tmp_path / "epoch_1")
    jckpt.save_checkpoint(ckpt, jax.tree.map(jnp.asarray, tree))
    out = str(tmp_path / "epoch_1.pth")
    kind = orbax_to_pth.main(["--checkpoint", ckpt, "--out", out, "--config", config])
    return kind, out


def _same_tensors_as_load_jax_variables(model, tree, path):
    load_jax_variables(model, tree)
    written = torch.load(path, map_location="cpu", weights_only=True)
    want = model.state_dict()
    assert written.keys() == want.keys()
    for k in want:
        assert torch.equal(written[k], want[k]), k


def test_full_tree_converts_and_serves(tmp_path, config):
    ref = ShastaModel(ShastaConfig(**CFG), device="cpu")
    tree = random_jax_variables(ref, seed=11)
    kind, path = _convert(tree, tmp_path, config)
    assert kind == "ShastaModel"
    _same_tensors_as_load_jax_variables(ref, tree, path)
    _assert_tree_equal(jckpt.load_checkpoint(path), tree)

    model = ShastaModel(ShastaConfig(**CFG), device="cpu")
    model.load_state_dict(merge_pretrained(model.state_dict(), load_checkpoint(path)))
    batch = make_batch(model.cfg, 1, 512, n_dets=4, seed=3)
    jm1, jm2 = jax.jit(JModel(JConfig(**CFG)).apply)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        m1, m2 = model(batch)
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm1), atol=1e-4)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), atol=1e-4)
    assert np.abs(np.asarray(jm1) - 1 / (CFG["max_obj"] + 2)).max() > 1e-2  # not uniform


def test_trunk_tree_converts_to_a_bevmap(tmp_path, config):
    ref = BEVMap(ShastaConfig(**CFG), device="cpu")
    tree = random_jax_variables(ref, seed=12)
    kind, path = _convert(tree, tmp_path, config)
    assert kind == "BEVMap"
    _same_tensors_as_load_jax_variables(ref, tree, path)
    _assert_tree_equal(jckpt.load_checkpoint(path), tree)

    bev = BEVMap(ShastaConfig(**CFG), device="cpu")
    bev.load_state_dict(load_checkpoint(path), strict=True)
    frame = {k: v for k, v in make_batch(bev.cfg, 1, 512, n_dets=4, seed=4).items()
             if k in ("voxels", "num_points", "coordinates", "voxels_valid")}
    want = jax.jit(JBEVMap(JConfig(**CFG)).apply)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in frame.items()})
    with torch.no_grad():
        got = bev(frame)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_converter_refuses_a_file_and_the_port_names_it(tmp_path):
    """The converter takes an orbax directory; the port's loader refuses a
    directory and names the converter."""
    f = tmp_path / "x.pth"
    f.write_bytes(b"")
    with pytest.raises(SystemExit, match="orbax"):
        orbax_to_pth.main(["--checkpoint", str(f), "--out", str(tmp_path / "y.pth")])
    with pytest.raises(ValueError, match="orbax_to_pth"):
        load_checkpoint(str(tmp_path))
