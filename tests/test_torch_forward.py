"""The port's two-frame forward against the JAX ShastaModel.__call__ (CPU,
f32, the JAX XLA path).

On `make_batch` pairs (curr and prev_* frames) the port's `bev_maps` runs
both frames as one sparse batch of 2B through the unplanned trunk, and
`forward` samples each frame's boxes on its own map and runs the affinity
head. Held to the trunk tolerance for the BEV maps (atol 2e-3 / rtol 1e-3,
tests/test_block_conv.py:127) and 1e-4 for matched1/matched2; the caps
are set above every stage's set, so the 2B batch truncates nothing, and
each frame's descriptors then equal `frame_features` of that frame alone.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.models import ShastaConfig, ShastaModel

CFG = dict(max_obj=6, grid_shape=(41, 48, 48), pc_start=(-3.0, -3.0),
           cap_conv2=8192, cap_conv3=8192, cap_conv4=2048, cap_extra=1024)


@pytest.fixture(scope="module")
def models():
    model = ShastaModel(ShastaConfig(**CFG), device="cpu")
    variables = random_jax_variables(model, seed=2)
    load_jax_variables(model, variables)
    return model, JModel(JConfig(**CFG)), jax.tree.map(jnp.asarray, variables)


@pytest.mark.parametrize("pairs", [1, 2])
def test_forward_matches_jax_call(models, pairs):
    model, jmodel, jvars = models
    batch = make_batch(model.cfg, pairs, 512, n_dets=4, seed=pairs)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        bev, prev_bev = model.bev_maps({k: torch.as_tensor(v) for k, v in batch.items()})
        m1, m2 = model(batch)
    jbev, jprev = jmodel.apply(jvars, jbatch, method=JModel.bev_maps)
    jm1, jm2 = jmodel.apply(jvars, jbatch)
    N = model.cfg.max_obj
    assert bev.shape == prev_bev.shape == jbev.shape and bev.shape[0] == pairs
    assert m1.shape == (pairs, N, N + 2) and m2.shape == (pairs, N + 2, N)
    for got, want in ((bev, jbev), (prev_bev, jprev)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)
        assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(m1.numpy(), np.asarray(jm1), atol=1e-4)
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm2), atol=1e-4)
    np.testing.assert_allclose(m1.sum(2).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(m2.sum(1).numpy(), 1.0, atol=1e-5)


def test_forward_descriptors_equal_each_frame_alone(models):
    """The curr and the prev half of the 2B batch give the BEV maps of
    `bev_single` on that frame alone (1e-5: the same convs over the same
    rows)."""
    model, _, _ = models
    batch = make_batch(model.cfg, 1, 512, n_dets=4, seed=7)
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        bev, prev_bev = model.bev_maps(t)
        for got, p in ((bev, ""), (prev_bev, "prev_")):
            alone = model.bev_single({k: t[p + k] for k in ("voxels", "num_points",
                                                           "coordinates", "voxels_valid")})
            np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=1e-5, rtol=1e-5)
