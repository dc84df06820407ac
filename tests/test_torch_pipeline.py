"""The port's serving step against the JAX ScenePipeline (CPU, f32), plus
the port's import and device rules.

The JAX side runs its XLA path (use_pallas_gather=False) without plans;
the port runs its kernels' plain versions, on frames with host plans
attached (the planned route) or without (every index built on the
device, and no host planner call). Ids, used, keep and FN flags must
match exactly; refined scores to 1e-4. The port's two routes agree with
each other: ids exact, BEV maps at the trunk tolerance (atol 2e-3 / rtol
1e-3, tests/test_block_conv.py:127).
"""
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.infer import ScenePipeline as JPipeline
from shasta_tpu.infer import default_tracker_params as jparams
from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel

from shasta_tpu_torch import resolve_device
from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.infer import ScenePipeline
from shasta_tpu_torch.models import ShastaConfig, ShastaModel
from shasta_tpu_torch.plans import attach_plans, frame_plans

SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
             cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)


def _scene(cfg, T=3):
    """T frames of one scene: frames share most voxels and carry their dets
    forward; one det fewer on the last."""
    base = make_batch(cfg, num_voxels_cap=2500, n_dets=7, seed=0)
    rng = np.random.default_rng(0)
    boxes = base["det_boxes"].copy()
    boxes[0, :7, :2] = rng.uniform(-2.5, 2.5, (7, 2))
    frames = []
    for t in range(T):
        frame = {k: base[k] for k in ("voxels", "num_points", "coordinates",
                                      "voxels_valid")}
        frame["voxels"] = frame["voxels"] + np.float32(0.05 * t)
        boxes[0, :7, :2] += boxes[0, :7, 7:9] * 0.5 + rng.normal(0, 0.05, (7, 2))
        frame["det_boxes"] = boxes.copy()
        frames.append((frame, 7 - (t == T - 1)))
    return frames


def _with_plans(frame, cfg):
    return attach_plans(frame, frame_plans(frame["coordinates"][0], frame["voxels_valid"][0],
                                           cfg))


@pytest.fixture(scope="module")
def small():
    model = ShastaModel(ShastaConfig(**SMALL), device="cpu")
    variables = random_jax_variables(model, seed=1)
    load_jax_variables(model, variables)
    return model, variables


@pytest.mark.parametrize("plans", ["attached", "none"])
def test_step_frame_matches_jax_pipeline(small, plans):
    model, variables = small
    pipe = ScenePipeline(model, cls_id=2)
    jpipe = JPipeline(model=JModel(JConfig(**SMALL)),
                      variables=jax.tree.map(jnp.asarray, variables),
                      cls_id=2, params=jparams(max_age=4))
    frame_plans.calls = 0
    for frame, n in _scene(model.cfg):
        port_frame = _with_plans(frame, model.cfg) if plans == "attached" else frame
        calls = frame_plans.calls
        got = pipe.step_frame(port_frame, n, 0.5)
        assert frame_plans.calls == calls  # the step plans nothing itself
        want = jpipe.step_frame(frame, n, 0.5)
        np.testing.assert_array_equal(got.tid, want.tid)
        np.testing.assert_array_equal(got.used, want.used)
        np.testing.assert_array_equal(got.keep, want.keep)
        np.testing.assert_array_equal(got.fn, want.fn)
        np.testing.assert_allclose(got.ref, want.ref, atol=1e-4)
        assert got.tid.min() >= 0 and got.tid.max() >= 1
    assert frame_plans.calls == (3 if plans == "attached" else 0)


def test_unplanned_step_matches_the_planned_step(small):
    """The B=1 step without plans (sorted_lookup + gather_conv) against the
    planned route (rulebook_conv + keyed_conv): BEV maps at the trunk
    tolerance, every output exact (ref to 1e-5)."""
    model, _ = small
    frames = _scene(model.cfg)
    with torch.no_grad():
        t = {k: torch.as_tensor(v) for k, v in frames[0][0].items()}
        planned = model.bev_single({k: torch.as_tensor(v) for k, v in
                                    _with_plans(frames[0][0], model.cfg).items()})
        unplanned = model.bev_single(t)
    np.testing.assert_allclose(unplanned.numpy(), planned.numpy(), atol=2e-3, rtol=1e-3)
    a, b = ScenePipeline(model, cls_id=2), ScenePipeline(model, cls_id=2)
    for frame, n in frames:
        got, want = a.step_frame(frame, n, 0.5), b.step_frame(_with_plans(frame, model.cfg), n,
                                                              0.5)
        for field in ("tid", "used", "keep", "fn"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        np.testing.assert_allclose(got.ref, want.ref, atol=1e-5)
        assert got.used.any()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, shasta_tpu_torch, shasta_tpu_torch.infer, "
            "shasta_tpu_torch.convert, shasta_tpu_torch.ops.kernels.build, "
            "shasta_tpu_torch.ops.kernels.lookup, shasta_tpu_torch.ops.kernels.gather_conv, "
            "shasta_tpu_torch.profile_step, shasta_tpu_torch.probe_block_conv, "
            "shasta_tpu_torch.multiclass, shasta_tpu_torch.ops.kernels.block_extract, "
            "shasta_tpu_torch.probe_b1_routes, shasta_tpu_torch.ops.voxelize, "
            "shasta_tpu_torch.ops.nms, shasta_tpu_torch.core.geometry, "
            "shasta_tpu_torch.core.transforms\n"
            "from shasta_tpu_torch.infer import BatchedScenePipeline, MultiClassScenePipeline\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'shasta_tpu')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        ShastaModel(ShastaConfig(**SMALL))
    assert resolve_device("cpu").type == "cpu"


def test_device_constants_are_made_once_and_keep_their_values():
    from shasta_tpu_torch.device import const, upload
    from shasta_tpu_torch.plans import tap_offsets

    a = const((41, 1440, 1440), "cpu")
    assert a is const([41, 1440, 1440], "cpu") and a.dtype == torch.int64
    assert const((1, 2), "cpu") is not const((1.0, 2.0), "cpu")
    assert const((1.0, 2.0), "cpu").dtype == torch.float32
    off = tap_offsets((3, 3, 3), True)
    assert torch.equal(const(off, "cpu"), torch.as_tensor(off))
    assert const(off, "cpu", torch.int32).dtype == torch.int32
    up = upload(np.arange(3, dtype=np.float32), "cpu")
    assert up.device.type == "cpu" and up.tolist() == [0.0, 1.0, 2.0]
