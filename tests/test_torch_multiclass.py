"""The port's fused multi-class step against the JAX package (CPU, f32).

- `pad_affinity_params` equals the JAX transform array for array (exact);
- a padded head equals the original and the class-stacked head equals the
  per-class heads at 1e-5 (the cases of tests/test_multiclass_vmap.py);
- `MultiClassScenePipeline` equals the JAX one (its XLA path,
  use_pallas_gather=False), on frames with host plans attached and
  without (then no host planner runs), on the configuration of
  tests/test_multiclass_pipeline.py:12-16 with 3 classes (car 6,
  pedestrian 6, bus 5) over 3 frames, bus absent on the second: ids, used,
  keep and FN exact, refined scores to 1e-4; and each class present on
  every frame equals a port ScenePipeline of that class alone, ids up to
  the class-major rebase.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.infer import MultiClassScenePipeline as JMulti
from shasta_tpu.infer import default_tracker_params as jparams
from shasta_tpu.models import ShastaConfig as JConfig, ShastaModel as JModel
from shasta_tpu.multiclass import pad_affinity_params as jpad

from shasta_tpu_torch.convert import (class_models_from_jax, load_jax_variables,
                                      random_jax_variables)
from shasta_tpu_torch.data.synthetic import make_batch
from shasta_tpu_torch.infer import MultiClassScenePipeline, ScenePipeline
from shasta_tpu_torch.models import AffinityNet, ShastaConfig, ShastaModel
from shasta_tpu_torch.multiclass import (head_state, pad_affinity_params, pad_rows,
                                         stack_class_heads)
from shasta_tpu_torch.plans import attach_plans, frame_plans
from shasta_tpu_torch.tracker.pub_tracker import NUSCENES_TRACKING_NAMES

MINI = dict(grid_shape=(41, 48, 48), pc_start=(-3.0, -3.0), cap_conv2=512,
            cap_conv3=256, cap_conv4=128, cap_extra=128)
CLASSES = {"car": 6, "pedestrian": 6, "bus": 5}
FIELDS = ("tid", "used", "keep", "fn")


def _model(max_obj, seed=0):
    m = ShastaModel(ShastaConfig(max_obj=max_obj, **MINI), device="cpu")
    tree = random_jax_variables(m, seed=seed)
    load_jax_variables(m, tree)
    return m, tree


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_pad_affinity_params_equals_the_jax_transform(kind):
    """A random max_obj=5 head padded to 9: the port's transform on the
    port's state_dict (torch tensors or numpy arrays) against the JAX
    transform on the JAX tree, carried into the port's layout."""
    small, tree = _model(5, seed=4)
    big = ShastaModel(ShastaConfig(max_obj=9, **MINI), device="cpu")
    want_tree = random_jax_variables(big, seed=5)
    want_tree["params"]["affinity"] = jax.tree.map(
        np.asarray, jpad(tree["params"]["affinity"], 5, 9))
    load_jax_variables(big, want_tree)
    want = head_state(big.state_dict())
    src = head_state(small.state_dict())
    if kind == "numpy":
        src = {k: v.numpy() for k, v in src.items()}
    got = pad_affinity_params(src, 5, 9)
    assert set(got) == set(want)
    for k in want:
        g = got[k] if kind == "numpy" else got[k].numpy()
        assert g.shape == tuple(want[k].shape), k
        np.testing.assert_array_equal(g, want[k].numpy(), err_msg=k)


def _head_inputs(rng, N, B=1):
    def boxes():
        b = rng.normal(size=(B, N, 7)).astype(np.float32)
        b[..., 3:6] = np.abs(b[..., 3:6]) + 0.5  # positive dims: log(dims)
        return b

    return (boxes(), boxes(), rng.normal(size=(B, N, 2)).astype(np.float32),
            np.full((B, N, 1), 0.5, np.float32),
            rng.normal(size=(B, N, 320)).astype(np.float32),
            rng.normal(size=(B, N, 320)).astype(np.float32))


def _run(head, inputs, **kw):
    with torch.no_grad():
        return [t.numpy() for t in head(*(torch.as_tensor(a) for a in inputs), **kw)]


def _assert_real_slots_equal(m1p, m2p, m1, m2, n, N):
    """matched1 rows [0, n) over cols [0, n) and the anchors, matched2 cols
    [0, n) over rows [0, n) and the anchors; padded slots carry no mass."""
    kw = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m1p[:n, :n], m1[:, :n], **kw)
    np.testing.assert_allclose(m1p[:n, N:], m1[:, n:], **kw)
    np.testing.assert_allclose(m2p[:n, :n], m2[:n, :], **kw)
    np.testing.assert_allclose(m2p[N:, :n], m2[n:, :], **kw)
    assert not m1p[:n, n:N].any() and not m2p[n:N, :n].any()


def test_padded_head_equals_the_original(rng):
    small, _ = _model(5, seed=6)
    padded = AffinityNet(max_obj=9)
    padded.load_state_dict(pad_affinity_params(head_state(small.state_dict()), 5, 9))
    inputs = _head_inputs(rng, 5)
    m1, m2 = _run(small.head, inputs)
    m1p, m2p = _run(padded, [pad_rows(a, 9) for a in inputs], n_real=5)
    _assert_real_slots_equal(m1p[0], m2p[0], m1[0], m2[0], 5, 9)


def test_class_stacked_head_equals_the_per_class_heads(rng):
    """Three heads of max_obj 5, 6 and 9 as one class-stacked head with
    n_real (3,): every class equals its own head."""
    widths = (5, 6, 9)
    models = {f"c{i}": _model(n, seed=10 + i)[0] for i, n in enumerate(widths)}
    names = tuple(models)
    stacked, n_real = stack_class_heads(models, names, 9)
    assert n_real.tolist() == list(widths)
    head = AffinityNet(max_obj=9, classes=3)
    head.load_state_dict(stacked)
    inputs = {n: _head_inputs(rng, w) for n, w in zip(names, widths)}
    batched = [np.concatenate([pad_rows(inputs[n][j], 9) for n in names]) for j in range(6)]
    m1s, m2s = _run(head, batched, n_real=n_real)
    for i, (n, w) in enumerate(zip(names, widths)):
        m1, m2 = _run(models[n].head, inputs[n])
        _assert_real_slots_equal(m1s[i], m2s[i], m1[0], m2[0], w, 9)


def test_class_models_share_the_trunk_of_the_trunk_key():
    trees = {n: random_jax_variables(ShastaModel(ShastaConfig(max_obj=w, **MINI),
                                                 device="cpu"), seed=20 + i)
             for i, (n, w) in enumerate(CLASSES.items())}
    cfgs = {n: ShastaConfig(max_obj=w, **MINI) for n, w in CLASSES.items()}
    models = class_models_from_jax(cfgs, trees)
    car = models["car"].state_dict()
    for n, m in models.items():
        sd = m.state_dict()
        assert m.device.type == "cpu"
        for k in sd:
            if k.startswith(("backbone.", "neck.", "shared_conv.")):
                assert torch.equal(sd[k], car[k]), (n, k)
        # the head is the class's own
        want = trees[n]["params"]["affinity"]["aff"]["layers_5"]["kernel"]
        np.testing.assert_array_equal(sd["aff.10.weight"].numpy(), want.T)


def _scene(T=3, seed=0):
    """T frames of one scene: shared voxels, per-class boxes that move
    along their velocity; bus absent on the second frame."""
    rng = np.random.default_rng(seed)
    base = make_batch(ShastaConfig(max_obj=6, **MINI), 1, 512, n_dets=4, seed=seed)
    boxes, counts = {}, {"car": 4, "pedestrian": 5, "bus": 3}
    for i, (n, w) in enumerate(CLASSES.items()):
        b = make_batch(ShastaConfig(max_obj=w, **MINI), 1, 16, n_dets=counts[n],
                       seed=seed + 1 + i)["det_boxes"].copy()
        b[0, :counts[n], :2] = rng.uniform(-2.8, 0.4, (counts[n], 2))
        boxes[n] = b
    frames = []
    for t in range(T):
        frame = {k: base[k] for k in ("voxels", "num_points", "coordinates", "voxels_valid")}
        frame["voxels"] = frame["voxels"] + np.float32(0.05 * t)
        cb = {}
        for n, b in boxes.items():
            k = counts[n]
            b[0, :k, :2] += b[0, :k, 7:9] * 0.2 + rng.normal(0, 0.05, (k, 2))
            if not (n == "bus" and t == 1):
                cb[n] = (b.copy(), k - (n == "pedestrian" and t == 2))
        frames.append((frame, cb))
    return frames


@pytest.fixture(scope="module")
def multiclass():
    """Port class models (on the CPU) and the JAX class heads on one set
    of random trees, the trunk from car's."""
    cfgs = {n: ShastaConfig(max_obj=w, **MINI) for n, w in CLASSES.items()}
    trees = {n: random_jax_variables(ShastaModel(cfgs[n], device="cpu"), seed=30 + i)
             for i, n in enumerate(CLASSES)}
    models = class_models_from_jax(cfgs, trees)
    jheads = {}
    for n, w in CLASSES.items():
        tree = {col: dict(trees[n][col]) for col in ("params", "batch_stats")}
        for col in tree:
            tree[col].update({p: trees["car"][col][p] for p in ("backbone", "neck",
                                                                "shared_conv")
                              if p in trees["car"][col]})
        jheads[n] = (JModel(JConfig(max_obj=w, **MINI)), jax.tree.map(jnp.asarray, tree))
    return models, jheads


@pytest.mark.parametrize("plans", ["attached", "none"])
def test_multiclass_pipeline_matches_jax(multiclass, plans):
    models, jheads = multiclass
    pipe = MultiClassScenePipeline(models, trunk_key="car", device="cpu")
    jpipe = JMulti(class_heads=jheads, trunk_key="car", params=jparams(max_age=4))
    seen = set()
    for t, (frame, cb) in enumerate(_scene()):
        port_frame = frame
        if plans == "attached":
            port_frame = attach_plans(frame, frame_plans(
                frame["coordinates"][0], frame["voxels_valid"][0], models["car"].cfg))
        calls = frame_plans.calls
        got = pipe.step_frame(port_frame, cb, 0.5)
        assert frame_plans.calls == calls  # the step plans nothing itself
        want = jpipe.step_frame(frame, cb, 0.5)
        assert set(got) == set(want) == set(cb)
        ids = []
        for n in got:
            assert got[n].tid.shape == (2 * CLASSES[n],) and got[n].coverage_ok
            for field in FIELDS:
                np.testing.assert_array_equal(getattr(got[n], field), getattr(want[n], field),
                                              err_msg=f"{n} {field} frame {t}")
            np.testing.assert_allclose(got[n].ref, want[n].ref, atol=1e-4,
                                       err_msg=f"{n} frame {t}")
            ids += got[n].tid[got[n].used].tolist()
        assert len(ids) == len(set(ids)) and min(ids) >= 1  # unique across classes
        seen |= set(ids)
    assert len(seen) > 6


def test_multiclass_classes_match_single_class_pipelines(multiclass):
    """Car and pedestrian (present on every frame, max_obj = N_max) against
    a ScenePipeline of that class alone: used, keep, FN exact, ref to
    1e-4, and the ids one consistent relabelling of the single run's."""
    models, _ = multiclass
    pipe = MultiClassScenePipeline(models, trunk_key="car", device="cpu")
    # class_models_from_jax gave every class car's trunk
    singles = {n: ScenePipeline(models[n], cls_id=NUSCENES_TRACKING_NAMES.index(n))
               for n in ("car", "pedestrian")}
    relabel = {n: {} for n in singles}
    for frame, cb in _scene():
        got = pipe.step_frame(frame, cb, 0.5)
        for n, single in singles.items():
            s = single.step_frame(dict(frame, det_boxes=cb[n][0]), cb[n][1], 0.5)
            g = got[n]
            for field in ("used", "keep", "fn"):
                np.testing.assert_array_equal(getattr(g, field), getattr(s, field))
            np.testing.assert_allclose(g.ref, s.ref, atol=1e-4)
            for a, b in zip(s.tid[s.used], g.tid[g.used]):
                assert relabel[n].setdefault(int(a), int(b)) == b, (n, a, b)
    for n in relabel:
        assert len(set(relabel[n].values())) == len(relabel[n]) > 0
