"""The port's dataset serving against the JAX package's (CPU, f32): the
checkpoint loader, track_scene_dataset, the two serving CLIs and
eval_tracking_lite, on the micro tree of tests/fixtures_nusc.py after the
JAX preprocessing chain.

One random port state_dict, saved as a .pth, gives both sides their weights
(the JAX side through its own load_checkpoint + merge_pretrained); a
trunk-only subset of another, under DDP names in a {"state_dict": ...}
wrapper, stands in for bev_map.pth. Tracking results must hold the same
tokens and, per annotation, identical ids, names and boxes, with
tracking_score within atol 1e-4 (the step tolerance of
tests/test_torch_pipeline.py).
"""
import json
import os
import sys
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures_nusc import build_micro_nusc
from shasta_tpu.data.nuscenes import NuScenesTrackDataset as JDataset
from shasta_tpu.data.nuscenes import PointPipelineConfig as JPointPipeline
from shasta_tpu.data.synthetic import make_batch as jmake_batch
from shasta_tpu.infer import ScenePipeline as JPipeline
from shasta_tpu.infer import default_tracker_params as jparams
from shasta_tpu.infer import track_scene_dataset as jtrack_scene_dataset
from shasta_tpu.models import ShastaModel as JModel
from shasta_tpu.preprocessing.nuscenes_chain import run_chain
from shasta_tpu.tracker.runner import eval_tracking_lite as jeval_tracking_lite
from shasta_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from shasta_tpu.train.checkpoint import merge_pretrained as jmerge_pretrained
from shasta_tpu.utils import Config as JConfig

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.infer import track_scene_dataset
from shasta_tpu_torch.tools import track_scene
from shasta_tpu_torch.tools.common import build_dataset, build_model, build_pipeline, load_model
from shasta_tpu_torch.tools.track_multiclass import run_multiclass
from shasta_tpu_torch.tracker.runner import eval_tracking_lite
from shasta_tpu_torch.train.checkpoint import (load_checkpoint, merge_pretrained,
                                               save_checkpoint)
from shasta_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from track_multiclass import run_multiclass as jrun_multiclass  # noqa: E402
from train import build_model as jbuild_model  # noqa: E402

CFG = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {configs!r})
    from _base import *  # noqa

    det_type = [{cls!r}]
    max_objects = {n}
    model = dict(model, max_obj={n}, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
                 cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)
    point_pipeline = dict(point_pipeline, voxel_size=(0.075, 0.075, 0.05),
                          pc_range=(-3.0, -3.0, -1.0, 3.0, 3.0, 1.0), max_voxels=4000, nsweeps=1)
    data = dict(data, val=dict(info_path={infos!r}, det_path={split!r} + "/detections/cp/sensor_individual_frames",
                               cls_info_path={split!r} + "/detections/cp/cls_individual_frames",
                               frame_info_path={frame_info!r}, test_mode=True))
""")


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_init():
    """The JAX tools initialise their model eagerly, op by op (about a
    minute on the CPU); jitted, init takes seconds. Every value it makes is
    replaced by the full checkpoint each JAX run loads next."""
    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda *a: nn.Module.init(self, rngs, *a, **kwargs))(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JModel, "init", init)
        yield


def _random_state_dict(cfg, seed):
    model = build_model(cfg, "cpu")
    load_jax_variables(model, random_jax_variables(model, seed=seed))
    return model.state_dict()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    fx = build_micro_nusc(tmp)
    out = tmp / "prep"
    run_chain(dataroot=str(fx["root"]), version="v1.0-mini", results_json=str(fx["results"]),
              out_dir=str(out), split="val", scene_names=None)
    fmt = dict(configs=os.path.join(REPO, "configs", "nusc"), infos=str(fx["infos"]),
               split=str(out / "val_2hz"), frame_info=str(out / "val_frame_info.json"))
    cfgs = {}
    for cls, n in (("car", 6), ("bus", 5)):
        cfgs[cls] = tmp / f"micro_{cls}.py"
        cfgs[cls].write_text(CFG.format(cls=cls, n=n, **fmt))
    car = Config.fromfile(str(cfgs["car"]))
    full = tmp / "shasta.pth"
    save_checkpoint(str(full), _random_state_dict(car, seed=1))
    bev = tmp / "bev_map.pth"
    trunk = {f"module.{k}": v for k, v in _random_state_dict(car, seed=2).items()
             if k.split(".")[0] in ("backbone", "neck")}
    torch.save({"state_dict": trunk}, bev)
    bus = tmp / "bus.pth"
    save_checkpoint(str(bus), _random_state_dict(Config.fromfile(str(cfgs["bus"])), seed=3))
    return dict(tmp=tmp, cfgs=cfgs, full=str(full), bev=str(bev), bus=str(bus),
                gt_info=str(out / "val_2hz" / "gt_info" / "individual_frames"))


def _jax_track_scene(cfg_path, checkpoints):
    """What tools/track_scene.py does, with checkpoints merged in order."""
    cfg = JConfig.fromfile(cfg_path)
    model, mc = jbuild_model(cfg)
    pp = dict(cfg.point_pipeline, shuffle_points=False)
    ds = JDataset(**dict(cfg.data.val), det_type=list(cfg.det_type),
                  max_objects=cfg.max_objects, pipeline=JPointPipeline(**pp))
    one = {k: jnp.asarray(v) for k, v in
           jmake_batch(mc, batch_size=1, num_voxels_cap=pp["max_voxels"], n_dets=4).items()}
    variables = model.init(jax.random.PRNGKey(0), one, train=False)
    for path in checkpoints:
        variables = jmerge_pretrained(variables, jload_checkpoint(path))
    pipe = JPipeline(model=model, variables=variables, cls_id=2,
                     params=jparams(max_age=cfg.max_age), fp_thresh=cfg.get("fp_elim", 0.7),
                     decision_thresh=cfg.get("decision_thresh", 0.5))
    return jtrack_scene_dataset(pipe, ds)


def _assert_same_result(got, want):
    assert got["meta"] == want["meta"]
    assert list(got["results"]) == list(want["results"])
    n = 0
    for tok, w_annos in want["results"].items():
        g_annos = got["results"][tok]
        assert len(g_annos) == len(w_annos), tok
        for g, w in zip(g_annos, w_annos):
            assert g.keys() == w.keys()
            for k in w:
                if k == "tracking_score":
                    assert abs(g[k] - w[k]) <= 1e-4, (tok, g[k], w[k])
                else:
                    assert g[k] == w[k], (tok, k, g[k], w[k])
            n += 1
    return n


@pytest.fixture(scope="module")
def jax_result(tree):
    return _jax_track_scene(str(tree["cfgs"]["car"]), [tree["full"], tree["bev"]])


def test_checkpoint_loading_matches_the_files(tree):
    """The full checkpoint fills every part; bev_map.pth (DDP names, wrapped)
    fills backbone and neck alone; a directory (orbax) is refused."""
    cfg = Config.fromfile(str(tree["cfgs"]["car"]))
    full = torch.load(tree["full"])
    bev = {k.removeprefix("module."): v for k, v in torch.load(tree["bev"])["state_dict"].items()}
    assert set(load_checkpoint(tree["bev"])) == set(bev)
    model = load_model(cfg, tree["full"], "cpu")
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in full.items())
    model.load_state_dict(merge_pretrained(sd, load_checkpoint(tree["bev"])))
    sd = model.state_dict()
    for k, v in sd.items():
        want = bev[k] if k in bev else full[k]
        assert torch.equal(v, want), k
    assert any(k.startswith("shared_conv") for k in full) and not any(
        k.startswith(("shared_conv", "aff")) for k in bev)
    # a tensor of another shape is not merged
    odd = merge_pretrained(sd, {"shared_conv.0.bias": torch.zeros(3)})
    assert odd["shared_conv.0.bias"] is sd["shared_conv.0.bias"]
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tree["tmp"]))


def test_spconv_native_layout_loads_as_dense(tree, tmp_path):
    """Sparse-conv weights in spconv 2.x's (out, kz, ky, kx, in) load into
    the port's (kz, ky, kx, in, out), as the JAX converter accepts both."""
    full = torch.load(tree["full"])
    native = {k: (v.permute(4, 0, 1, 2, 3).contiguous()
                  if k.startswith("backbone.") and v.dim() == 5 else v)
              for k, v in full.items()}
    assert any(native[k].shape != full[k].shape for k in full)
    path = tmp_path / "native.pth"
    torch.save(native, path)
    got = load_checkpoint(str(path))
    assert all(torch.equal(got[k], full[k]) for k in got)


def test_track_scene_dataset_matches_jax(tree, jax_result):
    cfg = Config.fromfile(str(tree["cfgs"]["car"]))
    model = load_model(cfg, tree["full"], "cpu")
    model.load_state_dict(merge_pretrained(model.state_dict(), load_checkpoint(tree["bev"])))
    timings = {}
    got = track_scene_dataset(build_pipeline(cfg, model), build_dataset(cfg, "val"),
                              timings=timings)
    assert _assert_same_result(got, jax_result) >= 4
    assert len(got["results"]) == 3 and set(timings) == {"read", "step", "format"}
    ids = {a["tracking_id"] for annos in got["results"].values() for a in annos}
    assert all(int(i) >= 1 for i in ids)


def test_track_scene_with_host_plans_matches_jax(tree, jax_result):
    """use_host_plans runs the planned trunk; the result is the same."""
    cfg = Config.fromfile(str(tree["cfgs"]["car"]))
    model = load_model(cfg, tree["full"], "cpu")
    model.load_state_dict(merge_pretrained(model.state_dict(), load_checkpoint(tree["bev"])))
    got = track_scene_dataset(build_pipeline(cfg, model), build_dataset(cfg, "val"),
                              use_host_plans=True)
    _assert_same_result(got, jax_result)


def test_track_scene_cli_writes_the_jax_result(tree, jax_result):
    cfg = Config.fromfile(str(tree["cfgs"]["car"]))
    merged = merge_pretrained(load_model(cfg, tree["full"], "cpu").state_dict(),
                              load_checkpoint(tree["bev"]))
    ckpt = tree["tmp"] / "merged.pth"
    save_checkpoint(str(ckpt), merged)
    out = tree["tmp"] / "cli" / "tracking_result.json"
    track_scene.main(["--config", str(tree["cfgs"]["car"]), "--checkpoint", str(ckpt),
                      "--cpu", "--out", str(out)])
    with open(out) as f:
        _assert_same_result(json.load(f), jax_result)
    with pytest.raises(SystemExit):  # --render waits for the viz/ port
        track_scene.main(["--config", str(tree["cfgs"]["car"]), "--checkpoint", str(ckpt),
                          "--cpu", "--render", "x.png"])


def test_run_multiclass_matches_jax(tree):
    """car + bus over one shared trunk; the micro tree has no bus detection,
    so bus runs every frame with zero dets."""
    specs = {"car": (str(tree["cfgs"]["car"]), tree["full"]),
             "bus": (str(tree["cfgs"]["bus"]), tree["bus"])}
    want = jrun_multiclass(specs, str(tree["tmp"] / "jax_mc.json"), trunk_key="car")
    out = tree["tmp"] / "mc" / "tracking_result.json"
    got = run_multiclass(specs, str(out), trunk_key="car", device="cpu")
    assert _assert_same_result(got, want) >= 4
    with open(out) as f:
        assert json.load(f) == got
    names = {a["tracking_name"] for annos in got["results"].values() for a in annos}
    assert names == {"car"}


def test_eval_tracking_lite_matches_jax(tree, jax_result):
    got = eval_tracking_lite(jax_result["results"], tree["gt_info"])
    want = jeval_tracking_lite(jax_result["results"], tree["gt_info"])
    assert got.keys() == want.keys() == {"car", "mean_amota"}
    assert abs(got["mean_amota"] - want["mean_amota"]) <= 1e-9
    for k, v in want["car"].items():
        assert abs(got["car"][k] - v) <= 1e-9, k
    assert np.isfinite(got["car"]["amota"])
