"""The port's eval flow against the JAX package's (CPU, f32):
run_affinity_eval (the two-frame forward on every pair),
run_affinity_eval_batched (3 scene lanes over 4 scenes of unequal length,
so a lane refills, two lanes idle and chunk 2 pads its last call; voxel
tiers on), save_first_frame and track, the merge_results, pub_test and
eval CLIs and validate(), on a write_track_split split.

One random port state_dict, saved as a .pth, gives both sides their
weights (the JAX side through its own load_checkpoint + merge_pretrained).
Annotations must come in the same order with the same keys; decisions
(which dets, FN, newborn and dead flags) are exact, ref_detection_score
and FN translations within 1e-4 (the step tolerance of
tests/test_torch_pipeline.py); tracking results after the host trackers
within the same 1e-4 on tracking_score.

The split's caps (2000/1000/500/500) cut the sets of a 3-lane step, as the
config caps do at 8 lanes: batched annotations then differ from the
per-pair ones, in both packages alike. Where the caps hold every set, the
port's batched annotations equal its per-pair ones (the JAX docstring's
claim, runner.py:150-156), given frames whose clouds and dets draw
nothing at random (no sweeps, max_objects above every count).
"""
import copy
import json
import os
import pickle
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shasta_tpu.data.nuscenes import NuScenesTrackDataset as JDataset
from shasta_tpu.data.nuscenes import PointPipelineConfig as JPointPipeline
from shasta_tpu.data.synthetic import make_batch as jmake_batch
from shasta_tpu.models import ShastaModel as JModel
from shasta_tpu.tracker import runner as jrunner
from shasta_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from shasta_tpu.train.checkpoint import merge_pretrained as jmerge_pretrained
from shasta_tpu.utils import Config as JConfig

from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
from shasta_tpu_torch.data.nuscenes import collate
from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
from shasta_tpu_torch.infer import FRAME_KEYS
from shasta_tpu_torch.probe_b1_routes import stage_sets
from shasta_tpu_torch.tools import eval as teval
from shasta_tpu_torch.tools import merge_results, pub_test
from shasta_tpu_torch.tools.common import build_dataset, build_model, load_model
from shasta_tpu_torch.tools.validate import validate
from shasta_tpu_torch.tracker import runner
from shasta_tpu_torch.train.checkpoint import save_checkpoint
from shasta_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import merge_results as jmerge_results  # noqa: E402
import pub_test as jpub_test  # noqa: E402
from train import build_model as jbuild_model  # noqa: E402
from validate import validate as jvalidate  # noqa: E402

SMALL = dict(
    max_objects=10,
    model=dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-12.0, -12.0), voxel_size=(0.3, 0.3),
               cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500),
    point_pipeline=dict(voxel_size=(0.3, 0.3, 0.2), pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                        max_voxels=3000, nsweeps=3, voxel_tiers=(2700, 2800, 2900)))
# caps that hold every set of 3 lanes (at most 9,868 / 3,403 / 842 / 600
# on this split's steps), and frames that draw nothing at random
WHOLE = dict(SMALL, max_objects=16,
             model=dict(SMALL["model"], max_obj=16, cap_conv2=11000, cap_conv3=4000,
                        cap_conv4=1000, cap_extra=1000),
             point_pipeline=dict(SMALL["point_pipeline"], nsweeps=1))
LANES = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain CPU path runs many small parallel regions; with the
    suite's workers sharing the cores, each region waits on threads that
    are not scheduled (a step 20x slower than alone). One thread per
    worker, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_init():
    """The JAX tools initialise their model eagerly, op by op (about a
    minute on the CPU); jitted, init takes seconds. Every value it makes is
    replaced by the checkpoint each JAX run loads next."""
    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda *a: nn.Module.init(self, rngs, *a, **kwargs))(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JModel, "init", init)
        yield


def _split(root, overrides, seed):
    """4 scenes of 3, 3, 3 and 2 frames (the last frame left out of the
    infos), a config serving them, the same without voxel tiers ("flat":
    the JAX two-frame forward takes both frames at one voxel count) and a
    random .pth."""
    base = write_split_config(os.path.join(REPO, "configs", "nusc", "car.py"), {},
                              str(root / "base.py"), **overrides)
    sp = write_track_split(str(root / "data"), Config.fromfile(base), n_scenes=4, n_frames=3,
                           seed=seed, n_objects=16, n_points=4000, n_spots=1000)
    with open(sp["val"]["info_path"], "rb") as f:
        infos = pickle.load(f)
    with open(sp["val"]["info_path"], "wb") as f:
        pickle.dump(infos[:-1], f)
    cfg_path = write_split_config(base, sp["val"], str(root / "split.py"))
    flat = write_split_config(base, sp["val"], str(root / "flat.py"),
                              point_pipeline=dict(voxel_tiers=None))
    cfg = Config.fromfile(cfg_path)
    model = build_model(cfg, "cpu")
    load_jax_variables(model, random_jax_variables(model, seed=seed + 1))
    # random heads are near uniform and fire no decision: the last layer,
    # scaled and its dead/FN column biases raised, makes newborn, dead and
    # FN flags all occur
    sd = model.state_dict()
    sd["aff.10.weight"] *= 10.0
    sd["aff.10.bias"] *= 10.0
    sd["aff.10.bias"][-2:] += 5.0
    sd["aff.10.bias"][-2] += 3.5
    ckpt = str(root / "model.pth")
    save_checkpoint(ckpt, sd)
    return dict(cfg=cfg_path, flat=flat, ckpt=ckpt, gt_info=sp["gt_info_dir"],
                frame_info=sp["val"]["frame_info_path"], tokens=sp["tokens"][:-1],
                frame_tokens=sp["tokens"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _split(tmp_path_factory.mktemp("eval"), SMALL, seed=16)


class JaxSide:
    """The JAX package's model, dataset and eval runs of one split, each run
    made once per module."""

    def __init__(self, tree):
        self.tree = tree
        self.cfg = JConfig.fromfile(tree["cfg"])
        self.model, mc = jbuild_model(self.cfg)
        pp = dict(self.cfg.point_pipeline)
        one = {k: jnp.asarray(v) for k, v in jmake_batch(
            mc, batch_size=1, num_voxels_cap=pp["max_voxels"], n_dets=4).items()}
        variables = self.model.init(jax.random.PRNGKey(0), one, train=False)
        self.variables = jmerge_pretrained(variables, jload_checkpoint(tree["ckpt"]))
        self._runs = {}

    def dataset(self, config="cfg"):
        cfg = JConfig.fromfile(self.tree[config])
        pp = dict(cfg.point_pipeline, shuffle_points=False)
        return JDataset(**dict(cfg.data.val), det_type=list(cfg.det_type),
                        max_objects=cfg.max_objects, pipeline=JPointPipeline(**pp))

    def batched(self, chunk):
        key = ("batched", chunk)
        if key not in self._runs:
            self._runs[key] = jrunner.run_affinity_eval_batched(
                self.model, self.variables, self.dataset(), batch=LANES, chunk=chunk,
                fp_thresh=self.cfg.fp_elim, decision_thresh=self.cfg.decision_thresh)
        return self._runs[key]

    def parity(self):
        if "parity" not in self._runs:
            fwd = jax.jit(lambda v, b: self.model.apply(v, b, train=False))
            self._runs["parity"] = jrunner.run_affinity_eval(
                lambda b: fwd(self.variables, {k: jnp.asarray(v) for k, v in b.items()
                                               if not isinstance(v, list)}),
                self.dataset("flat"), fp_thresh=self.cfg.fp_elim,
                decision_thresh=self.cfg.decision_thresh)
        return self._runs["parity"]


@pytest.fixture(scope="module")
def jax_side(tree, jitted_jax_init):
    return JaxSide(tree)


@pytest.fixture(scope="module")
def port_model(tree):
    return load_model(Config.fromfile(tree["cfg"]), tree["ckpt"], "cpu")


def same_annos(got, want, tol=1e-4):
    """Two cp_{split}.json results: tokens in the same order, annotations
    with the same keys in the same order and equal values, but
    ref_detection_score and FN translations within tol. Returns (the
    annotation count, {flag: count})."""
    assert got["meta"] == want["meta"]
    assert list(got["results"]) == list(want["results"])
    n, flags = 0, dict(FN=0, newborn=0, dead=0)
    for tok, w_annos in want["results"].items():
        g_annos = got["results"][tok]
        assert len(g_annos) == len(w_annos), tok
        for g, w in zip(g_annos, w_annos):
            assert list(g) == list(w), tok
            for k, v in w.items():
                if k == "ref_detection_score":
                    assert type(g[k]) is float and abs(g[k] - v) <= tol, (tok, g[k], v)
                elif k == "translation" and "FN" in w:
                    assert np.allclose(g[k], v, atol=tol, rtol=0), (tok, g[k], v)
                else:
                    assert g[k] == v, (tok, k, g[k], v)
            n += 1
            for f in flags:
                flags[f] += f in w
    return n, flags


def same_tracking(got, want, tol=1e-4):
    assert got["meta"] == want["meta"]
    assert list(got["results"]) == list(want["results"])
    n = 0
    for tok, w_annos in want["results"].items():
        g_annos = got["results"][tok]
        assert len(g_annos) == len(w_annos), tok
        for g, w in zip(g_annos, w_annos):
            assert list(g) == list(w)
            for k, v in w.items():
                if k == "tracking_score":
                    assert abs(g[k] - v) <= tol, (tok, g[k], v)
                elif k == "translation":
                    assert np.allclose(g[k], v, atol=tol, rtol=0), (tok, g[k], v)
                else:
                    assert g[k] == v, (tok, k, g[k], v)
            n += 1
    return n


def test_lane_schedule():
    """3 lanes over scenes of 3, 3, 3 and 2 frames: scene 3 refills lane 0,
    lanes 1 and 2 idle on its rows."""
    rows = runner.lane_schedule([3, 3, 3, 2], 3)
    assert rows == [[(0, 0), (1, 0), (2, 0)], [(0, 1), (1, 1), (2, 1)],
                    [(0, 2), (1, 2), (2, 2)], [(3, 0), None, None], [(3, 1), None, None]]
    assert runner.lane_schedule([2, 1], 4) == [[(0, 0), (1, 0), None, None],
                                               [(0, 1), None, None, None]]


def test_metadata_and_read_at_equal_the_in_order_read(tree):
    """metadata() without reading a cloud, then read_at in another order,
    gives every sample bit for bit as reading indices 0, 1, ... does."""
    cfg = Config.fromfile(tree["cfg"])
    ref = build_dataset(cfg, "val")
    want = [ref[i] for i in range(len(ref))]
    ds = build_dataset(cfg, "val")
    meta = ds.metadata()
    assert [m["token"] for m in meta] == tree["tokens"]
    assert "voxels" not in meta[0] and all("rng_state" in m for m in meta)
    # the generator ends where the in-order read leaves it
    assert ds._rng.bit_generator.state == ref._rng.bit_generator.state
    for i in reversed(range(len(meta))):
        got = ds.read_at(i, meta[i]["rng_state"])
        assert got.keys() == want[i].keys()
        for k, v in want[i].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(got[k], v), (i, k)
            else:
                assert got[k] == v, (i, k)
    assert len({want[i]["voxels"].shape[0] for i in range(len(want))}) > 1  # tiers differ


def test_run_affinity_eval_matches_jax(tree, jax_side, port_model):
    """(c) the per-pair loop through the two-frame forward, without voxel
    tiers (the JAX forward cannot take frames of two voxel counts)."""
    got = runner.run_affinity_eval(port_model, build_dataset(Config.fromfile(tree["flat"]), "val"))
    n, flags = same_annos(got, jax_side.parity())
    assert list(got["results"]) == tree["tokens"] and n > 20
    assert min(flags.values()) > 0, flags


@pytest.mark.parametrize("chunk", [1, 2])
def test_run_affinity_eval_batched_matches_jax(tree, jax_side, port_model, chunk):
    """(d) 3 lanes, one refill and two idle lanes; chunk 2 pads its last
    call with an idle row; frames padded to different voxel tiers."""
    timings = {}
    got = runner.run_affinity_eval_batched(port_model, build_dataset(Config.fromfile(tree["cfg"]),
                                                                     "val"),
                                           batch=LANES, chunk=chunk, timings=timings)
    n, flags = same_annos(got, jax_side.batched(chunk))
    assert sorted(got["results"]) == sorted(tree["tokens"]) and n > 20
    assert min(flags.values()) > 0, flags
    assert set(timings) == {"read", "step", "assemble"}


def test_batched_equals_parity_where_the_caps_hold(tmp_path):
    """(e) the port's batched annotations equal its per-pair ones where the
    caps hold every lane's sets and the frames draw nothing at random,
    after each scene's first frame."""
    t = _split(tmp_path, WHOLE, seed=26)
    cfg = Config.fromfile(t["cfg"])
    model = load_model(cfg, t["ckpt"], "cpu")
    ds = build_dataset(cfg, "val")
    samples = [ds[i] for i in range(len(ds))]
    for row in runner.lane_schedule([3, 3, 3, 2], LANES):  # the caps hold every step's sets
        lanes = [samples[3 * e[0] + e[1]] for e in row if e is not None]
        lanes += lanes[:1] * (LANES - len(lanes))  # idle lanes: the template frame
        frame = {k: torch.as_tensor(v) for k, v in collate(
            [{k: s[k] for k in FRAME_KEYS} for s in lanes]).items()}
        for st in stage_sets(lambda: model.bev_single(frame)):
            assert st["distinct"] <= st["cap"], (row, st["name"], st["distinct"])
    parity = runner.run_affinity_eval(model, build_dataset(cfg, "val"))
    batched = runner.run_affinity_eval_batched(model, build_dataset(cfg, "val"), batch=LANES)
    # the same annotations on every frame but a scene's first, in the
    # batched loop's order of frames. At a scene start the batched step
    # zeroes the carried descriptors while the pair forward samples the
    # frame's own BEV at the zero prev boxes; the head's softmax spans those
    # rows, so the first frame's scores differ (in the JAX package alike).
    assert list(parity["results"]) == t["tokens"] and sorted(batched["results"]) == sorted(
        t["tokens"])
    later = [tok for tok in batched["results"] if not tok.endswith("f0")]
    n, flags = same_annos(
        dict(batched, results={tok: batched["results"][tok] for tok in later}),
        dict(parity, results={tok: parity["results"][tok] for tok in later}))
    assert n > 20 and flags["dead"] > 0, flags


def test_save_first_frame_and_track_match_jax(tree, jax_side, tmp_path):
    """(f) frames_meta.json, and the single, refined and merged trackers
    (greedy and Hungarian) over the JAX batched annotations."""
    got_frames = runner.save_first_frame(tree["frame_info"], str(tmp_path / "p"))
    want_frames = jrunner.save_first_frame(tree["frame_info"], str(tmp_path / "j"))
    assert got_frames == want_frames
    with open(tmp_path / "p" / "frames_meta.json") as f, open(tmp_path / "j" / "frames_meta.json") as g:
        assert json.load(f) == json.load(g)
    preds = jax_side.batched(1)["results"]
    ids = set()
    for kw in (dict(), dict(refine_confidence=True, alpha=0.5, beta=0.4),
               dict(merged=True), dict(merged=True, hungarian=True), dict(max_age=2)):
        got, _ = runner.track(preds, got_frames, **kw)
        want, _ = jrunner.track(preds, want_frames, **kw)
        assert got == want, kw
        ids |= {a["tracking_id"] for v in got["results"].values() for a in v}
    assert len(ids) > 5


def test_merge_results_and_pub_test_clis_match_jax(tree, jax_side, tmp_path, monkeypatch):
    """(f) the two host CLIs in process (--skip_eval, --repeat 1): the
    JAX batched result and its copy with the class renamed as two inputs."""
    a = tmp_path / "car_eval" / "cp_val.json"
    b = tmp_path / "bus_eval" / "cp_val.json"
    for p, name in ((a, None), (b, "bus")):
        res = json.loads(json.dumps(jax_side.batched(1)))
        if name:
            for annos in res["results"].values():
                for x in annos:
                    x["detection_name"] = name
        p.parent.mkdir()
        p.write_text(json.dumps(res))
    merged = merge_results.main(["--inputs", str(a), str(b), "--output",
                                 str(tmp_path / "p" / "cp_val.json")])
    monkeypatch.setattr(sys, "argv", ["merge_results.py", "--inputs", str(a), str(b),
                                      "--output", str(tmp_path / "j" / "cp_val.json")])
    jmerge_results.main()
    want_merged = json.loads((tmp_path / "j" / "cp_val.json").read_text())
    assert merged == want_merged == json.loads((tmp_path / "p" / "cp_val.json").read_text())

    common = ["--frame_info", tree["frame_info"], "--skip_eval", "--repeat", "1"]
    got = pub_test.main(["--predictions", str(tmp_path / "p" / "cp_val.json"),
                         "--work_dir", str(tmp_path / "pt")] + common)
    monkeypatch.setattr(sys, "argv", ["pub_test.py", "--predictions",
                                      str(tmp_path / "j" / "cp_val.json"),
                                      "--work_dir", str(tmp_path / "jt")] + common)
    jpub_test.main()
    want = json.loads((tmp_path / "jt" / "tracking_result.json").read_text())
    assert got == want == json.loads((tmp_path / "pt" / "tracking_result.json").read_text())
    names = {x["tracking_name"] for v in got["results"].values() for x in v}
    # frame_info lists the frame left out of the infos too
    assert names == {"car", "bus"} and list(got["results"]) == tree["frame_tokens"]
    seen = [{x["tracking_id"] for x in got["results"][tok]} for tok in tree["frame_tokens"]]
    assert sum(len(a & b) for a, b in zip(seen, seen[1:])) > 10  # ids carried over frames


def test_eval_cli_matches_jax(tree, jax_side, tmp_path):
    """The eval CLI on the CPU: cp_val.json equals the JAX batched
    annotations; --track writes both tracking results of those
    annotations; an orbax directory is refused."""
    wd = tmp_path / "eval"
    annos = teval.main(["--config", tree["cfg"], "--checkpoint", tree["ckpt"], "--work_dir",
                        str(wd), "--cpu", "--batch", str(LANES), "--track"])
    with open(wd / "cp_val.json") as f:
        assert json.load(f) == annos
    same_annos(annos, jax_side.batched(1))
    cfg = Config.fromfile(tree["cfg"])
    frames = runner.save_first_frame(tree["frame_info"], str(tmp_path / "f"))
    for name, kw in (("tracking_result.json", {}),
                     (f"tracking_result_ref_alpha{cfg.alpha}_beta{cfg.beta}.json",
                      dict(refine_confidence=True, alpha=cfg.alpha, beta=cfg.beta))):
        want, _ = runner.track(annos["results"], frames, max_age=cfg.max_age, **kw)
        with open(wd / name) as f:
            assert json.load(f) == json.loads(json.dumps(want)), name
    with pytest.raises(ValueError, match="orbax"):
        teval.main(["--config", tree["cfg"], "--checkpoint", str(tmp_path), "--cpu",
                    "--work_dir", str(wd)])


def test_validate_matches_jax(tree, jax_side, tmp_path, monkeypatch):
    """(g) validate() on the CPU: metrics_lite equals the JAX validate's, and
    both tracking results equal within 1e-4. The JAX validate's batched eval
    is the JAX run of the same split and arguments made once per module
    (jax_side.batched(1); run again, it would compile its step again)."""
    def cached(model, variables, ds, batch, fp_thresh, decision_thresh, progress):
        assert batch == LANES and (fp_thresh, decision_thresh) == (
            jax_side.cfg.fp_elim, jax_side.cfg.decision_thresh)
        return copy.deepcopy(jax_side.batched(1))

    got = validate(tree["cfg"], tree["ckpt"], str(tmp_path / "p"), device="cpu",
                   gt_info_dir=tree["gt_info"], batch=LANES)
    monkeypatch.setattr(jrunner, "run_affinity_eval_batched", cached)
    want = jvalidate(tree["cfg"], tree["ckpt"], str(tmp_path / "j"),
                     gt_info_dir=tree["gt_info"], batch=LANES)
    assert got.keys() == want.keys()
    assert got["metrics"] is got["metrics_refined"] is None  # no nuScenes devkit here
    lite, want_lite = got["metrics_lite"], want["metrics_lite"]
    assert lite.keys() == want_lite.keys() and "car" in lite
    assert abs(lite["mean_amota"] - want_lite["mean_amota"]) <= 1e-9
    for cls in lite:
        if cls != "mean_amota":
            for k, v in want_lite[cls].items():
                assert abs(lite[cls][k] - v) <= 1e-9, (cls, k)
    for name in ("tracking_result.json", "tracking_result_refined.json"):
        with open(tmp_path / "p" / name) as f, open(tmp_path / "j" / name) as g:
            assert same_tracking(json.load(f), json.load(g)) > 0


def test_entry_points_default_to_the_card(tree, tmp_path):
    """Without --cpu (device=None) the eval CLI and validate() ask for cuda
    and raise where there is no card; metadata() refuses a training
    dataset (its augmentation draws depend on the clouds)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--config", tree["cfg"], "--checkpoint", tree["ckpt"], "--work_dir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate(tree["cfg"], tree["ckpt"], str(tmp_path))
    ds = build_dataset(Config.fromfile(tree["cfg"]), "val")
    ds.test_mode = False
    with pytest.raises(ValueError, match="test mode"):
        ds.metadata()
