"""The port's six offline CLIs against the JAX package's tools/ (CPU).

make_scenes, preprocess_nuscenes, create_data, check_artifacts,
estimate_stats and run_oracle_mot run in process (`main(argv)`) on the
same trees as the JAX scripts (their `main()` under a patched sys.argv):
the same JSON, artifact trees, infos pickle, exit code and output, stats at
rtol 1e-12 and the oracle tracker's MOTA summary exactly. Also: the port's
scripts call only the port's CLIs with flags those accept, and no module
of the port imports JAX or the JAX package.
"""
import argparse
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest

import fixtures_nusc
from test_torch_chain import read_artifact, same_tree, same_value
from test_torch_mot import padded_jit_geometry
from shasta_tpu.mot import association as jassociation
from shasta_tpu.mot import redundancy as jredundancy

from shasta_tpu_torch.data.synthetic import build_synthetic_waymo, write_waymo_pkl_tree
from shasta_tpu_torch.tools import (check_artifacts, create_data, estimate_stats, make_scenes,
                                    preprocess_nuscenes, run_oracle_mot)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name: str):
    """tools/{name}.py of the JAX package as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name: str, argv, monkeypatch):
    """The JAX script's main() with argv; returns its exit code (0 when it
    returns)."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    try:
        jax_tool(name).main()
    except SystemExit as e:
        return e.code
    return 0


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A micro tree and a small world (2 scenes x 6 frames), their raw
    dataroots and their 2 Hz val trees from the port's CLI."""
    tmp = tmp_path_factory.mktemp("cli")
    micro = fixtures_nusc.build_micro_nusc(tmp / "micro")
    world = fixtures_nusc.build_synthetic_world(tmp / "world", n_scenes=2, n_frames=6)
    out = {}
    for name, fx in (("micro", micro), ("world", world)):
        prep = str(tmp / f"{name}_prep")
        preprocess_nuscenes.main(["--dataroot", str(fx["root"]), "--version", "v1.0-mini",
                                  "--results", str(fx["results"]), "--out", prep,
                                  "--split", "val"])
        out[name] = dict(fx, prep=prep)
    return out


def test_make_scenes_equals_jax(trees, tmp_path, monkeypatch):
    fx = trees["world"]
    (tmp_path / "scenes.txt").write_text("scene-0001\n\n")
    for extra in ([], ["--scenes", "scene-0000"], ["--scenes_file", str(tmp_path / "scenes.txt")]):
        base = ["--dataroot", str(fx["root"]), "--version", "v1.0-mini"] + extra
        got = make_scenes.main(base + ["--out", str(tmp_path / "port.json")])
        assert run_jax("make_scenes", base + ["--out", str(tmp_path / "jax.json")],
                       monkeypatch) == 0
        want = read_artifact(str(tmp_path / "jax.json"))
        same_value(read_artifact(str(tmp_path / "port.json")), want)
        same_value(got, want)
    assert list(got["scenes"]) == ["scene-0001"] and len(got["scenes"]["scene-0001"]) == 6


@pytest.mark.parametrize("case", ["micro 2hz", "micro 20hz", "micro no_gt", "world scenes_file"])
def test_preprocess_nuscenes_equals_jax(case, trees, tmp_path, monkeypatch):
    tree, what = case.split()
    fx = trees[tree]
    extra = {"2hz": [], "20hz": ["--mode", "20hz"], "no_gt": ["--no_gt", "--split", "test"],
             "scenes_file": ["--scenes_file", str(tmp_path / "scenes.txt")]}[what]
    (tmp_path / "scenes.txt").write_text("scene-0001\n")
    base = ["--dataroot", str(fx["root"]), "--version", "v1.0-mini",
            "--results", str(fx["results"])] + extra
    preprocess_nuscenes.main(base + ["--out", str(tmp_path / "port")])
    assert run_jax("preprocess_nuscenes", base + ["--out", str(tmp_path / "jax")],
                   monkeypatch) == 0
    assert same_tree(str(tmp_path / "jax"), str(tmp_path / "port")) > 5


def test_create_data_equals_jax(trees, tmp_path, monkeypatch, capsys):
    """nuScenes infos, and --waymo over a {split}/{lidar,annos} pkl tree of
    two small synthetic segments: the same pkl and line as the JAX tool."""
    for tree, extra in (("micro", []), ("world", ["--no_gt", "--nsweeps", "3"])):
        base = ["--dataroot", str(trees[tree]["root"]), "--version", "v1.0-mini"] + extra
        got = create_data.main(base + ["--out", str(tmp_path / "port.pkl")])
        assert run_jax("create_data", base + ["--out", str(tmp_path / "jax.pkl")],
                       monkeypatch) == 0
        want = read_artifact(str(tmp_path / "jax.pkl"))
        same_value(read_artifact(str(tmp_path / "port.pkl")), want)
        same_value(got, want)
    raw = build_synthetic_waymo(tmp_path / "waymo_raw", n_segments=2, n_frames=3,
                                top_hw=(4, 32), side_hw=(2, 16), n_objects=5, dets_per_frame=6)
    waymo_root = str(tmp_path / "waymo")
    write_waymo_pkl_tree(str(raw["records"]), waymo_root, "val")
    args = ["--dataroot", waymo_root, "--waymo", "--split", "val", "--nsweeps", "2"]
    capsys.readouterr()
    path = create_data.main(args)
    port_out, got = capsys.readouterr().out, read_artifact(path)
    assert run_jax("create_data", args, monkeypatch) == 0
    assert capsys.readouterr().out == port_out == f"wrote waymo infos -> {path}\n"
    same_value(got, read_artifact(path))
    assert [i["token"] for i in got] == [f"seq_{s}_frame_{f}.pkl" for s in (0, 1) for f in range(3)]
    assert got[1]["sweeps"][0]["transform_matrix"].shape == (4, 4)


def test_check_artifacts_equals_jax(trees, tmp_path, monkeypatch, capsys):
    """Exit code and output equal on a sound tree and on one with a broken
    token chain, a missing det frame and a wrong label shape; the port's
    `python -m` exits with 1 on the broken one."""
    import shutil

    prep = trees["world"]["prep"]
    args = ["--data", prep, "--split", "val"]
    capsys.readouterr()
    assert check_artifacts.main(args) == 0
    port_out = capsys.readouterr().out
    assert run_jax("check_artifacts", args, monkeypatch) == 0
    assert capsys.readouterr().out == port_out == "check complete: 0 problem(s)\n"

    bad = str(tmp_path / "bad")
    shutil.copytree(prep, bad)
    fi_path = os.path.join(bad, "val_frame_info.json")
    frame_info = read_artifact(fi_path)
    frame_info["s0f3"]["prev"] = "s0f1"
    del frame_info["s1f2"]
    with open(fi_path, "w") as f:
        json.dump(frame_info, f)
    split = os.path.join(bad, "val_2hz")
    lbl = os.path.join(split, "gt_shasta", "cp", "individual_frames", "s1f4.npz")
    np.savez_compressed(lbl, matched=np.zeros((1, 1)), newborn=np.zeros(0))
    args = ["--data", bad, "--split", "val"]
    problems = check_artifacts.main(args)
    port_out = capsys.readouterr().out
    assert run_jax("check_artifacts", args, monkeypatch) == 1
    assert capsys.readouterr().out == port_out
    assert problems == 4 and port_out.endswith("check complete: 4 problem(s)\n")
    r = subprocess.run([sys.executable, "-m", "shasta_tpu_torch.tools.check_artifacts"] + args,
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and r.stdout == port_out


def test_estimate_stats_equals_jax(trees, tmp_path, monkeypatch):
    base = ["--data", os.path.join(trees["world"]["prep"], "val_2hz"), "--name", "mine"]
    estimate_stats.main(base + ["--out", str(tmp_path / "port")])
    assert run_jax("estimate_stats", base + ["--out", str(tmp_path / "jax")], monkeypatch) == 0
    for t in "PQR":
        got = read_artifact(str(tmp_path / "port" / f"{t}_mine.json"))
        want = read_artifact(str(tmp_path / "jax" / f"{t}_mine.json"))
        assert list(got) == list(want) == ["car"]
        np.testing.assert_allclose(got["car"], want["car"], rtol=1e-12, atol=0)


@pytest.mark.parametrize("extra", [[], ["--oracle", "dets", "--asso", "iou"],
                                   ["--oracle", "kf", "--asso", "m_dis", "--match", "greedy",
                                    "--covariance", "nuscenes_cp_2hz"]])
def test_run_oracle_mot_equals_jax(extra, trees, tmp_path, monkeypatch):
    """The MOTA summary of the port's CLI with --cpu equals the JAX CLI's
    (its geometry jitted as in tests/test_torch_mot.py)."""
    ns = padded_jit_geometry()
    monkeypatch.setattr(jassociation, "geometry", ns)
    monkeypatch.setattr(jredundancy, "geometry", ns)
    base = ["--data", os.path.join(trees["world"]["prep"], "val_2hz")] + extra
    summary, ids = run_oracle_mot.main(base + ["--cpu", "--out", str(tmp_path / "port.json")])
    assert run_jax("run_oracle_mot", base + ["--out", str(tmp_path / "jax.json")],
                   monkeypatch) == 0
    want = read_artifact(str(tmp_path / "jax.json"))
    same_value(read_artifact(str(tmp_path / "port.json")), want)
    same_value(summary, want)
    assert list(ids) == ["scene-0000", "scene-0001"] and all(len(v) == 6 for v in ids.values())
    assert summary["num_gt"] == 2 * 6 * 5 and np.isfinite(summary["mota"])


def test_run_oracle_mot_needs_a_card_or_cpu(trees):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_oracle_mot.main(["--data", os.path.join(trees["world"]["prep"], "val_2hz")])


class _Parsed(Exception):
    pass


def test_port_scripts_call_port_clis(monkeypatch):
    """Every command of shasta_tpu_torch/scripts/*.sh is `python -m
    shasta_tpu_torch.tools.<cli>` with flags that CLI's parser accepts
    (parsed only: parse_args is stopped once it returns)."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    sdir = os.path.join(REPO, "shasta_tpu_torch", "scripts")
    n = 0
    for fn in sorted(os.listdir(sdir)):
        with open(os.path.join(sdir, fn)) as f:
            text = f.read().replace("\\\n", " ")
        assert fn in ("preprocessing.sh", "trainval.sh", "official_val.sh", "official_test.sh")
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("python"):
                continue
            words = shlex.split(re.sub(r"\$\{?(\w+)[^}\s]*\}?", r"\1", line.replace('"$@"', "")))
            assert words[:2] == ["python", "-m"] and words[2].startswith("shasta_tpu_torch.tools.")
            mod = importlib.import_module(words[2])
            with pytest.raises(_Parsed):
                mod.main(words[3:])
            n += 1
    assert n == 6 + 1 + 2 * 3


def test_port_imports_no_jax():
    """No module of shasta_tpu_torch, and not chip_smoke.py, imports jax or
    anything of the JAX package shasta_tpu."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|shasta_tpu)(\s|\.|$)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "shasta_tpu_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 60
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path

