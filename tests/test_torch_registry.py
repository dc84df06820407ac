"""The port's registry, register_all, lazy top-level API and profiler
against the JAX package's (CPU)."""
import json
import os

import pytest
import torch

import shasta_tpu_torch
from shasta_tpu.registry_setup import register_all as jregister_all
from shasta_tpu_torch import infer, models
from shasta_tpu_torch.registry_setup import register_all
from shasta_tpu_torch.utils import Registry, build_from_cfg
from shasta_tpu_torch.utils.profiler import StageTimer, annotate, cost_analysis, trace

SMALL = dict(max_obj=6, grid_shape=[41, 48, 48], cap_conv2=512, cap_conv3=256,
             cap_conv4=128, cap_extra=128)


def test_register_all_names_equal_the_jax_packages():
    got, want = register_all(), jregister_all()
    assert got.keys() == want.keys()
    for k in want:
        assert sorted(got[k]._module_dict) == sorted(want[k]._module_dict), k
    assert register_all()["models"] is got["models"]  # a second call adds nothing


def test_build_from_cfg_builds_the_ports_components():
    """As tests/test_trainer_registry.py:15-25, on the CPU; lists in a
    config become tuples; without a device the models go to the card."""
    regs = register_all()
    m = build_from_cfg(dict(type="ShastaModel", device="cpu", **SMALL), regs["models"])
    assert isinstance(m, models.ShastaModel) and m.cfg.max_obj == 6
    assert m.cfg.grid_shape == (41, 48, 48) and m.device.type == "cpu"
    b = build_from_cfg(dict(type="BEVMap", **SMALL), regs["models"],
                       default_args={"device": "cpu"})
    assert isinstance(b, models.BEVMap) and b.cfg.cap_conv2 == 512
    assert {k.split(".")[0] for k in b.state_dict()} == {"backbone", "neck"}
    t = build_from_cfg(dict(type="PubTracker", max_age=3), regs["trackers"])
    assert t.max_age == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_from_cfg(dict(type="BEVMap", **SMALL), regs["models"])
    with pytest.raises(KeyError):
        build_from_cfg(dict(type="Nope"), Registry("x"))


def test_lazy_top_level_api():
    assert shasta_tpu_torch.ShastaModel is models.ShastaModel
    assert shasta_tpu_torch.ShastaConfig is models.ShastaConfig
    for name in ("ScenePipeline", "BatchedScenePipeline", "MultiClassScenePipeline"):
        assert getattr(shasta_tpu_torch, name) is getattr(infer, name)
    assert shasta_tpu_torch.register_all is register_all
    with pytest.raises(AttributeError):
        shasta_tpu_torch.nothing_here  # noqa: B018


def test_stage_timer_accumulates():
    t = StageTimer()
    for _ in range(3):
        with t.stage("work"):
            sum(range(1000))
    with t.stage("other", block_on=torch.ones(4)):
        pass
    s = t.summary()
    assert s["work"]["count"] == 3 and s["work"]["total_s"] >= 0
    assert s["other"]["count"] == 1 and s["work"]["mean_ms"] >= 0


def test_cost_analysis_reports_flops():
    x = torch.ones(64, 64)
    c = cost_analysis(lambda a, b: a @ b, x, x)
    assert c["flops"] >= 2 * 64**3 * 0.9  # ~2mnk, as tests/test_profiler.py:24-30
    assert c["bytes_accessed"] is None and c["optimal_seconds"] is None


def test_trace_writes_the_span(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        with annotate("tiny"):
            torch.ones(8).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tiny" for e in events)
