#!/usr/bin/env python3
"""Build the PyTorch + CUDA port and drive its serving step on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from shasta_tpu_torch/csrc (nvcc, in parallel);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (bench-scale frame: 120k voxels, stage caps
     50k/25k/12k/12k), f32 with TF32 off at atol 1e-4 and bf16 at atol/rtol
     2e-2, and time both;
  4. drive ScenePipeline.step_frame at the full car width (V=120k,
     max_obj 90, 60 real dets, cls_id 2, max_age 4, bf16 trunk, random
     weights from a numpy seed loaded through load_jax_variables): warm-up,
     then three timed runs of 20 frames; check the softmax sums, the ids and that every
     frame launched rulebook_conv 11 times and keyed_conv 10 times;
  5. run a small configuration on cuda and on cpu (plain versions): equal
     ids, used, keep and FN flags, refined scores within 1e-4.
The line before the last is {"kernels": [...]} (launches from phase 4,
times from phase 3); the last is {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
TIMED_FRAMES = 20
TIMED_RUNS = 3
WARMUP_FRAMES = 3
SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
             cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call, CUDA events around `reps` calls.
    A spin kernel ahead of them holds the stream until all `reps` calls are
    queued, so the host's launch cost does not enter the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_cases(cfg, frame, plans, dev):
    """The main path's 21 convs as (kernel, case, launches per frame, args
    builder): inputs at the shapes a bench frame gives each kernel."""
    import torch

    from shasta_tpu_torch.ops import sparse as sp

    V = frame["coordinates"].shape[1]
    coords0 = torch.cat([torch.zeros((V, 1), dtype=torch.int32),
                         torch.from_numpy(frame["coordinates"][0])], 1).to(dev)
    st0 = sp.SparseTensor(None, coords0, torch.from_numpy(frame["voxels_valid"][0]).to(dev),
                          tuple(cfg.grid_shape), 1)
    down = ((3, 3, 3), (2, 2, 2), (1, 1, 1))

    def out_set(st, key, geom):
        c, v, shape = sp.decode_strided_keys(plans[key], st.shape, *geom, 1)
        return sp.SparseTensor(None, c, v, shape, 1)

    def rows(st):
        return st.coords.shape[0]

    st1 = out_set(st0, "d1_keys", down)
    st2 = out_set(st1, "d2_keys", down)
    g3 = ((3, 3, 3), (2, 2, 2), (0, 1, 1))
    gex = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
    st3 = out_set(st2, "d3_keys", g3)
    stx = out_set(st3, "ex_keys", gex)

    def keyed(st_in, st_out=None, geom=None):
        skeys, perm = sp.key_table(st_in)
        q = (sp.subm_queries(st_in) if st_out is None else
             sp.strided_queries(st_out.coords, st_out.valid, st_in.shape, *geom))
        return (skeys, perm, q)

    rb = lambda key: (plans[key],)  # noqa: E731
    return [
        ("rulebook_conv", "conv_input 5->16", 1, V, 5, 16, rb("s0_rb")),
        ("rulebook_conv", "res0 16->16", 4, V, 16, 16, rb("s0_rb")),
        ("rulebook_conv", "down1 16->32", 1, V, 16, 32, rb("d1_rb")),
        ("rulebook_conv", "res1 32->32", 4, rows(st1), 32, 32, rb("d1s_rb")),
        ("rulebook_conv", "down2 32->64", 1, rows(st1), 32, 64, rb("d2_rb")),
        ("keyed_conv", "res2 64->64", 4, rows(st2), 64, 64, keyed(st2)),
        ("keyed_conv", "down3 64->128", 1, rows(st2), 64, 128, keyed(st2, st3, g3)),
        ("keyed_conv", "res3 128->128", 4, rows(st3), 128, 128, keyed(st3)),
        ("keyed_conv", "extra 128->128 K=3", 1, rows(st3), 128, 128,
         keyed(st3, stx, gex)),
    ]


def phase_kernels(cfg, frame, plans, dev):
    """Phase 3: each kernel against its plain version, and their times."""
    import torch

    from shasta_tpu_torch.ops.kernels import block_conv, window_conv

    # each as fn(index tensors, feats, weight)
    fns = {"rulebook_conv": (lambda i, f, w: block_conv.rulebook_conv(f, *i, w),
                             lambda i, f, w: block_conv.rulebook_conv_plain(f, *i, w)),
           "keyed_conv": (lambda i, f, w: window_conv.keyed_conv(*i, f, w),
                          lambda i, f, w: window_conv.keyed_conv_plain(*i, f, w))}
    g = torch.Generator(device="cpu").manual_seed(0)
    per_kernel = collections.defaultdict(lambda: dict(ms=0.0, plain_ms=0.0, bytes=0.0,
                                                      flops=0.0, err=0.0))
    for name, case, n, V, cin, co, idx in conv_cases(cfg, frame, plans, dev):
        kern, plain = fns[name]
        K = idx[-1].shape[1]
        M = idx[-1].shape[0]
        if name == "rulebook_conv":
            hits = int(((idx[0] >= 0) & (idx[0] < V)).sum())
        else:
            hits = int((window_conv.keyed_rows(*idx) < V).sum())
        f32 = torch.randn(V, cin, generator=g).to(dev)
        w32 = (torch.randn(K, cin, co, generator=g) / (K * cin) ** 0.5).to(dev)
        for dt, atol, rtol in ((torch.float32, 1e-4, 0.0), (torch.bfloat16, 2e-2, 2e-2)):
            f, w = f32.to(dt), w32.to(dt)
            got, want = kern(idx, f, w), plain(idx, f, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bad = float(((got - want).abs() - rtol * want.abs()).max())
            check(bad <= atol, f"{name} {case} {dt}: max abs err {err} (atol {atol}, "
                  f"rtol {rtol})")
            rec = per_kernel[name]
            rec["err"] = max(rec["err"], err)
        # main path dtype: bf16
        f, w = f32.to(torch.bfloat16), w32.to(torch.bfloat16)
        ms = cuda_ms(lambda: kern(idx, f, w))
        plain_ms = cuda_ms(lambda: plain(idx, f, w))
        isz = 2
        nbytes = V * cin * isz + M * K * 4 + K * cin * co * isz + M * co * 4
        if name == "keyed_conv":
            nbytes += 2 * V * 4  # sorted keys + perm
        rec = per_kernel[name]
        rec["ms"] += n * ms
        rec["plain_ms"] += n * plain_ms
        rec["bytes"] += n * nbytes
        rec["flops"] += n * 2.0 * hits * cin * co
        print(f"  {name:14s} {case:20s} x{n}  M={M:6d} hits={hits:8d}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  (bf16)")
    return per_kernel


def drive_pipeline(model, frame, n_curr, frames):
    """Run `frames` step_frame calls of a fresh pipeline, fetching outputs
    two frames deep; returns the outputs."""
    from shasta_tpu_torch.infer import ScenePipeline

    pipe = ScenePipeline(model, cls_id=2)
    outs, pending = [], collections.deque()
    for _ in range(frames):
        out = pipe.step_frame(frame, n_curr, 0.5).start_fetch()
        pending.append(out)
        outs.append(out)
        if len(pending) > 2:
            pending.popleft().tid
    for out in pending:
        out.tid
    return outs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from shasta_tpu_torch import resolve_device
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.infer import ScenePipeline
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.ops.kernels import block_conv, build, window_conv
    from shasta_tpu_torch.profile_step import car_setup

    # 1. the card
    dev = resolve_device("cuda")  # also turns TF32 off
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # the step is host-bound: the host's cores and load bound its frames/s
    host = {"cpus": len(os.sched_getaffinity(0)), "loadavg": os.getloadavg()}
    print(f"host: {host}")

    # 2. build
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"phase 2: built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in report.items():
        print(f"--- {name} ptxas ---\n{log.strip()}")
    build.library("block_conv"), build.library("window_conv")

    # bench-scale frame, its host plans and the bf16 model (bench.py:39-41,121-148)
    t0 = time.perf_counter()
    cfg, batch, plans, model, frame = car_setup(dev)
    print(f"set-up (frame, host plans, weights): {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    print("phase 3: kernels vs plain versions at main-path shapes")
    per_kernel = phase_kernels(cfg, batch, plans, dev)

    # 4. full-width serving step
    drive_pipeline(model, frame, 60, WARMUP_FRAMES)
    torch.cuda.synchronize()
    block_conv.rulebook_conv.launches = 0
    window_conv.keyed_conv.launches = 0
    fps_runs, outs = [], []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        outs += drive_pipeline(model, frame, 60, TIMED_FRAMES)
        torch.cuda.synchronize()
        fps_runs.append(TIMED_FRAMES / (time.perf_counter() - t0))
    launches = {"rulebook_conv": block_conv.rulebook_conv.launches,
                "keyed_conv": window_conv.keyed_conv.launches}
    fps = statistics.median(fps_runs)
    n_frames = TIMED_RUNS * TIMED_FRAMES
    print(f"phase 4: {TIMED_RUNS} runs of {TIMED_FRAMES} frames at "
          f"{[round(x, 3) for x in fps_runs]} frames/s (median {fps:.3f}); "
          f"launches {launches}")
    check(launches == {"rulebook_conv": 11 * n_frames, "keyed_conv": 10 * n_frames},
          f"expected 11 + 10 kernel launches per frame, got {launches}")
    with torch.no_grad():
        feat = model.frame_features(frame)
        m1, m2 = model.affinity_step(frame["det_boxes"], frame["det_boxes"], feat, feat)
    want_shape = (1, cfg.max_obj, cfg.num_point * cfg.share_conv_channel)
    check(tuple(feat.shape) == want_shape and bool(torch.isfinite(feat).all()),
          f"descriptors are not finite {want_shape}")
    check(bool(torch.isfinite(m1).all() & torch.isfinite(m2).all()), "affinity not finite")
    check(torch.allclose(m1.sum(2), torch.ones_like(m1.sum(2)), atol=1e-4)
          and torch.allclose(m2.sum(1), torch.ones_like(m2.sum(1)), atol=1e-4),
          "m1 rows / m2 columns do not sum to 1")
    for out in outs:
        check(out.used.any() and bool((out.tid[out.used] >= 1).all()),
              "a used det row has no id >= 1")
    print(f"phase 4 checks ok; last ids {outs[-1].tid[:12].tolist()}")

    # 5. small configuration: cuda against cpu
    small_cfg = ShastaConfig(**SMALL)
    runs = {}
    for d in ("cuda", "cpu"):
        m = ShastaModel(small_cfg, device=d)
        load_jax_variables(m, random_jax_variables(m, seed=1))
        pipe5 = ScenePipeline(m, cls_id=2)
        res = []
        for s in range(3):
            b = make_batch(small_cfg, num_voxels_cap=2500, n_dets=7, seed=s)
            res.append(pipe5.step_frame(b, 7, 0.5))
        runs[d] = res
    for a, b in zip(runs["cuda"], runs["cpu"]):
        for field in ("tid", "used", "keep", "fn"):
            check(np.array_equal(getattr(a, field), getattr(b, field)),
                  f"small config: cuda and cpu differ in {field}")
        check(np.allclose(a.ref, b.ref, atol=1e-4), "small config: ref differs")
    print("phase 5: small config cuda == cpu")

    kernels = []
    src = {"rulebook_conv": ("shasta_tpu_torch/csrc/block_conv.cu",
                             "shasta_tpu/ops/pallas/block_conv.py:117"),
           "keyed_conv": ("shasta_tpu_torch/csrc/window_conv.cu",
                          "shasta_tpu/ops/pallas/window_conv.py:719")}
    for name, rec in per_kernel.items():
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "per": "one frame's launches at bf16 (sum over its convs)",
        })
    print(json.dumps({"frames_per_s": fps, "frames_per_s_runs": fps_runs, "card": smi,
                      "host": host}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
