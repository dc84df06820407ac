#!/usr/bin/env python3
"""Build the PyTorch + CUDA port and drive its serving step on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build all five CUDA kernels from shasta_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. hold rulebook_conv and keyed_conv against their plain PyTorch
     versions on the card at the B=1 step's shapes (bench-scale frame:
     120k voxels, stage caps 50k/25k/12k/12k), f32 with TF32 off at atol
     1e-4 and bf16 at atol/rtol 2e-2, and time both (every kernel time in
     this script is shasta_tpu_torch.timing.median_ms: the median of calls each
     between two CUDA events);
  3b. the same for sorted_lookup (all three modes, integer equality) and
     gather_conv at the 4-lane batched step's shapes: the index tables are
     the ones the port builds for the 4-lane frame (480k voxels, caps
     200k/100k/48k/48k); torch.searchsorted is timed beside sorted_lookup,
     with the share of its tasks that search in shared memory, and
     per mode; per conv group, gather_conv's hits per row, a second bf16
     run that must give the same bits, and beside it rulebook_conv on the
     same table (the CUDA-core core gather_conv ran before its redesign);
  4. drive ScenePipeline.step_frame at the full car width (V=120k,
     max_obj 90, 60 real dets, cls_id 2, max_age 4, bf16 trunk, random
     weights from a numpy seed loaded through load_jax_variables): warm-up,
     then three timed runs of 20 frames; check the softmax sums, the ids
     and that every frame launched rulebook_conv 11 times and keyed_conv
     10 times;
  5. run a small configuration on cuda and on cpu (plain versions): equal
     ids, used, keep and FN flags, refined scores within 1e-4;
  6. drive BatchedScenePipeline.step_frames at 4 lanes and the full car
     width (bench.py --lanes 4: seeds 0-3, 120k voxels and 60 real dets per
     lane): warm-up, then three timed runs of 10 steps, frames/s = lanes x
     steps / s; check the softmax sums, that each used row's id lies in
     [lane*1e6 + 1, (lane+1)*1e6) and that every step launched
     sorted_lookup 12 times, gather_conv 21 times and neither B=1 kernel;
  7. the small configuration at 2 lanes, f32: the batched step on cuda
     equals it on cpu (ids, used, keep, FN exact; ref at 1e-4), and each
     cuda lane equals a cuda ScenePipeline over that lane's frames (the
     new route against the B=1 route);
  8. the block-extraction probe (shasta_tpu_torch.probe_block_conv) at both
     probe shapes (s0, s1) on inputs whose rows hit: its run launches
     block_extract once per (shape, variant), 10 in all; then each variant
     against the plain version (f32, TF32 off, atol/rtol 1e-5) and the
     times;
  9. drive MultiClassScenePipeline over 7 classes at full width (car trunk,
     per-class max_obj of configs/nusc/*.py: car 90, pedestrian 90, truck
     60, trailer 60, bus 20, motorcycle 50, bicycle 50; the bench frame with
     host plans, min(60, max_obj) real dets per class, bf16 trunk, max_age
     4, random trees from numpy seeds through class_models_from_jax, one
     shared trunk): warm-up, then three timed runs of 20 frames, frames/s;
     check the softmax sums, ids unique across classes and stable on the
     repeated frame, exactly 11 + 10 trunk launches per frame and none of
     sorted_lookup/gather_conv/block_extract; print the peak device memory;
  10. a small configuration of 3 classes of different max_obj over 3
     frames, one class absent on the second: cuda equals cpu (ids, used,
     keep, FN exact; ref at 1e-4), and car, present on every frame, equals
     a cuda ScenePipeline of car alone (ids up to the class-major rebase).
The line before the last is {"kernels": [...]} (launches from phases 4, 6
and 8, times from phases 3, 3b and 8); the last is {"ok": true, "device":
{...}}. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

TIMED_FRAMES = 20
TIMED_RUNS = 3
WARMUP_FRAMES = 3
LANES = 4
TIMED_STEPS = 10
SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
             cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)
SMALL_CLASSES = {"car": 10, "pedestrian": 8, "bus": 6}
PROBE_ITERS = 20


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


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
    from shasta_tpu_torch.timing import median_ms

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
        ms = median_ms(lambda: kern(idx, f, w))
        plain_ms = median_ms(lambda: plain(idx, f, w))
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


def batched_calls(model, frame):
    """Run the 4-lane trunk once and return the arguments of its 12
    sorted_lookup and 21 gather_conv calls, in order, as the port built
    them (ops/sparse.py calls both by its module-level names)."""
    import torch

    from shasta_tpu_torch.ops import sparse as sp

    calls = {"sorted_lookup": [], "gather_conv": []}
    real = {name: getattr(sp, name) for name in calls}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return real[name](*args)
        return call

    try:
        for name in calls:
            setattr(sp, name, recorder(name))
        with torch.no_grad():
            model.bev_single(frame)
    finally:
        for name, fn in real.items():
            setattr(sp, name, fn)
    return calls["sorted_lookup"], calls["gather_conv"]


def staged_share(keys, q, mode):
    """(staged, tasks): of csrc/lookup.cu's tasks (64 consecutive rows of one
    query column) with a live probe, those whose largest probe's lower bound
    lies among the STAGE keys from the smallest probe's lower bound, so each
    lane searches in shared memory, not in the global table."""
    import torch

    from shasta_tpu_torch.ops.kernels.lookup import SENTINEL

    rows, stage = 64, 128  # csrc/lookup.cu TASK_ROWS, STAGE
    M, G = q.shape
    c = torch.cat([q.long(), q.new_full(((-M) % rows, G), SENTINEL).long()])
    live = c != SENTINEL
    lo, hi = c, c
    if mode == "triple":
        lo, hi = (c - 1).clamp(min=-2**31), (c + 1).clamp(max=SENTINEL - 1)
    mn = torch.where(live, lo, SENTINEL).reshape(-1, rows, G).amin(1)
    mx = torch.where(live, hi, -2**31).reshape(-1, rows, G).amax(1)
    k = keys.long()
    p_lo, p_hi = torch.searchsorted(k, mn), torch.searchsorted(k, mx)
    covered = (p_lo + stage >= k.shape[0]) | (p_hi < p_lo + stage)
    tasks = live.reshape(-1, rows, G).any(1)
    return int((tasks & covered).sum()), int(tasks.sum())


CONV_GROUPS = ("conv_input", "res0", "down1", "res1", "down2", "res2", "down3", "res3",
               "extra")


def phase_batched_kernels(model, frame):
    """Phase 3b: sorted_lookup and gather_conv against their plain versions
    at the 4-lane step's shapes, and their times (per step: the sum over
    the step's calls). Beside gather_conv, rulebook_conv on the same gather
    table: the same function on the CUDA-core core gather_conv.cuh, which
    gather_conv ran before its tensor-core redesign."""
    import torch

    from shasta_tpu_torch.ops.kernels import block_conv as bc
    from shasta_tpu_torch.ops.kernels import gather_conv as gc
    from shasta_tpu_torch.ops.kernels import lookup as lk
    from shasta_tpu_torch.timing import median_ms

    lookups, convs = batched_calls(model, frame)
    check(len(lookups) == 12 and len(convs) == 21,
          f"the 4-lane trunk made {len(lookups)} lookups and {len(convs)} convs")
    recs = {"sorted_lookup": dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                                  ops=0.0, err=0.0),
            "gather_conv": dict(ms=0.0, plain_ms=0.0, library_ms=None, bytes=0.0,
                                flops=0.0, err=0.0, cuda_core_ms=0.0)}
    rec = recs["sorted_lookup"]
    by_mode = collections.defaultdict(lambda: [0.0, 0.0])
    for keys, perm, q, mode in lookups:
        got, want = lk.sorted_lookup(keys, perm, q, mode), lk.sorted_lookup_plain(keys, perm, q, mode)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"sorted_lookup {mode} differs from its plain version")
        ms = median_ms(lambda: lk.sorted_lookup(keys, perm, q, mode))
        plain_ms = median_ms(lambda: lk.sorted_lookup_plain(keys, perm, q, mode))
        flat = q.reshape(-1)
        lib_ms = median_ms(lambda: torch.searchsorted(keys, flat, side="left"))
        V, (M, G), D = keys.shape[0], q.shape, (3 if mode == "triple" else 1)
        staged, tasks = staged_share(keys, q, mode)
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["library_ms"] += lib_ms
        rec["bytes"] += 4 * (M * G + M * G * D + V * (1 if perm is None else 2))
        rec["ops"] += M * G * D * max(1, V.bit_length())  # one compare per probe
        by_mode[mode][0] += ms
        by_mode[mode][1] += lib_ms
        print(f"  sorted_lookup  {mode:8s} V={V:8d} M={M:7d}x{G}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  searchsorted {lib_ms:.4f} ms  staged tasks "
              f"{staged}/{tasks}")
    print("  sorted_lookup per mode (kernel / searchsorted ms): " + ", ".join(
        f"{m} {a:.4f} / {b:.4f}" for m, (a, b) in by_mode.items()))

    g = torch.Generator(device="cpu").manual_seed(1)
    rec = recs["gather_conv"]
    groups = {}  # convs sharing input width, gather table and weight shape
    for f_path, idx, w_path in convs:
        groups.setdefault((f_path.shape, idx.data_ptr(), w_path.shape), []).append(idx)
    check(len(groups) == len(CONV_GROUPS), f"{len(groups)} conv groups in the 4-lane trunk")
    for group, ((f_shape, _, w_shape), calls) in zip(CONV_GROUPS, groups.items()):
        idx, n = calls[0], len(calls)
        (V, cin), (M, K), co = f_shape, idx.shape, w_shape[2]
        f32 = torch.randn(V, cin, generator=g).to(idx.device)
        w32 = (torch.randn(K, cin, co, generator=g) / (K * cin) ** 0.5).to(idx.device)
        for dt, atol, rtol in ((torch.float32, 1e-4, 0.0), (torch.bfloat16, 2e-2, 2e-2)):
            f, w = f32.to(dt), w32.to(dt)
            got, want = gc.gather_conv(f, idx, w), gc.gather_conv_plain(f, idx, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bad = float(((got - want).abs() - rtol * want.abs()).max())
            check(bad <= atol, f"gather_conv {group} {cin}->{co} M={M} {dt}: max abs err {err}")
            rec["err"] = max(rec["err"], err)
        # f, w are bf16 here: a second run gives the same bits (no atomics)
        check(torch.equal(gc.gather_conv(f, idx, w), got),
              f"gather_conv {group}: two bf16 runs differ")
        ms = median_ms(lambda: gc.gather_conv(f, idx, w))
        core_ms = median_ms(lambda: bc.rulebook_conv(f, idx, w))
        plain_ms = median_ms(lambda: gc.gather_conv_plain(f, idx, w))
        hits = int(((idx >= 0) & (idx < V)).sum())
        rec["ms"] += n * ms
        rec["cuda_core_ms"] += n * core_ms
        rec["plain_ms"] += n * plain_ms
        rec["bytes"] += n * (V * cin * 2 + M * K * 4 + K * cin * co * 2 + M * co * 4)
        rec["flops"] += n * 2.0 * hits * cin * co
        print(f"  gather_conv    {group:10s} {cin:3d}->{co:3d} K={K:2d} x{n}  V={V:7d} "
              f"M={M:7d} hits={hits:9d} ({hits / M:.3f}/row)  kernel {ms:.4f} ms  "
              f"CUDA-core core {core_ms:.4f} ms  plain {plain_ms:.4f} ms  (bf16)")
    return recs


def drive_batched(model, frame, steps):
    """Run `steps` step_frames calls of a fresh 4-lane pipeline (lanes
    reset on the first step, as bench.py does), fetching outputs two steps
    deep; returns the outputs."""
    from shasta_tpu_torch.infer import BatchedScenePipeline

    pipe = BatchedScenePipeline(model, cls_id=2, batch=LANES)
    outs, pending = [], collections.deque()
    for i in range(steps):
        out = pipe.step_frames(frame, [60] * LANES, [i == 0] * LANES,
                               [0.5] * LANES).start_fetch()
        pending.append(out)
        outs.append(out)
        if len(pending) > 2:
            pending.popleft().tid
    for out in pending:
        out.tid
    return outs


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


def phase_probe():
    """Phase 8: the probe's run (10 block_extract launches, counted), then
    each variant against its plain version and the times."""
    import torch

    from shasta_tpu_torch import probe_block_conv as probe
    from shasta_tpu_torch.ops.kernels import block_extract as be

    shape_cases = probe.cases("cuda")
    torch.cuda.synchronize()
    be.block_extract.launches = 0
    outs = probe.drive(shape_cases)
    torch.cuda.synchronize()
    launches = be.block_extract.launches
    check(launches == len(probe.SHAPES) * len(be.VARIANTS),
          f"the probe run launched block_extract {launches} times")
    recs = probe.measure(shape_cases, outs, PROBE_ITERS)
    for r in recs:
        print(f"  block_extract  {r['shape']} {r['variant']:9s} hits {r['hits']:8d} "
              f"nonzero rows {r['nonzero_rows']:6d}  kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"max abs err {r['max_abs_err']:.3g}")
        check(r["ok"], f"block_extract {r['shape']} {r['variant']} differs from its plain "
                       f"version (max abs err {r['max_abs_err']})")
        check(r["variant"] == "ohonly" or r["nonzero_rows"] > 0,
              f"block_extract {r['shape']} {r['variant']}: no row hit")
    return launches, recs


def drive_multiclass(pipe, frame, class_boxes, frames):
    """`frames` steps of the multi-class pipeline on the repeated frame,
    outputs fetched two frames deep; returns {name: StepOutput} per frame."""
    outs, pending = [], collections.deque()
    for _ in range(frames):
        packed, names = pipe.dispatch_frame(frame, class_boxes, 0.5)
        pending.append(packed.start_fetch())
        outs.append(pipe.unpack_frame(packed, names))
        if len(pending) > 2:
            pending.popleft().tid
    for out in pending:
        out.tid
    return outs


def small_scene(seed=0):
    """3 frames of one small scene for SMALL_CLASSES: shared voxels, boxes
    that move along their velocity; bus absent on the second frame."""
    import numpy as np

    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.models import ShastaConfig

    rng = np.random.default_rng(seed)
    base = make_batch(ShastaConfig(**SMALL), num_voxels_cap=2500, n_dets=7, seed=seed)
    boxes, counts = {}, {"car": 7, "pedestrian": 6, "bus": 4}
    for i, (n, m) in enumerate(SMALL_CLASSES.items()):
        b = make_batch(ShastaConfig(**dict(SMALL, max_obj=m)), num_voxels_cap=16,
                       n_dets=counts[n], seed=seed + 1 + i)["det_boxes"].copy()
        b[0, :counts[n], :2] = rng.uniform(-2.5, 2.5, (counts[n], 2))
        boxes[n] = b
    frames = []
    for t in range(3):
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


def phase_multiclass(pipe, frame, class_boxes, counted, n_frames):
    """Phase 9: warm-up, then TIMED_RUNS runs of TIMED_FRAMES frames of the
    multi-class step on the repeated frame; the launches per frame, the
    softmax sums, ids unique across classes and stable. Returns (median
    frames/s, the runs)."""
    import numpy as np
    import torch

    drive_multiclass(pipe, frame, class_boxes, WARMUP_FRAMES)
    torch.cuda.synchronize()
    for k in counted:
        k.launches = 0
    runs, outs = [], []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        outs += drive_multiclass(pipe, frame, class_boxes, TIMED_FRAMES)
        torch.cuda.synchronize()
        runs.append(TIMED_FRAMES / (time.perf_counter() - t0))
    launches = {k.__name__: k.launches for k in counted}
    fps = statistics.median(runs)
    print(f"phase 9: {TIMED_RUNS} runs of {TIMED_FRAMES} frames x {len(pipe.max_obj)} "
          f"classes at {[round(x, 3) for x in runs]} frames/s (median {fps:.3f}); "
          f"launches {launches}")
    check(launches == {"rulebook_conv": 11 * n_frames, "keyed_conv": 10 * n_frames,
                       "sorted_lookup": 0, "gather_conv": 0, "block_extract": 0},
          f"expected 11 + 10 trunk launches per multi-class frame, got {launches}")
    C, N = len(pipe.max_obj), pipe.n_max
    with torch.no_grad():
        feat, b = pipe._prev_feat[:, 0], pipe._prev_boxes[:, 0]
        m1, m2 = pipe.head(b[..., :7], b[..., :7], b[..., 7:9], b[..., 9:10], feat, feat,
                           n_real=pipe._n_real)
    check(tuple(m1.shape) == (C, N, N + 2)
          and bool(torch.isfinite(m1).all() & torch.isfinite(m2).all()),
          "multi-class affinity not finite")
    check(torch.allclose(m1.sum(2), torch.ones_like(m1.sum(2)), atol=1e-4)
          and torch.allclose(m2.sum(1), torch.ones_like(m2.sum(1)), atol=1e-4),
          "multi-class m1 rows / m2 columns do not sum to 1")
    stable = 0
    for prev, out in zip(outs, outs[1:]):
        ids = np.concatenate([o.tid[o.used] for o in out.values()])
        check(set(out) == set(class_boxes) and ids.size == np.unique(ids).size
              and bool((ids >= 1).all()), "multi-class ids are not unique across classes")
        for n, o in out.items():
            both = prev[n].used & o.used
            check(np.array_equal(prev[n].tid[both], o.tid[both]),
                  f"{n}: ids changed on the repeated frame")
            stable += int(both.sum())
    check(stable > 0, "no track carried over on the repeated frame")
    print(f"phase 9 checks ok; {stable} det rows kept their ids; last car ids "
          f"{outs[-1]['car'].tid[:8].tolist()}")
    return fps, runs


def phase_small_multiclass(dev_a, dev_b):
    """Phase 10: SMALL_CLASSES over `small_scene` on two devices, equal; and
    car, present on every frame, against a ScenePipeline of car alone on
    dev_a (ids up to the class-major rebase)."""
    import numpy as np

    from shasta_tpu_torch.convert import (class_models_from_jax, load_jax_variables,
                                          random_jax_variables)
    from shasta_tpu_torch.infer import MultiClassScenePipeline, ScenePipeline
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel

    cfgs = {n: ShastaConfig(**dict(SMALL, max_obj=m)) for n, m in SMALL_CLASSES.items()}
    trees = {n: random_jax_variables(ShastaModel(cfg, device="cpu"), seed=40 + i)
             for i, (n, cfg) in enumerate(cfgs.items())}
    models = class_models_from_jax(cfgs, trees)
    scene = small_scene()
    runs = {}
    for d in (dev_a, dev_b):
        pipe = MultiClassScenePipeline(models, trunk_key="car", device=d)
        runs[d] = [pipe.step_frame(f, cb, 0.5) for f, cb in scene]
    for t, (a, b) in enumerate(zip(runs[dev_a], runs[dev_b])):
        check(set(a) == set(b) == set(scene[t][1]), f"frame {t}: classes differ")
        for n in a:
            for field in ("tid", "used", "keep", "fn"):
                check(np.array_equal(getattr(a[n], field), getattr(b[n], field)),
                      f"3 classes frame {t}: {dev_a} and {dev_b} differ in {n} {field}")
            check(np.allclose(a[n].ref, b[n].ref, atol=1e-4),
                  f"3 classes frame {t}: {n} ref differs")
    car = ShastaModel(cfgs["car"], device=dev_a)
    load_jax_variables(car, trees["car"])
    single = ScenePipeline(car, cls_id=2)
    relabel = {}
    for t, ((f, cb), got) in enumerate(zip(scene, runs[dev_a])):
        s = single.step_frame(dict(f, det_boxes=cb["car"][0]), cb["car"][1], 0.5)
        g = got["car"]
        for field in ("used", "keep", "fn"):
            check(np.array_equal(getattr(g, field), getattr(s, field)),
                  f"frame {t}: car in the 3-class step and alone differ in {field}")
        check(np.allclose(g.ref, s.ref, atol=1e-4), f"frame {t}: car ref differs")
        for a, b in zip(s.tid[s.used], g.tid[g.used]):
            check(relabel.setdefault(int(a), int(b)) == b,
                  f"frame {t}: car id {a} alone maps to two ids")
    check(len(set(relabel.values())) == len(relabel) > 0, "car ids do not relabel 1:1")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from shasta_tpu_torch import resolve_device
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.infer import FRAME_KEYS, BatchedScenePipeline, ScenePipeline
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.ops.kernels import (block_conv, block_extract, build, gather_conv,
                                              lookup, window_conv)
    from shasta_tpu_torch.profile_step import car_setup, multiclass_setup
    from shasta_tpu_torch.timing import HBM_BYTES_PER_S, PEAK_OPS_PER_S

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
    for name in build.SOURCES:
        build.library(name)

    # bench-scale frame, its host plans and the bf16 model (bench.py:39-41,121-148)
    t0 = time.perf_counter()
    cfg, batch, plans, model, frame = car_setup(dev)
    print(f"set-up (frame, host plans, weights): {time.perf_counter() - t0:.2f} s")
    # the 4-lane frame and model of bench.py --lanes 4 (bench.py:75-97,121-134)
    t0 = time.perf_counter()
    cfg4, _, _, model4, frame4 = car_setup(dev, lanes=LANES)
    print(f"set-up, {LANES} lanes (frames, weights): {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    print("phase 3: kernels vs plain versions at main-path shapes")
    per_kernel = phase_kernels(cfg, batch, plans, dev)
    print(f"phase 3b: kernels vs plain versions at the {LANES}-lane step's shapes")
    per_kernel.update(phase_batched_kernels(model4, frame4))

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

    # 6. full-width scene-batched step, 4 lanes
    counted = (block_conv.rulebook_conv, window_conv.keyed_conv, lookup.sorted_lookup,
               gather_conv.gather_conv)
    drive_batched(model4, frame4, 2)
    torch.cuda.synchronize()
    for k in counted:
        k.launches = 0
    sps_runs, outs4 = [], []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        outs4 += drive_batched(model4, frame4, TIMED_STEPS)
        torch.cuda.synchronize()
        sps_runs.append(LANES * TIMED_STEPS / (time.perf_counter() - t0))
    launches6 = {k.__name__: k.launches for k in counted}
    launches.update(sorted_lookup=launches6["sorted_lookup"],
                    gather_conv=launches6["gather_conv"])
    fps4 = statistics.median(sps_runs)
    n_steps = TIMED_RUNS * TIMED_STEPS
    print(f"phase 6: {TIMED_RUNS} runs of {TIMED_STEPS} steps x {LANES} lanes at "
          f"{[round(x, 3) for x in sps_runs]} frames/s (median {fps4:.3f}); "
          f"launches {launches6}")
    check(launches6 == {"rulebook_conv": 0, "keyed_conv": 0, "sorted_lookup": 12 * n_steps,
                        "gather_conv": 21 * n_steps},
          f"expected 12 sorted_lookup + 21 gather_conv launches per step, got {launches6}")
    with torch.no_grad():
        feat = model4.frame_features(frame4)
        m1, m2 = model4.affinity_step(frame4["det_boxes"], frame4["det_boxes"], feat, feat)
    check(tuple(feat.shape) == (LANES,) + want_shape[1:] and bool(torch.isfinite(feat).all()),
          "4-lane descriptors are not finite")
    check(torch.allclose(m1.sum(2), torch.ones_like(m1.sum(2)), atol=1e-4)
          and torch.allclose(m2.sum(1), torch.ones_like(m2.sum(1)), atol=1e-4),
          "4-lane m1 rows / m2 columns do not sum to 1")
    for out in outs4:
        for lane in range(LANES):
            ids = out.tid[lane][out.used[lane]]
            check(ids.size > 0 and bool(((ids >= lane * 10**6 + 1)
                                         & (ids < (lane + 1) * 10**6)).all()),
                  f"lane {lane}: used ids {ids[:8]} outside its range")
    print(f"phase 6 checks ok; last ids of lane 3 {outs4[-1].tid[3][:6].tolist()}")

    # 7. small configuration, 2 lanes: cuda against cpu, and lanes against
    # single-scene pipelines on cuda
    lanes7 = 2
    parts = [[make_batch(small_cfg, num_voxels_cap=2500, n_dets=7, seed=10 * lane + t)
              for t in range(3)] for lane in range(lanes7)]
    frames7 = [{k: np.concatenate([parts[lane][t][k] for lane in range(lanes7)])
                for k in FRAME_KEYS} for t in range(3)]
    runs, models = {}, {}
    for d in ("cuda", "cpu"):
        m = models[d] = ShastaModel(small_cfg, device=d)
        load_jax_variables(m, random_jax_variables(m, seed=1))
        pipe7 = BatchedScenePipeline(m, cls_id=2, batch=lanes7)
        runs[d] = [pipe7.step_frames(f, [7] * lanes7, [t == 0] * lanes7, [0.5] * lanes7)
                   for t, f in enumerate(frames7)]
    for a, b in zip(runs["cuda"], runs["cpu"]):
        for field in ("tid", "used", "keep", "fn"):
            check(np.array_equal(getattr(a, field), getattr(b, field)),
                  f"2 lanes: cuda and cpu differ in {field}")
        check(np.allclose(a.ref, b.ref, atol=1e-4), "2 lanes: ref differs")
    for lane in range(lanes7):
        single = ScenePipeline(models["cuda"], cls_id=2)
        for t, got in enumerate(runs["cuda"]):
            s = single.step_frame({k: parts[lane][t][k] for k in FRAME_KEYS}, 7, 0.5)
            for field in ("used", "keep", "fn"):
                check(np.array_equal(getattr(got, field)[lane], getattr(s, field)),
                      f"lane {lane} frame {t}: batched and single differ in {field}")
            check(np.array_equal(np.where(s.used, got.tid[lane] - lane * 10**6, 0),
                                 np.where(s.used, s.tid, 0)),
                  f"lane {lane} frame {t}: batched and single ids differ")
            check(np.allclose(got.ref[lane], s.ref, atol=1e-4),
                  f"lane {lane} frame {t}: batched and single ref differ")
    print("phase 7: 2 lanes cuda == cpu, and each cuda lane == its single-scene run")

    # 8. the block-extraction probe
    print("phase 8: block_extract at the probe's shapes (s0, s1), five variants")
    launches["block_extract"], probe_recs = phase_probe()
    per_kernel["block_extract"] = dict(
        ms=sum(r["ms"] for r in probe_recs), plain_ms=sum(r["plain_ms"] for r in probe_recs),
        bound=sum(r["bound_ms"] for r in probe_recs), err=max(r["max_abs_err"] for r in probe_recs),
        by="operations" if sum(r["ops"] for r in probe_recs) / PEAK_OPS_PER_S["float32"]
        >= sum(r["bytes"] for r in probe_recs) / HBM_BYTES_PER_S else "bytes")
    print(f"phase 8: {launches['block_extract']} launches in the probe run, every variant "
          f"== its plain version")

    # 9. the fused 7-class step at full width
    counted = counted + (block_extract.block_extract,)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup9 = multiclass_setup(dev)
    print(f"set-up, 7 classes (class models on the host, stacked heads): "
          f"{time.perf_counter() - t0:.2f} s; classes {setup9[0].max_obj}")
    fps7, fps7_runs = phase_multiclass(*setup9, counted, n_frames)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 9: peak device memory {peak_gb:.3f} GiB ({smi})")
    del setup9

    # 10. small 3-class configuration: cuda against cpu, and car against a
    # single-class pipeline on cuda
    phase_small_multiclass("cuda", "cpu")
    print("phase 10: 3 classes cuda == cpu, and car == its single-class pipeline")

    kernels = []
    src = {"rulebook_conv": ("shasta_tpu_torch/csrc/block_conv.cu",
                             "shasta_tpu/ops/pallas/block_conv.py:117", "frame"),
           "keyed_conv": ("shasta_tpu_torch/csrc/window_conv.cu",
                          "shasta_tpu/ops/pallas/window_conv.py:719", "frame"),
           "sorted_lookup": ("shasta_tpu_torch/csrc/lookup.cu",
                             "shasta_tpu/ops/pallas/window_conv.py:170", "batched step"),
           "gather_conv": ("shasta_tpu_torch/csrc/gather_conv.cu",
                           "shasta_tpu/ops/pallas/window_conv.py:480", "batched step")}
    for name, rec in per_kernel.items():
        if name == "block_extract":
            continue
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = (rec["ops"] / PEAK_OPS_PER_S["int32"] if "ops" in rec
                 else rec["flops"] / PEAK_OPS_PER_S["bfloat16"]) * 1e3
        unit = src[name][2]
        n_units = n_frames if unit == "frame" else n_steps
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "launches_per": f"{launches[name] / n_units:g} per {unit} "
                            f"({launches[name]} over {n_units} {unit}s)",
            "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": rec.get("library_ms"),
            **({"cuda_core_ms": rec["cuda_core_ms"]} if "cuda_core_ms" in rec else {}),
            "per": (f"one {unit}'s launches (sum over its calls, each call's time the "
                    f"median of 10 CUDA-event-timed calls)"
                    + (" at bf16" if "flops" in rec else "")
                    + ("; cuda_core_ms: rulebook_conv on the same gather tables, the "
                       "CUDA-core core gather_conv.cuh that gather_conv ran before its "
                       "redesign" if "cuda_core_ms" in rec else "")
                    + ("; library: torch.searchsorted on the same flattened queries, "
                       "positions only (no perm gather, no hit test, one search per "
                       "triple centre)" if name == "sorted_lookup" else "")),
        })
    rec = per_kernel["block_extract"]
    kernels.append({
        "name": "block_extract", "route": "cuda",
        "source": "shasta_tpu_torch/csrc/block_extract.cu",
        "replaces": "tools/probe_block_conv.py:43", "launches": launches["block_extract"],
        "launches_per": "0 per serving frame; 10 per probe run",
        "max_abs_err": rec["err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound"], "bound_by": rec["by"], "library_ms": None,
        "per": "one probe run: the sum over its 10 launches (s0, s1 x five variants), "
               f"each the median of {PROBE_ITERS} CUDA-event-timed launches, f32; "
               "library: none, no "
               "PyTorch call computes the block extraction",
        "cases": [{k: r[k] for k in ("shape", "variant", "hits", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "max_abs_err")}
                  for r in probe_recs]})
    print(json.dumps({"frames_per_s": fps, "frames_per_s_runs": fps_runs,
                      "lanes4_frames_per_s": fps4, "lanes4_frames_per_s_runs": sps_runs,
                      "classes7_frames_per_s": fps7, "classes7_frames_per_s_runs": fps7_runs,
                      "classes7_peak_device_gib": peak_gb, "card": smi, "host": host}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
