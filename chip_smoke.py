#!/usr/bin/env python3
"""Build the PyTorch + CUDA port and drive its serving, training and offline paths on one card.

    python3 chip_smoke.py [--before CSRC]

Phases (any failure ends the run with a non-zero exit code):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build all six CUDA kernels from shasta_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. hold rulebook_conv and keyed_conv against their plain PyTorch
     versions on the card at the B=1 step's shapes (bench-scale frame:
     120k voxels, stage caps 50k/25k/12k/12k), f32 with TF32 off at atol
     1e-4 and bf16 at atol/rtol 2e-2, check that a second run of each
     dtype gives the same bits, and time the bf16 route, the path's (every
     kernel time in this script is shasta_tpu_torch.timing.median_ms: the
     median of calls each between two CUDA events); per conv, its hits per
     row and the tensor-core core its bf16 launch takes (warp or staged);
  3b. the same for sorted_lookup (all three modes, integer equality) and
     gather_conv at the 4-lane batched step's shapes: the index tables are
     the ones the port builds for the 4-lane frame (480k voxels, caps
     200k/100k/48k/48k); torch.searchsorted is timed beside sorted_lookup,
     with the share of its tasks that search in shared memory, and
     per mode; per conv group, gather_conv's hits per row, its core, a
     second run of each dtype that must give the same bits, and its time in
     the path's dtype (bf16 here; f32 on the CLI paths of phases 15-18 and
     20, where the bf16 core's time on the same tables stands beside it);
  3c, 3d. the same at the shapes of the B=1 frame without plans and of the
     two-frame forward (2 x 120k voxels, phase 13's caps);
  4. drive ScenePipeline.step_frame at the full car width (V=120k,
     max_obj 90, 60 real dets, cls_id 2, max_age 4, bf16 trunk, random
     weights from a numpy seed loaded through load_jax_variables) on the
     frame with its host plans attached: warm-up, then three timed runs of
     20 frames; check the softmax sums, the ids and that every frame
     launched rulebook_conv 11 times and keyed_conv 10 times;
  5. run a small configuration on cuda and on cpu (plain versions), with
     host plans and without: equal ids, used, keep and FN flags, refined
     scores within 1e-4;
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
     against the plain version (f32, TF32 off, atol/rtol 1e-5) and against
     a second launch (the same bits), and each time beside its bound and
     its share of it;
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
     a cuda ScenePipeline of car alone (ids up to the class-major rebase);
  11. ScenePipeline.step_frame on the bench frame WITHOUT plans (every index
     built on the card: sorted_lookup + gather_conv): each stage's output
     set against its cap, and equal to the host plans' set (both keep the
     cap's smallest keys where a set outgrows its cap), three timed runs of 20
     frames with the launches and the host planner's calls (0) counted,
     the phase-4 checks, the BEV maps' max abs difference and the det rows
     whose id differs from the planned route (printed, not gated at bf16),
     and both routes profiled (host wall and device busy per step);
  12. step_chunk of 4 frames at B=1 without plans and at 4 lanes equals 4
     single steps of a fresh pipeline (ids, used, keep, FN exact, ref at
     1e-5);
  13. the two-frame forward on one bench pair (curr seed 0, prev seed 1,
     caps that truncate neither frame's sets): 12 + 21 launches, shapes,
     softmax sums, and each frame's descriptors equal to frame_features of
     that frame alone (bf16, 2e-2);
  14. the device voxelizer (300k points into the 120k cap) and rotate_nms
     (500 boxes) against the port's numpy copies: voxels and keep masks
     exact;
  15. serve a synthetic preprocessed split (data.synthetic.write_track_split:
     2 scenes x 8 frames at the full car configuration, ~70k voxels a frame
     from a key cloud and 9 sweeps) with the port's CLIs on the card:
     random weights saved with save_checkpoint and loaded by the CLI
     (load_checkpoint + merge_pretrained), `tools.track_scene.main` through
     the unplanned trunk (12 sorted_lookup + 21 gather_conv per frame,
     counted), the path's 12 lookups and 21 f32 convs on one served frame
     each against its plain version as in phases 3b-3d, the same CLI on
     cuda and cpu at a small configuration (ids
     exact, tracking_score within 1e-4), `tools.track_multiclass.main` on
     car + pedestrian, eval_tracking_lite's AMOTA (a check that it runs),
     and the serving loop's frames/s with its host split per frame
     (dataset[i], step, formatting), the same frames from memory, the
     device busy share, the step's spans and the top kernels of one
     profiled pass, and no host-device synchronisation in a step fed from
     host arrays;
  16. the official per-class eval flow on a synthetic split (9 scenes x 3
     frames at the full car configuration, f32): `tools.eval.main --batch
     8` (6 steps, 12 sorted_lookup + 21 gather_conv each, counted;
     cp_val.json holds every token with finite ref_detection_score), each
     strided stage's set against its cap per lane on the first 8-lane step,
     that step's 12 lookups and 21 f32 convs against their plain versions,
     `--parity` over the first scene (12 + 21 per pair, counted),
     `tools.merge_results` and `tools.pub_test --skip_eval` (ids carried
     from frame to frame), the eval CLI on cuda and cpu at a small
     configuration with 3 lanes (annotations equal, ref_detection_score
     within 1e-4), the eval loop's frames/s (three runs) with its host split
     per frame (read, step, assemble), the device busy share of one profiled
     pass and no synchronisation in an 8-lane step fed from host arrays;
  17. train on the card (phase_training): a labelled synthetic train split
     (write_track_split(split="train"), 4 scenes x 6 frames at
     configs/nusc/car.py as it stands: 4 pairs a step, the doubled batch of
     8 frames under caps 100k/50k/25k/25k, f32 trunk) and random weights
     given as --checkpoint; `tools.train.main` for one epoch (12
     sorted_lookup + 21 gather_conv per step, counted, nothing else; finite
     losses; backbone and neck bit-equal before and after, shared conv and
     head moved; epoch_1.pth loads back; one log row per step); the train
     step's and a cache_features batch's 12 lookups and 21 f32 convs against
     their plain versions, and each stage's set per frame of the 8-frame
     batch against its cap; at a small configuration one step on cuda and
     on cpu, standard and bn_train, and a freeze_bev=False step that
     launches no kernel; `tools.cache_features --batch 8` (12 + 21 per
     batch, counted) and `tools.train --cached_features` for one epoch (no
     launch), the cached loss equal to the full loss at caps that hold
     every set; the train loop's pairs/s (waiting for the loader and the
     step, per step), one profiled step (device busy, top kernels, peak
     memory), the cached loop's pairs/s and the cache's frames/s;
  18. the offline chain and the oracle tracker (phase_chain): a synthetic
     nuScenes dataroot (data.synthetic.build_synthetic_world, 8 scenes x 40
     key frames, 40 moving cars and 60 false positives a frame) through the
     chain's CLIs in process, each timed per scene (make_scenes,
     preprocess_nuscenes, create_data, check_artifacts with no problem,
     estimate_stats), preprocess_nuscenes --mode 20hz on the micro tree;
     run_oracle_mot (giou, bipartite, kf) on cuda and with --cpu: track ids
     per frame and the MOTA summary exactly equal, the giou matrices of the
     first frames within 1e-5, the redundancy's one matrix per frame equal
     to its per-track calls bit for bit, frames/s on both and the device
     busy share of one profiled scene; then tools.track_scene serving the
     chain's first two scenes from the infos create_data wrote (12
     sorted_lookup + 21 gather_conv per frame, counted), the path's lookups
     and convs against their plain versions on two frames of that tree (a
     scene's first key frame, with no sweep, and its last, with 9) and, at a
     small configuration, the same CLI on cuda == on cpu;
  19. the Waymo readers, the Waymo oracle and the renderers (phase_waymo):
     synthetic raw segments (data.synthetic.build_synthetic_waymo, 2 x 20
     frames at 10 Hz: a real segment has ~198 frames, the one cut; the TOP
     lidar's 64 x 2650 range images with their pixel pose and four 200 x
     600 lasers, two returns each, zlib-compressed MatrixFloats, ~150k
     valid returns and 80 labelled objects a frame; GT and detection
     Objects bins, 150 boxes a frame) through tools.extract_waymo with
     every flag and tools.create_data --waymo, each stage timed per
     segment; load_waymo_scene -> MOTModel on cuda and on cpu (ids and
     eval_waymo_tracking's summaries equal, frames/s), write_objects_bin
     decoded back; tools.track_scene --render over the first scene of phase
     15's split (12 sorted_lookup + 21 gather_conv per frame, counted; the
     PNG's pixels equal render_scene_tracks' on the JSON) and
     tools.visualize_scene over the micro tree (6 files). Without
     matplotlib the two renders print "not run (matplotlib absent)" and the
     serving runs all the same;
  20. the model zoo, the registry and the profiler (phase_zoo): BEVMap
     built by register_all + build_from_cfg at configs/nusc/car.py's full
     width (f32) and loaded strictly from a trunk-only bev_map.pth of
     random weights; one bench frame (V=120k, no plans) launches 12
     sorted_lookup + 21 gather_conv and nothing else (counted), the map is
     (1, 180, 180, 512) and finite, the shared conv on it equals
     ShastaModel.bev_single of the same weights, the path's lookups and
     convs hold against their plain versions, and the forward is timed;
     PillarFeatureNet + point_pillars_scatter at CenterPoint's nuScenes
     PointPillars widths (30k pillars of 20 points, 512 x 512 canvas),
     dynamic_voxelize and _virtual over 300k points at the car config's
     range and voxel (cap 120k, and one case that overflows), DeformConv2d
     64 -> 64 at 1 x 180 x 180 (modulated and not) and deform_psroi_pooling
     (128 rois on 2 x 180 x 180 x 490, forward and gradients), each cuda
     against cpu; a profiler trace of one BEVMap forward, after another
     forward, holds its span and the 21 gather_conv kernels launched in
     it (matched to their launches by correlation id), StageTimer waits
     for the card and cost_analysis counts a 1024^3 matmul;
  21. the neck's conv kernel (phase_neck): dense_conv at the car neck's
     shapes (256 x 180 x 180 in, B=1 and B=8, f32) and at the pillar
     neck's (the published 64 x 512 x 512 canvas, B=1): each of the 15 and
     20 convs and the whole neck against the plain version (1e-4 x max(1,
     |out|)), 15 and 20 launches a neck call, and the time of each conv and
     of the neck beside its bound, the plain version and cuDNN's F.conv2d
     (TF32 off);
  22. the pillar trunk served (phase_pillars): configs/nusc/pp/car.py over
     a 2 x 6-frame split at 60,000 x 20 pillar slots through
     tools.track_scene, 20 dense_conv launches a frame and nothing else
     (counted), its map by the kernel route against `_run`, one traced
     frame's spans, counters and the kernels under step.neck, frames/s.
With --before CSRC, every f32 path's convs are also timed on gather_conv
built from that directory (a redesign's parent), in turns with this build.
The line before the last is {"kernels": [...]} (launches per main path
from the phases that drive one, 4, 6, 8, 9, 11, 12, 13, 15, 16, 17, 18,
19, 20 and 22, each counted from 0 just before it, dense_conv's among
them: 15 a frame, step, pair or batch on the f32 paths of phases 15-19, 14
a train step and a BEVMap frame, 20 a pillar frame, 0 on the bf16 steps;
times from phases 3-3d, 8, 15-18, 20 and 21);
the last is {"ok": true, "device": {...}}. Imports nothing of JAX or of the
JAX package.
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
PROFILE_FRAMES = 5
CHUNK_T = 4
# dense_conv launches of an f32 neck + shared conv on the card: the RPN's 12
# convs and 2 deblocks, the shared conv (one fewer where the shared conv
# trains, on cuDNN, or is absent, as in BEVMap); the bf16 steps launch none
NECK_CONVS = 15
# caps of the two-frame forward's pair (bench frames of seeds 0 and 1): its
# sets, 714835/942028/316660/129521, kept whole, so each frame's map is the
# map of that frame alone (the bench caps 50k/25k/12k/12k per frame keep a
# frame's smallest keys, and at 2B the curr frame's keys fill them)
PAIR_CAPS = dict(cap_conv2=720000, cap_conv3=950000, cap_conv4=320000, cap_extra=130000)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_kernels(cfg, frame, plans, dev):
    """Phase 3: each kernel against its plain version, a second bf16 run
    against the first (the same bits), and their times; per conv the hits
    per row and the tensor-core core the bf16 launch takes."""
    import torch

    from shasta_tpu_torch.ops.kernels import block_conv, window_conv
    from shasta_tpu_torch.ops.kernels.gather_conv import mma_core
    from shasta_tpu_torch.profile_step import b1_conv_cases
    from shasta_tpu_torch.timing import median_ms

    # each as fn(index tensors, feats, weight)
    fns = {"rulebook_conv": (lambda i, f, w: block_conv.rulebook_conv(f, *i, w),
                             lambda i, f, w: block_conv.rulebook_conv_plain(f, *i, w)),
           "keyed_conv": (lambda i, f, w: window_conv.keyed_conv(*i, f, w),
                          lambda i, f, w: window_conv.keyed_conv_plain(*i, f, w))}
    g = torch.Generator(device="cpu").manual_seed(0)
    per_kernel = collections.defaultdict(lambda: dict(ms=0.0, plain_ms=0.0, bytes=0.0,
                                                      flops=0.0, err=0.0, dtype="bfloat16"))
    for name, case, n, V, cin, co, idx in b1_conv_cases(cfg, frame, plans, dev):
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
            # no atomics: a second run gives the same bits
            check(torch.equal(kern(idx, f, w), got), f"{name} {case}: two {dt} runs differ")
        # the main path's dtype: bf16 (f, w are bf16 here)
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
        print(f"  {name:14s} {case:20s} x{n}  M={M:6d} hits={hits:8d} ({hits / M:.3f}/row)  "
              f"core {mma_core(K, cin, co, f.dtype)}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"(bf16)")
    return per_kernel


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


def phase_gather_kernels(label, run):
    """Phases 3b-3d, 15-18 and 20: the 12 sorted_lookup and 21 gather_conv
    calls that `run()` makes (one unplanned trunk pass: the 4-lane step, the
    B=1 step without plans, the two-frame forward, a served split's frame,
    an 8-lane eval step, a train step or cache batch, a frame of the chain's
    tree, BEVMap's frame),
    each against its plain version on its own arguments (a conv also on
    seeded f32 and bf16 features at its gather table), a second run of each
    dtype (the same bits) and the times (per path: the sum over its calls).
    A conv is timed in the path's own dtype (f32 on every CLI path, bf16 on
    the steps'); on an f32 path also the bf16 core on the same tables
    (`bf16_ms`) and, with --before, the f32 route of another build in turns
    with this one (`before_ms`)."""
    import torch

    from shasta_tpu_torch.ops.kernels import gather_conv as gc
    from shasta_tpu_torch.ops.kernels import lookup as lk
    from shasta_tpu_torch.probe_b1_routes import recorded
    from shasta_tpu_torch.timing import median_ms

    with recorded("sorted_lookup", "gather_conv") as calls, torch.no_grad():
        run()
    lookups, convs = calls["sorted_lookup"], calls["gather_conv"]
    check(len(lookups) == 12 and len(convs) == 21,
          f"{label}: the trunk made {len(lookups)} lookups and {len(convs)} convs")
    dtypes = {f.dtype for f, _, _ in convs}
    check(len(dtypes) == 1, f"{label}: the trunk's convs mix {dtypes}")
    path_dt = dtypes.pop()
    recs = {"sorted_lookup": dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                                  ops=0.0, err=0.0),
            "gather_conv": dict(ms=0.0, plain_ms=0.0, library_ms=None, bytes=0.0,
                                flops=0.0, err=0.0, dtype=str(path_dt).split(".")[-1])}
    if path_dt == torch.float32:
        recs["gather_conv"]["bf16_ms"] = 0.0
        if BEFORE_CONV is not None:
            recs["gather_conv"]["before_ms"] = 0.0
    rec = recs["sorted_lookup"]
    by_mode = collections.defaultdict(lambda: [0.0, 0.0])
    for keys, perm, q, mode in lookups:
        got, want = lk.sorted_lookup(keys, perm, q, mode), lk.sorted_lookup_plain(keys, perm, q, mode)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{label}: sorted_lookup {mode} differs from its plain version")
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
        groups.setdefault((f_path.shape, idx.data_ptr(), w_path.shape), []).append(
            (f_path, idx, w_path))
    check(len(groups) == len(CONV_GROUPS), f"{label}: {len(groups)} conv groups in the trunk")
    for group, ((f_shape, _, w_shape), calls) in zip(CONV_GROUPS, groups.items()):
        idx, n = calls[0][1], len(calls)
        (V, cin), (M, K), co = f_shape, idx.shape, w_shape[2]
        # the path's own features and weights, in its dtype: max abs error
        # within 1e-4 (f32) or 2e-2 (bf16) of the output's scale (at least 1)
        own_err = 0.0
        for f_path, idx_path, w_path in calls:
            got = gc.gather_conv(f_path, idx_path, w_path).float()
            want = gc.gather_conv_plain(f_path, idx_path, w_path)
            torch.cuda.synchronize()
            tol = (1e-4 if f_path.dtype == torch.float32 else 2e-2) * max(
                1.0, float(want.abs().max()))
            own = float((got - want).abs().max())
            check(own <= tol, f"{label}: gather_conv {group} on the path's {f_path.dtype} "
                              f"inputs: max abs err {own} > {tol}")
            own_err = max(own_err, own)
        f32 = torch.randn(V, cin, generator=g).to(idx.device)
        w32 = (torch.randn(K, cin, co, generator=g) / (K * cin) ** 0.5).to(idx.device)
        seeded = {}
        for dt, atol, rtol in ((torch.float32, 1e-4, 0.0), (torch.bfloat16, 2e-2, 2e-2)):
            f, w = seeded[dt] = f32.to(dt), w32.to(dt)
            got, want = gc.gather_conv(f, idx, w), gc.gather_conv_plain(f, idx, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bad = float(((got - want).abs() - rtol * want.abs()).max())
            check(bad <= atol, f"{label}: gather_conv {group} {cin}->{co} M={M} {dt}: "
                               f"max abs err {err}")
            rec["err"] = max(rec["err"], err)
            # no atomics: a second run gives the same bits
            check(torch.equal(gc.gather_conv(f, idx, w), got),
                  f"{label}: gather_conv {group}: two {dt} runs differ")
        f, w = seeded[path_dt]
        kern = lambda: gc.gather_conv(f, idx, w)  # noqa: E731
        extra = ""
        if "before_ms" in rec:  # this build and the other in turns: other, this, this, other
            before = lambda: BEFORE_CONV(f, idx, w)  # noqa: E731
            want = gc.gather_conv_plain(f, idx, w)
            err = float((before() - want).abs().max())
            check(err <= 1e-4 * max(1.0, float(want.abs().max())),
                  f"{label}: --before gather_conv {group}: max abs err {err}")
            turns = [median_ms(fn) for fn in (before, kern, kern, before)]
            ms, before_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            rec["before_ms"] += n * before_ms
            extra += f"  --before {before_ms:.4f} ms"
        else:
            ms = median_ms(kern)
        plain_ms = median_ms(lambda: gc.gather_conv_plain(f, idx, w))
        if "bf16_ms" in rec:
            fb, wb = seeded[torch.bfloat16]
            bf16_ms = median_ms(lambda: gc.gather_conv(fb, idx, wb))
            rec["bf16_ms"] += n * bf16_ms
            extra += f"  bf16 core {bf16_ms:.4f} ms"
        hits = int(((idx >= 0) & (idx < V)).sum())
        isz = f.element_size()
        rec["ms"] += n * ms
        rec["plain_ms"] += n * plain_ms
        rec["bytes"] += n * (V * cin * isz + M * K * 4 + K * cin * co * isz + M * co * 4)
        rec["flops"] += n * 2.0 * hits * cin * co
        print(f"  gather_conv    {group:10s} {cin:3d}->{co:3d} K={K:2d} x{n}  V={V:7d} "
              f"M={M:7d} hits={hits:9d} ({hits / M:.3f}/row)  core "
              f"{gc.mma_core(K, cin, co, path_dt)}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  ({rec['dtype']}){extra}; on the path's inputs max abs err {own_err:.3g}")
    for name, r in recs.items():
        print(f"  {label}: {name} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              + (f", searchsorted {r['library_ms']:.4f} ms" if r["library_ms"] else "")
              + (f" ({r['dtype']}), bf16 core {r['bf16_ms']:.4f} ms" if "bf16_ms" in r else "")
              + (f", --before {r['before_ms']:.4f} ms" if "before_ms" in r else ""))
    return recs


# gather_conv's f32 route built from another checkout's csrc (--before): the
# same launch, to time a redesign's parent beside it on the same tables
BEFORE_CONV = None


def load_before_conv(csrc):
    """gather_conv on the kernels built from `csrc` (another checkout's
    shasta_tpu_torch/csrc, whose gather_conv_launch has this one's C
    signature)."""
    from pathlib import Path

    from shasta_tpu_torch.ops.kernels import build
    from shasta_tpu_torch.ops.kernels.gather_conv import build_conv

    return build_conv(build.build_variant("gather_conv", "before", src=Path(csrc)))


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
    each variant against its plain version and a rerun, and the times."""
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
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{100 * r['share']:.1f}% of it)  max abs err {r['max_abs_err']:.3g}")
        check(r["ok"], f"block_extract {r['shape']} {r['variant']} differs from its plain "
                       f"version (max abs err {r['max_abs_err']})")
        check(r["same_bits"], f"block_extract {r['shape']} {r['variant']}: two runs differ")
        check(r["variant"] == "ohonly" or r["nonzero_rows"] > 0,
              f"block_extract {r['shape']} {r['variant']}: no row hit")
    neg = probe.negative_bases(shape_cases)
    for r in neg:
        check(r["ok"], f"block_extract {r['shape']} {r['variant']} at base {r['r']} differs "
                       f"from its plain version (max abs err {r['max_abs_err']})")
    print(f"  block_extract at bases -1, -2 and -NBr (first and last tile): {len(neg)} cases "
          f"== the plain version, max abs err {max(r['max_abs_err'] for r in neg):.3g}")
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
    frames/s, the runs, the launches)."""
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
                       "sorted_lookup": 0, "gather_conv": 0, "block_extract": 0,
                       "dense_conv": 0},
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
    return fps, runs, launches


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


def counted(kernels, run):
    """run() with every kernel's launch count set to 0 just before and read
    just after: (its result, {kernel name: launches})."""
    import torch

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels}


def check_affinity(m1, m2, label):
    import torch

    check(bool(torch.isfinite(m1).all() & torch.isfinite(m2).all()), f"{label}: affinity not finite")
    check(torch.allclose(m1.sum(2), torch.ones_like(m1.sum(2)), atol=1e-4)
          and torch.allclose(m2.sum(1), torch.ones_like(m2.sum(1)), atol=1e-4),
          f"{label}: m1 rows / m2 columns do not sum to 1")


def phase_unplanned(model, frame, planned_outs, kernels):
    """Phase 11: the B=1 step without plans on the bench frame: each stage's
    set against its cap, timed runs with the launches and the host
    planner's calls counted, the checks, the BEV maps and the ids beside
    the planned route's, and a profile of both routes (host wall and device
    busy per step). Returns (median frames/s, runs, launches, profiles)."""
    import torch

    from shasta_tpu_torch.ops import sparse as sp
    from shasta_tpu_torch.plans import frame_plans
    from shasta_tpu_torch.probe_b1_routes import stage_sets
    from shasta_tpu_torch.profile_step import profile_steps, step_fn, without_plans

    nop = without_plans(frame)
    for st, key in zip(stage_sets(lambda: model.bev_single(nop)),
                       ("d1_keys", "d2_keys", "d3_keys", "ex_keys")):
        print(f"  {st['name']:6s} output set {st['distinct']:7d} of cap {st['cap']:7d}"
              + (" (truncated to the cap's smallest keys)" if st["distinct"] > st["cap"] else ""))
        # the set built on the card is the host plans' set, truncated alike
        coords, valid, _ = sp.decode_strided_keys(frame["plan_" + key], *st["geometry"], 1)
        check(torch.equal(coords, st["coords"]) and torch.equal(valid, st["valid"]),
              f"{st['name']}: the set built on the card differs from the host plans'")
    drive_pipeline(model, nop, 60, WARMUP_FRAMES)
    frame_plans.calls = 0
    runs, outs = [], []

    def timed():
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            outs.extend(drive_pipeline(model, nop, 60, TIMED_FRAMES))
            torch.cuda.synchronize()
            runs.append(TIMED_FRAMES / (time.perf_counter() - t0))
    _, launches = counted(kernels, timed)
    n = TIMED_RUNS * TIMED_FRAMES
    fps = statistics.median(runs)
    print(f"phase 11: {TIMED_RUNS} runs of {TIMED_FRAMES} frames at "
          f"{[round(x, 3) for x in runs]} frames/s (median {fps:.3f}); launches {launches}; "
          f"host planner calls {frame_plans.calls}")
    check(frame_plans.calls == 0, f"the unplanned step called the host planner "
                                  f"{frame_plans.calls} times")
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * n, gather_conv=21 * n)
    check(launches == want, f"expected 12 sorted_lookup + 21 gather_conv launches per "
                            f"unplanned frame, got {launches}")
    with torch.no_grad():
        feat = model.frame_features(nop)
        m1, m2 = model.affinity_step(nop["det_boxes"], nop["det_boxes"], feat, feat)
        bev_diff = float((model.bev_single(nop) - model.bev_single(frame)).abs().max())
    check_affinity(m1, m2, "unplanned B=1")
    for out in outs:
        check(out.used.any() and bool((out.tid[out.used] >= 1).all()),
              "unplanned: a used det row has no id >= 1")
    # the last run of each route, frame by frame from a fresh pipeline
    rows = sum(int((a.tid != b.tid).sum()) for a, b in zip(outs[-TIMED_FRAMES:],
                                                          planned_outs[-TIMED_FRAMES:]))
    print(f"phase 11 checks ok; against the planned route: BEV max abs diff {bev_diff:.4g} "
          f"(bf16), det rows whose id differs {rows} of "
          f"{TIMED_FRAMES * outs[-1].tid.shape[-1]} (not gated)")
    profiles = {}
    for label, f in (("planned", frame), ("unplanned", nop)):
        step = step_fn(model, f, 1)
        for _ in range(2):
            step().tid
        p = profile_steps(step, PROFILE_FRAMES)
        profiles[label] = {k: p[k] for k in ("wall_ms", "busy_ms", "launches")}
        print(f"  {label:9s} profiled: host wall {p['wall_ms']:.3f} ms, device busy "
              f"{p['busy_ms']:.3f} ms per step ({100 * p['busy_ms'] / p['wall_ms']:.1f}%), "
              f"{p['launches']:.0f} kernels and copies; trunk span (host, device) "
              f"{tuple(round(x, 3) for x in p['spans'].get('step.sparse_trunk', (0, 0)))}")
    return fps, runs, launches, profiles


def moving(frame, t):
    """The frame with its dets moved 0.2 m per step along x and y."""
    boxes = frame["det_boxes"].clone()
    boxes[..., :2] += 0.2 * t
    return dict(frame, det_boxes=boxes)


def same_outputs(got, want, label):
    import numpy as np

    for field in ("tid", "used", "keep", "fn"):
        check(np.array_equal(getattr(got, field), getattr(want, field)),
              f"{label}: {field} differs")
    check(np.allclose(got.ref, want.ref, atol=1e-5, rtol=0), f"{label}: ref differs")


def phase_chunk(model, frame, model4, frame4, kernels):
    """Phase 12: step_chunk of T frames at B=1 (no plans) and at 4 lanes
    against T single steps of a fresh pipeline. Returns the chunks'
    launches."""
    import torch

    from shasta_tpu_torch.infer import BatchedScenePipeline, ScenePipeline
    from shasta_tpu_torch.profile_step import without_plans

    T = CHUNK_T
    frames = [moving(without_plans(frame), t) for t in range(T)]
    single = ScenePipeline(model, cls_id=2)
    want = [single.step_frame(f, 60, 0.5) for f in frames]
    stacked = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    pipe = ScenePipeline(model, cls_id=2)
    got, launches = counted(kernels, lambda: pipe.step_chunk(stacked, [60] * T, [0.5] * T))
    check(got.tid.shape == (T, 2 * model.cfg.max_obj), f"B=1 chunk shape {got.tid.shape}")
    for t in range(T):
        same_outputs(At(got, t), want[t], f"B=1 chunk step {t}")
    frames4 = [moving(frame4, t) for t in range(T)]
    single4 = BatchedScenePipeline(model4, cls_id=2, batch=LANES)
    want4 = [single4.step_frames(f, [60] * LANES, [t == 0] * LANES, [0.5] * LANES)
             for t, f in enumerate(frames4)]
    stacked4 = {k: torch.stack([f[k] for f in frames4]) for k in frames4[0]}
    pipe4 = BatchedScenePipeline(model4, cls_id=2, batch=LANES)
    resets = [[t == 0] * LANES for t in range(T)]
    got4, launches4 = counted(kernels, lambda: pipe4.step_chunk(
        stacked4, [[60] * LANES] * T, resets, [[0.5] * LANES] * T))
    check(got4.tid.shape == (T, LANES, 2 * model.cfg.max_obj), f"4-lane chunk {got4.tid.shape}")
    for t in range(T):
        same_outputs(At(got4, t), want4[t], f"4-lane chunk step {t}")
    for name, n in (("B=1", launches), (f"{LANES} lanes", launches4)):
        want_l = {k.__name__: 0 for k in kernels}
        want_l.update(sorted_lookup=12 * T, gather_conv=21 * T)
        check(n == want_l, f"{name} chunk launches {n}")
    print(f"phase 12: step_chunk of {T} frames == {T} single steps (ids, used, keep, fn exact; "
          f"ref at 1e-5) at B=1 without plans and at {LANES} lanes; launches {launches}, "
          f"{launches4}")
    return {k: launches[k] + launches4[k] for k in launches}


class At:
    """Step t of a chunk's StepOutput, with StepOutput's fields."""

    def __init__(self, out, t):
        self._out, self._t = out, t

    def __getattr__(self, field):
        return getattr(self._out, field)[self._t]


def phase_forward(model2, frame2, kernels):
    """Phase 13: the two-frame forward on one bench pair (lane 0 of the
    2-lane frame as curr, lane 1 as prev: 2 x 120k voxels, PAIR_CAPS, which
    must truncate no set): launches, shapes, softmax sums, and each frame's
    descriptors against frame_features of that frame alone (bf16, 2e-2).
    Returns the launches."""
    import torch

    from shasta_tpu_torch.core.bilinear import sample_bev_features
    from shasta_tpu_torch.core.boxes import box_points_5
    from shasta_tpu_torch.infer import FRAME_KEYS

    from shasta_tpu_torch.probe_b1_routes import stage_sets

    c = model2.cfg
    batch = {k: frame2[k][:1] for k in FRAME_KEYS}
    batch.update({"prev_" + k: frame2[k][1:2] for k in FRAME_KEYS})
    sets = stage_sets(lambda: model2.bev_maps(batch))
    print("  pair's output sets of caps: " + ", ".join(
        f"{st['name']} {st['distinct']} of {st['cap']}" for st in sets))
    check(all(st["distinct"] <= st["cap"] for st in sets), "a cap truncates the pair's sets")
    with torch.no_grad():
        (m1, m2), launches = counted(kernels, lambda: model2(batch))
        N = c.max_obj
        check(tuple(m1.shape) == (1, N, N + 2) and tuple(m2.shape) == (1, N + 2, N),
              f"forward shapes {tuple(m1.shape)}, {tuple(m2.shape)}")
        check_affinity(m1, m2, "two-frame forward")
        bev, prev_bev = model2.bev_maps(batch)
        err = 0.0
        for b, p in ((bev, ""), (prev_bev, "prev_")):
            boxes = batch[p + "det_boxes"]
            feat = sample_bev_features(b, box_points_5(boxes[..., :7]), c.pc_start,
                                       c.voxel_size, c.out_stride)
            alone = model2.frame_features({k: batch[p + k] for k in FRAME_KEYS})
            e = float((feat - alone).abs().max())
            err = max(err, e)
            check(torch.allclose(feat, alone, atol=2e-2, rtol=2e-2),
                  f"forward {p or 'curr '}descriptors differ from frame_features: {e}")
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12, gather_conv=21)
    check(launches == want, f"expected 12 + 21 launches per two-frame forward, got {launches}")
    print(f"phase 13: two-frame forward ok; launches {launches}; descriptors vs frame_features "
          f"max abs diff {err:.4g} (bf16, 2e-2)")
    return launches


def phase_box_ops(dev):
    """Phase 14: the device voxelizer on ~300k points into a 120k-voxel cap,
    and rotated NMS over 500 boxes, against the port's numpy copies: voxels
    exact (the numpy voxels in grid-key order), keep masks exact."""
    import numpy as np
    import torch

    from shasta_tpu_torch.ops import nms, voxelize

    rng = np.random.default_rng(14)
    # a sweep-like cloud: 300k points around 40k surface spots, ~97k voxels
    # of a 0.1 m grid (under the cap: there the two voxel orders keep the
    # same set)
    vs, cr = [0.1, 0.1, 0.2], [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
    centers = rng.uniform([-50, -50, -3], [50, 50, 1], size=(40000, 3))
    pts = np.concatenate([centers[rng.integers(0, len(centers), 300000)]
                          + rng.normal(0, 0.02, (300000, 3)),
                          rng.uniform(0, 1, (300000, 2))], 1).astype(np.float32)
    t0 = time.perf_counter()
    vn, cn, nn = voxelize.points_to_voxel_np(pts, vs, cr, 10, 120000)
    np_s = time.perf_counter() - t0
    tp = torch.from_numpy(pts).to(dev)
    voxelize.points_to_voxel(tp, vs, cr, 10, 120000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, c, n, valid = voxelize.points_to_voxel(tp, vs, cr, 10, 120000)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    k = int(valid.sum())
    check(k == len(cn) < 120000, f"voxels: {k} on the card, {len(cn)} on the host (cap 120000)")
    gs = voxelize.grid_size(vs, cr)
    order = np.argsort((cn[:, 0].astype(np.int64) * gs[1] + cn[:, 1]) * gs[0] + cn[:, 2])
    check(np.array_equal(c[:k].cpu().numpy(), cn[order])
          and np.array_equal(n[:k].cpu().numpy(), nn[order])
          and np.array_equal(v[:k].cpu().numpy(), vn[order]), "voxels differ from the numpy copy")
    boxes = np.zeros((500, 7), np.float32)
    boxes[:, :2] = rng.uniform(-30, 30, (500, 2))
    boxes[:, 2] = rng.uniform(-1, 1, 500)
    boxes[:, 3:6] = rng.uniform(1, 5, (500, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 500)
    scores = rng.uniform(0, 1, 500).astype(np.float32)
    tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    nms.rotate_nms(tb, ts, 0.2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keep = nms.rotate_nms(tb, ts, 0.2).cpu().numpy()
    nms_s = time.perf_counter() - t0
    want = np.zeros(500, bool)
    want[nms.rotate_nms_np(boxes, scores, 0.2)] = True
    check(np.array_equal(keep, want), f"rotate_nms keeps {keep.sum()}, the numpy copy "
                                      f"{want.sum()}, {int((keep != want).sum())} differ")
    print(f"phase 14: {len(pts)} points -> {k} voxels == the numpy copy (host {np_s * 1e3:.1f} ms, "
          f"card {dev_s * 1e3:.1f} ms, host clock); rotate_nms over 500 boxes keeps "
          f"{int(keep.sum())} == the numpy copy (card {nms_s * 1e3:.1f} ms)")


SERVE_SCENES, SERVE_FRAMES = 2, 8
SERVE_LABEL = "served split frame"
# the small geometry of the cuda-against-cpu run of phase 15
SERVE_SMALL = dict(
    max_objects=10,
    model=dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-12.0, -12.0), voxel_size=(0.3, 0.3),
               cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500),
    point_pipeline=dict(voxel_size=(0.3, 0.3, 0.2), pc_range=(-12.0, -12.0, -5.0, 12.0, 12.0, 3.0),
                        max_voxels=3000, nsweeps=3))


def same_result(got, want, label, score="tracking_score"):
    """Two results (tracking, or cp_{split}.json with score
    "ref_detection_score"): the same tokens and annotations, every other
    value exact, the score within 1e-4. Returns the annotation count."""
    check(list(got["results"]) == list(want["results"]), f"{label}: tokens differ")
    n = 0
    for tok, w_annos in want["results"].items():
        g_annos = got["results"][tok]
        check(len(g_annos) == len(w_annos), f"{label} {tok}: {len(g_annos)} annotations, "
                                            f"want {len(w_annos)}")
        for g, w in zip(g_annos, w_annos):
            check(g.keys() == w.keys() and all(g[k] == w[k] for k in w if k != score),
                  f"{label} {tok}: {g} differs from {w}")
            check(abs(g[score] - w[score]) <= 1e-4,
                  f"{label} {tok}: {score} {g[score]} vs {w[score]}")
            n += 1
    return n


def random_checkpoint(cfg, path, seed):
    """A .pth of seeded random weights for cfg's model (save_checkpoint)."""
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.tools.common import build_model
    from shasta_tpu_torch.train.checkpoint import save_checkpoint

    model = build_model(cfg, "cpu")
    load_jax_variables(model, random_jax_variables(model, seed=seed))
    save_checkpoint(path, model.state_dict())
    return path


def phase_serving(kernels, smi):
    """Phase 15: serve a synthetic preprocessed split (write_track_split, the
    full car configuration) with the port's CLIs on the card: the host
    runtime, checkpoint save and load, the track_scene CLI (every frame
    through the unplanned trunk: sorted_lookup + gather_conv, launches
    counted), the path's lookups and convs on one served frame against
    their plain versions (phase_gather_kernels), the same CLI on cuda and
    on cpu at a small configuration, the multi-class CLI on car +
    pedestrian, eval_tracking_lite, and the serving loop's frames/s with its
    host split per frame (reading plus voxelization, step, formatting), the
    device busy share of one pass and the loop over frames already in
    memory; a step fed from host arrays must not synchronise with the card.
    Returns (launches, the path's kernel records, numbers)."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch import runtime
    from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
    from shasta_tpu_torch.device import upload
    from shasta_tpu_torch.infer import FRAME_KEYS, track_scene_dataset
    from shasta_tpu_torch.profile_step import sync_calls
    from shasta_tpu_torch.tools import track_multiclass, track_scene
    from shasta_tpu_torch.tools.common import build_dataset, build_pipeline, load_model
    from shasta_tpu_torch.tracker.runner import eval_tracking_lite
    from shasta_tpu_torch.utils import Config

    check(runtime.available(), "the host runtime (host_ops.cpp) does not build")
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_serving")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    configs = os.path.join(repo, "configs", "nusc")
    t0 = time.perf_counter()
    sp = write_track_split(os.path.join(root, "data"),
                           Config.fromfile(os.path.join(configs, "car.py")),
                           n_scenes=SERVE_SCENES, n_frames=SERVE_FRAMES, seed=15)
    # the configs and checkpoints under the file names of track_multiclass.CFG_NAME
    stems = {"car": "car", "pedestrian": "ped"}
    cfg_paths = {n: write_split_config(os.path.join(configs, f"{stem}.py"), sp["val"],
                                       os.path.join(root, f"{stem}.py"))
                 for n, stem in stems.items()}
    cfgs = {n: Config.fromfile(p) for n, p in cfg_paths.items()}
    ckpts = {n: random_checkpoint(cfgs[n], os.path.join(root, f"{stem}.pth"), seed=15 + i)
             for i, (n, stem) in enumerate(stems.items())}
    n = SERVE_SCENES * SERVE_FRAMES
    print(f"phase 15: wrote a {SERVE_SCENES} x {SERVE_FRAMES}-frame split and two random "
          f".pth checkpoints in {time.perf_counter() - t0:.1f} s")

    # the CLI on the card, counted
    out = os.path.join(root, "cuda", "tracking_result.json")
    args = ["--config", cfg_paths["car"], "--checkpoint", ckpts["car"], "--out", out]
    result, launches = counted(kernels, lambda: track_scene.main(args))
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * n, gather_conv=21 * n, dense_conv=NECK_CONVS * n)
    check(launches == want, f"serving CLI: expected 12 sorted_lookup + 21 gather_conv + "
                            f"{NECK_CONVS} dense_conv launches per frame, got {launches}")
    with open(out) as f:
        check(json.load(f) == result, "serving CLI: the file differs from the result")
    check(list(result["results"]) == sp["tokens"], "serving CLI: tokens out of order")
    annos = [a for v in result["results"].values() for a in v]
    check(len(annos) > 0 and all(np.isfinite(a["tracking_score"]) and int(a["tracking_id"]) >= 1
                                 and a["tracking_name"] == "car" for a in annos),
          "serving CLI: an annotation has no id >= 1, a score that is not finite or "
          "another class")
    lite = eval_tracking_lite(result["results"], sp["gt_info_dir"], classes=["car"])
    ds = build_dataset(cfgs["car"], "val")
    voxels = [int(ds[i]["voxels_valid"].sum()) for i in (0, n - 1)]
    print(f"phase 15: track_scene CLI on cuda: {n} frames, {len(annos)} annotations, "
          f"{len({a['tracking_id'] for a in annos})} ids, launches {launches}; voxels of "
          f"the first and last frame {voxels}; eval_tracking_lite AMOTA "
          f"{lite['car']['amota']:.4f} (random weights: a check that it runs)")

    # cuda against cpu, small configuration
    small_base = write_split_config(os.path.join(configs, "car.py"), {},
                                    os.path.join(root, "small_base.py"), **SERVE_SMALL)
    sp_s = write_track_split(os.path.join(root, "small"), Config.fromfile(small_base),
                             n_scenes=2, n_frames=4, seed=16, n_objects=16, n_points=4000,
                             n_spots=1000)
    small = write_split_config(small_base, sp_s["val"], os.path.join(root, "small.py"))
    ck_s = random_checkpoint(Config.fromfile(small), os.path.join(root, "small.pth"), seed=17)
    runs = {}
    for d in ("cuda", "cpu"):
        runs[d] = track_scene.main(["--config", small, "--checkpoint", ck_s, "--out",
                                    os.path.join(root, f"small_{d}.json")]
                                   + (["--cpu"] if d == "cpu" else []))
    k = same_result(runs["cuda"], runs["cpu"], "small config cuda vs cpu")
    check(k > 0, "small config: no annotation")
    print(f"phase 15: small configuration, CLI on cuda == on cpu ({k} annotations: ids "
          f"exact, tracking_score within 1e-4)")

    # the multi-class CLI, car + pedestrian over one trunk
    out_mc = os.path.join(root, "multiclass", "tracking_result.json")
    mc, launches_mc = counted(kernels, lambda: track_multiclass.main(
        ["--classes", "car,pedestrian", "--config_dir", root, "--checkpoints",
         os.path.join(root, "{cls}.pth"), "--out", out_mc]))
    check(launches_mc == want, f"multi-class CLI: expected 12 + 21 + {NECK_CONVS} launches "
                               f"per frame (one trunk for both classes), "
                               f"got {launches_mc}")
    names = {a["tracking_name"] for v in mc["results"].values() for a in v}
    check(list(mc["results"]) == sp["tokens"] and names <= {"car", "pedestrian"} and names,
          f"multi-class CLI: tokens or classes wrong ({names})")
    lite_mc = eval_tracking_lite(mc["results"], sp["gt_info_dir"], classes=["car", "pedestrian"])
    print(f"phase 15: track_multiclass CLI on cuda (car, pedestrian): "
          f"{sum(map(len, mc['results'].values()))} annotations of {sorted(names)}, launches "
          f"{launches_mc}; mean AMOTA-lite {lite_mc['mean_amota']:.4f}")

    # the serving loop's time: the CLI's loop over the split, and over the
    # same frames already read into memory
    pipe = build_pipeline(cfgs["car"], load_model(cfgs["car"], ckpts["car"], "cuda"))
    track_scene_dataset(pipe, ds)  # warm-up
    loop_runs, splits = [], []
    for _ in range(TIMED_RUNS):
        timings = {}
        t0 = time.perf_counter()
        track_scene_dataset(pipe, ds, timings=timings)
        loop_runs.append(n / (time.perf_counter() - t0))
        splits.append({k: v / n * 1e3 for k, v in timings.items()})
    samples = [ds[i] for i in range(n)]
    # the step of a frame that comes from the host must not wait for the card
    frame = {k: samples[1][k][None] for k in FRAME_KEYS}
    syncs = sync_calls(lambda: pipe.step_frame(frame, len(samples[1]["cls_det_boxes"]), 0.5))
    check(not syncs, f"a serving step from host arrays synchronised with the card: {syncs}")
    # the path's lookups and f32 convs against their plain versions on a
    # served frame (the car config's caps, the split's clustered voxels)
    gather = phase_gather_kernels(SERVE_LABEL, lambda: pipe.model.bev_single(
        {k: upload(v, "cuda") for k, v in frame.items()}))
    mem_runs = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        track_scene_dataset(pipe, samples)
        mem_runs.append(n / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        track_scene_dataset(pipe, ds)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kernels_ms = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key) for e in events
                         if e.device_type == cuda and not e.is_user_annotation
                         and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels_ms)
    spans = {e.key: round(e.cpu_time_total / 1e3 / n, 3) for e in events
             if e.key.startswith("step.") and e.device_type != cuda}
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    fps_loop, fps_mem = statistics.median(loop_runs), statistics.median(mem_runs)
    print(f"phase 15: serving loop, {TIMED_RUNS} runs of {n} frames (f32 trunk, full car "
          f"config): {[round(x, 3) for x in loop_runs]} frames/s (median {fps_loop:.3f}); "
          f"host ms per frame (median) read {split['read']:.3f}, step {split['step']:.3f}, "
          f"format {split['format']:.3f}; the same frames from memory "
          f"{[round(x, 3) for x in mem_runs]} frames/s (median {fps_mem:.3f}); profiled pass: "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms per frame "
          f"({100 * busy / wall:.1f}%) ({smi})")
    print(f"  host ms per frame in the step's spans {spans}; the step from host arrays "
          f"synchronised {len(syncs)} times; device ms per frame, launches per frame, kernel:")
    for ms, count, key in kernels_ms[:8]:
        print(f"    {ms:9.3f} {count:7.1f}  {key[:100]}")
    shutil.rmtree(root, ignore_errors=True)
    return launches, gather, dict(
        frames_per_s=fps_loop, frames_per_s_runs=loop_runs, host_ms_per_frame=split,
        host_ms_per_frame_runs=splits, in_memory_frames_per_s=fps_mem,
        in_memory_frames_per_s_runs=mem_runs, profiled_wall_ms=wall, device_busy_ms=busy,
        voxels_first_last=voxels, amota_lite=lite["car"]["amota"],
        multiclass_mean_amota_lite=lite_mc["mean_amota"], step_spans_ms=spans,
        top_kernels=[{"ms": ms, "launches": c, "name": k} for ms, c, k in kernels_ms[:8]])


EVAL_SCENES, EVAL_FRAMES, EVAL_LANES = 9, 3, 8
EVAL_LABEL = f"eval step, {EVAL_LANES} lanes"


def phase_eval(kernels, smi):
    """Phase 16: the official per-class eval flow on a synthetic split
    (write_track_split, the full car configuration, 9 scenes x 3 frames):
    the eval CLI at 8 lanes (launches per step counted, cp_val.json checked),
    each strided stage's set against its cap per lane on the first 8-lane
    step, that step's lookups and convs against their plain versions
    (phase_gather_kernels), the CLI's --parity loop over the first scene
    (launches per pair), merge_results and pub_test on its output, the CLI
    on cuda and on cpu at a small configuration (3 lanes), and the eval
    loop's frames/s with its host split per frame (read, step, assemble),
    the device busy share of one profiled pass and the synchronisations of
    a step fed from host arrays. Returns (launches at 8 lanes, launches of
    the parity run, the step's kernel records, numbers)."""
    import pickle
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch.data.nuscenes import collate
    from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
    from shasta_tpu_torch.device import upload
    from shasta_tpu_torch.infer import FRAME_KEYS
    from shasta_tpu_torch.probe_b1_routes import stage_sets
    from shasta_tpu_torch.profile_step import sync_calls
    from shasta_tpu_torch.tools import eval as eval_cli
    from shasta_tpu_torch.tools import merge_results, pub_test
    from shasta_tpu_torch.tools.common import build_dataset, load_model
    from shasta_tpu_torch.tracker.runner import (EvalLanes, lane_schedule,
                                                 run_affinity_eval_batched)
    from shasta_tpu_torch.utils import Config

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    configs = os.path.join(repo, "configs", "nusc")
    t0 = time.perf_counter()
    sp = write_track_split(os.path.join(root, "data"),
                           Config.fromfile(os.path.join(configs, "car.py")),
                           n_scenes=EVAL_SCENES, n_frames=EVAL_FRAMES, seed=16)
    cfg_path = write_split_config(os.path.join(configs, "car.py"), sp["val"],
                                  os.path.join(root, "car.py"))
    cfg = Config.fromfile(cfg_path)
    ckpt = random_checkpoint(cfg, os.path.join(root, "car.pth"), seed=16)
    n = EVAL_SCENES * EVAL_FRAMES
    steps = len(lane_schedule([EVAL_FRAMES] * EVAL_SCENES, EVAL_LANES))
    check(steps == 6, f"the lane schedule has {steps} rows, want 6")
    print(f"phase 16: wrote a {EVAL_SCENES} x {EVAL_FRAMES}-frame split and a random .pth in "
          f"{time.perf_counter() - t0:.1f} s; {steps} steps of {EVAL_LANES} lanes")

    # the eval CLI at 8 lanes, counted
    wd = os.path.join(root, "car_eval")
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--work_dir", wd, "--split", "val",
            "--batch", str(EVAL_LANES)]
    annos, launches = counted(kernels, lambda: eval_cli.main(args))
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * steps, gather_conv=21 * steps, dense_conv=NECK_CONVS * steps)
    check(launches == want, f"eval CLI: expected 12 sorted_lookup + 21 gather_conv + "
                            f"{NECK_CONVS} dense_conv launches per {EVAL_LANES}-lane step, got "
                            f"{launches}")
    cp_path = os.path.join(wd, "cp_val.json")
    with open(cp_path) as f:
        check(json.load(f) == annos, "eval CLI: cp_val.json differs from the result")
    check(sorted(annos["results"]) == sorted(sp["tokens"]), "eval CLI: tokens missing")
    flat = [a for v in annos["results"].values() for a in v]
    check(len(flat) > 0 and all(np.isfinite(a["ref_detection_score"]) for a in flat),
          "eval CLI: no annotation, or a ref_detection_score that is not finite")
    flags = {k: sum(k in a for a in flat) for k in ("newborn", "FN", "dead")}
    print(f"phase 16: eval CLI on cuda, {EVAL_LANES} lanes: {n} frames, {len(flat)} "
          f"annotations, flags {flags}, launches {launches}")

    # each stage's set against its cap, per lane, on the first 8-lane step
    ds = build_dataset(cfg, "val")
    meta = ds.metadata()
    row = lane_schedule([EVAL_FRAMES] * EVAL_SCENES, EVAL_LANES)[0]
    firsts = [ds.read_at(si * EVAL_FRAMES, meta[si * EVAL_FRAMES]["rng_state"]) for si, _ in row]
    host8 = collate([{k: s[k] for k in FRAME_KEYS} for s in firsts])
    model = load_model(cfg, ckpt, "cuda")
    frame8 = {k: upload(v, "cuda") for k, v in host8.items()}
    sets = stage_sets(lambda: model.bev_single(frame8))
    lane_sets = {}
    for st in sets:
        lane_sets[st["name"]] = dict(cap=st["cap"], distinct=st["lane_distinct"],
                                     kept=st["lane_kept"])
        print(f"  {st['name']:6s} cap {st['cap']:7d}: per lane distinct {st['lane_distinct']}, "
              f"kept {st['lane_kept']}")
    check(all(sum(st["lane_kept"]) <= st["cap"] for st in sets), "a stage kept more than its cap")
    voxels = [int(s["voxels_valid"].sum()) for s in firsts]
    print(f"  valid voxels per lane {voxels}")

    # the step's lookups and f32 convs against their plain versions
    gather = phase_gather_kernels(EVAL_LABEL, lambda: model.bev_single(frame8))

    # the parity loop over the first scene
    with open(sp["val"]["info_path"], "rb") as f:
        infos = pickle.load(f)
    first_infos = os.path.join(root, "infos_first_scene.pkl")
    with open(first_infos, "wb") as f:
        pickle.dump(infos[:EVAL_FRAMES], f)
    first_cfg = write_split_config(os.path.join(configs, "car.py"),
                                   dict(sp["val"], info_path=first_infos),
                                   os.path.join(root, "car_first.py"))
    par, launches_par = counted(kernels, lambda: eval_cli.main(
        ["--config", first_cfg, "--checkpoint", ckpt, "--work_dir", os.path.join(root, "parity"),
         "--parity"]))
    want_par = {k.__name__: 0 for k in kernels}
    want_par.update(sorted_lookup=12 * EVAL_FRAMES, gather_conv=21 * EVAL_FRAMES,
                    dense_conv=NECK_CONVS * EVAL_FRAMES)
    check(launches_par == want_par, f"eval CLI --parity: expected 12 + 21 + {NECK_CONVS} "
                                    f"launches per pair, "
                                    f"got {launches_par}")
    check(list(par["results"]) == sp["tokens"][:EVAL_FRAMES]
          and all(np.isfinite(a["ref_detection_score"]) for v in par["results"].values()
                  for a in v), "eval CLI --parity: tokens or scores wrong")
    print(f"phase 16: eval CLI --parity over the first scene: {EVAL_FRAMES} pairs, "
          f"{sum(map(len, par['results'].values()))} annotations, launches {launches_par}")

    # merge_results and pub_test on the 8-lane output
    merged_path = os.path.join(root, "merged", "cp_val.json")
    merged = merge_results.main(["--inputs", cp_path, "--output", merged_path])
    check(merged["results"] == annos["results"], "merge_results of one file changed it")
    result = pub_test.main(["--predictions", merged_path, "--frame_info",
                            sp["val"]["frame_info_path"], "--work_dir",
                            os.path.join(root, "pub_test"), "--skip_eval"])
    check(list(result["results"]) == sp["tokens"], "pub_test: tokens out of order")
    carried = 0  # ids seen on a frame and on the next one of its scene
    for si in range(EVAL_SCENES):
        toks = sp["tokens"][si * EVAL_FRAMES:(si + 1) * EVAL_FRAMES]
        seen = [{a["tracking_id"] for a in result["results"][t]} for t in toks]
        held = [len(a & b) for a, b in zip(seen, seen[1:])]
        check(all(held), f"pub_test: scene {si} carries no id from a frame to the next {held}")
        carried += sum(held)
    print(f"phase 16: merge_results + pub_test: {sum(map(len, result['results'].values()))} "
          f"tracks over {n} frames; {carried} ids carried from a frame to the next")

    # cuda against cpu, small configuration, 3 lanes
    small_base = write_split_config(os.path.join(configs, "car.py"), {},
                                    os.path.join(root, "small_base.py"), **SERVE_SMALL)
    sp_s = write_track_split(os.path.join(root, "small"), Config.fromfile(small_base),
                             n_scenes=4, n_frames=3, seed=18, n_objects=16, n_points=4000,
                             n_spots=1000)
    small = write_split_config(small_base, sp_s["val"], os.path.join(root, "small.py"))
    ck_s = random_checkpoint(Config.fromfile(small), os.path.join(root, "small.pth"), seed=19)
    runs = {d: eval_cli.main(["--config", small, "--checkpoint", ck_s, "--batch", "3",
                              "--work_dir", os.path.join(root, f"small_{d}")]
                             + (["--cpu"] if d == "cpu" else []))
            for d in ("cuda", "cpu")}
    k = same_result(runs["cuda"], runs["cpu"], "small config, 3 lanes, cuda vs cpu",
                    score="ref_detection_score")
    check(k > 0, "small config: no annotation")
    print(f"phase 16: small configuration, 3 lanes, eval CLI on cuda == on cpu ({k} "
          f"annotations: the same keys and values, ref_detection_score within 1e-4)")

    # the eval loop's time over the split, its host split, a profiled pass
    loop_runs, splits = [], []
    for _ in range(TIMED_RUNS):
        timings = {}
        t0 = time.perf_counter()
        run_affinity_eval_batched(model, build_dataset(cfg, "val"), batch=EVAL_LANES,
                                  timings=timings)
        loop_runs.append(n / (time.perf_counter() - t0))
        splits.append({k: v / n * 1e3 for k, v in timings.items()})
    # a step from host arrays must not wait for the card
    lanes = EvalLanes(model, EVAL_LANES)
    n_currs = [len(s["cls_det_boxes"]) for s in firsts]
    host1 = {k: v[None] for k, v in host8.items()}
    syncs = sync_calls(lambda: lanes.step_chunk(host1, [[True] * EVAL_LANES], [n_currs]))
    check(not syncs, f"an eval step from host arrays synchronised with the card: {syncs}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_affinity_eval_batched(model, build_dataset(cfg, "val"), batch=EVAL_LANES)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kernels_ms = sorted(((e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
                         for e in events if e.device_type == cuda and not e.is_user_annotation
                         and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels_ms) * steps / n
    spans = {e.key: round(e.cpu_time_total / 1e3 / steps, 3) for e in events
             if e.key.startswith("step.") and e.device_type != cuda}
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    fps = statistics.median(loop_runs)
    print(f"phase 16: eval loop, {TIMED_RUNS} runs of {n} frames at {EVAL_LANES} lanes (f32 "
          f"trunk, full car config): {[round(x, 3) for x in loop_runs]} frames/s (median "
          f"{fps:.3f}); host ms per frame (median) read {split['read']:.3f}, step "
          f"{split['step']:.3f}, assemble {split['assemble']:.3f}; profiled pass: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms per frame ({100 * busy / wall:.1f}%) "
          f"({smi})")
    print(f"  host ms per step in the step's spans {spans}; a step from host arrays "
          f"synchronised {len(syncs)} times; device ms per step, launches per step, kernel:")
    for ms, count, key in kernels_ms[:8]:
        print(f"    {ms:9.3f} {count:9.1f}  {key[:100]}")
    shutil.rmtree(root, ignore_errors=True)
    return launches, launches_par, gather, dict(
        frames_per_s=fps, frames_per_s_runs=loop_runs, host_ms_per_frame=split,
        host_ms_per_frame_runs=splits, profiled_wall_ms_per_frame=wall,
        device_busy_ms_per_frame=busy, step_spans_ms=spans, syncs_per_step=len(syncs),
        lane_sets=lane_sets, voxels_per_lane=voxels, annotations=len(flat), flags=flags,
        top_kernels=[{"ms": ms, "launches": c, "name": k} for ms, c, k in kernels_ms[:8]])


TRAIN_SCENES, TRAIN_FRAMES, TRAIN_BATCH = 4, 6, 8
TRAIN_LABEL, CACHE_LABEL = "train step", "cache_features batch"
# the small geometry of phase 17e, and caps that hold every set of its two
# pairs (four frames): each stage's output grid x 4
TRAIN_SMALL_WHOLE = dict(SMALL, cap_conv2=4 * 21 * 40 * 40, cap_conv3=4 * 11 * 20 * 20,
                         cap_conv4=4 * 5 * 10 * 10, cap_extra=4 * 2 * 10 * 10)


def small_pairs(cfg, seed):
    """Two seeded frame pairs of a small configuration with GT, box centres
    on its map."""
    from shasta_tpu_torch.data.synthetic import make_batch

    b = make_batch(cfg, 2, 2500, n_dets=7, with_gt=True, seed=seed)
    span = cfg.voxel_size[0] * cfg.grid_shape[2] * 0.9
    for key in ("det_boxes", "prev_det_boxes"):
        b[key][:, :, :2] = cfg.pc_start[0] + (b[key][:, :, :2] + 50.0) / 100.0 * span
    return b


def small_step(cfg, batch, dev, lr, freeze_bev=True, **kw):
    """One train step of a small model (seeded random weights) on `dev`:
    (loss, state_dict on the host, the trunk's route)."""
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.models import ShastaModel
    from shasta_tpu_torch.train import loop

    m = ShastaModel(cfg, device=dev)
    load_jax_variables(m, random_jax_variables(m, seed=3))
    tx = loop.make_optimizer(m, lr, 1e-2, freeze_bev=freeze_bev)
    state, met = loop.make_train_step(m, tx, **kw)(loop.create_train_state(m, tx), batch)
    return (float(met["loss"]), {k: v.detach().cpu() for k, v in m.state_dict().items()},
            loop.trunk_route(m))


def phase_training(kernels, smi):
    """Phase 17: train on the card. A labelled synthetic train split
    (write_track_split(split="train"), configs/nusc/car.py as it stands:
    4 frame pairs a step, caps 100k/50k/25k/25k over the doubled batch of 8
    frames, f32 trunk), random weights saved with save_checkpoint and given
    as --checkpoint; `tools.train.main` for one epoch (12 sorted_lookup + 21
    gather_conv per step, counted, nothing else; finite losses; backbone and
    neck bit-equal before and after, shared conv and head moved; epoch_1.pth
    loads back; one log row per step); the train step's 12 lookups and 21
    f32 convs against their plain versions (phase_gather_kernels) and each
    stage's set per frame against its cap; at a small configuration one
    step on cuda and on cpu, standard and bn_train (loss at rtol 1e-5,
    parameters within 2*lr, running statistics at rtol 1e-5 of each
    tensor's scale) and a freeze_bev=False step that launches no kernel;
    `tools.cache_features` (--batch 8: 12 + 21 per batch, counted) and
    `tools.train --cached_features` for one epoch (no launch), and at the
    small configuration with caps that hold every set the cached loss
    equal to the full loss; then the train loop's pairs/s split per step
    into waiting for the loader and the step, a profiled step (device busy,
    top kernels, peak memory), the cached loop's pairs/s and the cache's
    frames/s. Returns (launches per path, kernel records per path, numbers)."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.loader import DataLoader
    from shasta_tpu_torch.data.nuscenes import NuScenesTrackDataset, PointPipelineConfig, collate
    from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
    from shasta_tpu_torch.device import upload
    from shasta_tpu_torch.infer import FRAME_KEYS
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.probe_b1_routes import stage_sets
    from shasta_tpu_torch.tools import cache_features, train
    from shasta_tpu_torch.tools.common import load_model
    from shasta_tpu_torch.train import loop
    from shasta_tpu_torch.train.checkpoint import load_checkpoint
    from shasta_tpu_torch.utils import Config

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    car = os.path.join(repo, "configs", "nusc", "car.py")
    dev = "cuda"
    t0 = time.perf_counter()
    sp = write_track_split(os.path.join(root, "data"), Config.fromfile(car),
                           n_scenes=TRAIN_SCENES, n_frames=TRAIN_FRAMES, seed=17, split="train")
    cfg_path = write_split_config(car, {}, os.path.join(root, "car.py"),
                                  data={"train": sp["train"]})
    cfg = Config.fromfile(cfg_path)
    ckpt = random_checkpoint(cfg, os.path.join(root, "init.pth"), seed=17)
    n = TRAIN_SCENES * TRAIN_FRAMES
    B = cfg.data.samples_per_device
    steps = n // B
    print(f"phase 17: wrote a labelled {TRAIN_SCENES} x {TRAIN_FRAMES}-frame train split and a "
          f"random .pth in {time.perf_counter() - t0:.1f} s; {steps} steps of {B} pairs "
          f"({2 * B} frames through the trunk), {cfg.data.workers} loader threads")

    # b. one epoch of the train CLI, counted
    wd = os.path.join(root, "work")
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--work_dir", wd, "--epochs", "1"]
    out, launches = counted(kernels, lambda: train.main(args))
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * steps, gather_conv=21 * steps,
                dense_conv=(NECK_CONVS - 1) * steps)
    check(launches == want, f"train CLI: expected 12 sorted_lookup + 21 gather_conv + "
                            f"{NECK_CONVS - 1} dense_conv launches per step (the shared conv "
                            f"trains on cuDNN), got {launches} for {steps} steps")
    losses = out["losses"][0]
    check(len(losses) == steps and all(np.isfinite(losses)), f"train CLI: losses {losses}")
    with open(os.path.join(wd, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check([r["step"] for r in rows] == list(range(steps)), "train CLI: not one log row per step")
    before = torch.load(ckpt)
    after = load_checkpoint(os.path.join(wd, "epoch_1.pth"))
    for k, v in before.items():
        if k.split(".")[0] in loop.FROZEN_TRUNK_KEYS:
            check(torch.equal(v, after[k]), f"train CLI: the frozen {k} changed")
    moved = [k for k in ("shared_conv.0.weight", "aff.0.weight", "fuse_shape.0.weight",
                         "res_coeff.0.weight", "aug_shape.0.0.weight")
             if not torch.equal(before[k], after[k])]
    check(len(moved) == 5, f"train CLI: only {moved} of the trainable parts moved")
    model = load_model(cfg, os.path.join(wd, "epoch_1.pth"), dev)
    check(all(torch.equal(v.cpu(), after[k]) for k, v in model.state_dict().items()),
          "epoch_1.pth does not load back")
    print(f"phase 17: train CLI, one epoch: {steps} steps, losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}; route: {out['route']}; "
          f"backbone and neck bit-equal, {len(moved)} trainable parts moved; epoch_1.pth "
          f"loads back")

    # c, d. the train step's trunk on its first batch: kernels against their
    # plain versions, and each stage's set per frame against its cap
    ds = NuScenesTrackDataset(**dict(cfg.data.train), det_type=list(cfg.det_type),
                              max_objects=cfg.max_objects, fp_ratio=cfg.fp_ratio,
                              dead_trk_ratio=cfg.dead_trk_ratio,
                              pipeline=PointPipelineConfig(**dict(cfg.point_pipeline)), seed=0)
    host = next(iter(DataLoader(ds, batch_size=B, num_workers=cfg.data.workers, seed=0)))
    batch = {k: upload(host[k], dev) for k in loop.PAIR_KEYS}

    def trunk():
        return model.neck(model.backbone(model.pair_tensor(batch)))
    sets = stage_sets(trunk)
    frame_sets = {}
    for st in sets:
        frame_sets[st["name"]] = dict(cap=st["cap"], distinct=st["lane_distinct"],
                                      kept=st["lane_kept"])
        print(f"  {st['name']:6s} cap {st['cap']:7d}: per frame (curr 0-{B - 1}, prev "
              f"{B}-{2 * B - 1}) distinct {st['lane_distinct']}, kept {st['lane_kept']}")
    check(all(sum(st["lane_kept"]) <= st["cap"] for st in sets), "a stage kept more than its cap")
    voxels = [int(v.sum()) for v in host["voxels_valid"]] + [
        int(v.sum()) for v in host["prev_voxels_valid"]]
    print(f"  valid voxels per frame {voxels}")
    gather = {TRAIN_LABEL: phase_gather_kernels(TRAIN_LABEL, trunk)}
    vox_ds = NuScenesTrackDataset(**cache_features._split_kwargs(cfg, "train"))
    frames8 = collate([vox_ds[i] for i in range(TRAIN_BATCH)])
    frame8 = {k: upload(frames8[k], dev) for k in FRAME_KEYS}
    gather[CACHE_LABEL] = phase_gather_kernels(CACHE_LABEL, lambda: model.bev_single(frame8))

    # e. small configuration: cuda against cpu, standard and bn_train; a
    # trunk that trains launches nothing
    small = ShastaConfig(**SMALL)
    pairs = small_pairs(small, seed=5)
    lr = 1e-3
    for bn in (False, True):
        (l_a, sd_a, _), (l_b, sd_b, _) = (small_step(small, pairs, d, lr, bn_train=bn)
                                          for d in (dev, "cpu"))
        check(abs(l_a - l_b) <= 1e-5 * abs(l_b), f"small step bn_train={bn}: loss {l_a} vs {l_b}")
        for k, v in sd_b.items():
            if "num_batches" in k:
                continue
            tol = 1e-5 * float(v.abs().max()) if "running" in k else 2 * lr
            err = float((sd_a[k] - v).abs().max())
            check(err <= tol, f"small step bn_train={bn}: {k} differs by {err} > {tol}")
        print(f"phase 17: small configuration, one step bn_train={bn}: {dev} == cpu (loss "
              f"{l_a:.6f} / {l_b:.6f}; parameters within 2*lr, running statistics within "
              f"1e-5 of their scale)")
    (l_t, _, route_t), launches_t = counted(kernels, lambda: small_step(
        small, pairs, dev, lr, freeze_bev=False))
    check(not any(launches_t.values()) and np.isfinite(l_t),
          f"a trunk that trains launched {launches_t}")
    print(f"phase 17: small configuration, freeze_bev=False step on {dev}: loss {l_t:.6f}, "
          f"launches {launches_t}; route: {route_t}")

    # f. the feature cache and an epoch of cached training, counted
    cache = os.path.join(root, "cache")
    res, launches_c = counted(kernels, lambda: cache_features.main(
        ["--config", cfg_path, "--checkpoint", ckpt, "--split", "train", "--out", cache,
         "--batch", str(TRAIN_BATCH)]))
    nb = -(-n // TRAIN_BATCH)
    want_c = {k.__name__: 0 for k in kernels}
    want_c.update(sorted_lookup=12 * nb, gather_conv=21 * nb, dense_conv=NECK_CONVS * nb)
    check(launches_c == want_c and res["batches"] == nb,
          f"cache_features: expected 12 + 21 + {NECK_CONVS} launches per batch of "
          f"{TRAIN_BATCH}, got "
          f"{launches_c}")
    check(sorted(os.listdir(cache)) == sorted(t + ".npz" for t in sp["tokens"]),
          "cache_features: a token's file is missing")
    wc = os.path.join(root, "cached_work")
    out_c, launches_ct = counted(kernels, lambda: train.main(
        ["--config", cfg_path, "--checkpoint", ckpt, "--work_dir", wc, "--epochs", "1",
         "--cached_features", cache]))
    check(not any(launches_ct.values()) and all(np.isfinite(out_c["losses"][0]))
          and len(out_c["losses"][0]) == steps, f"cached train CLI: launches {launches_ct}, "
                                                f"losses {out_c['losses']}")
    whole = ShastaConfig(**TRAIN_SMALL_WHOLE)
    pw = small_pairs(whole, seed=6)
    m_w = ShastaModel(whole, device=dev)
    load_jax_variables(m_w, random_jax_variables(m_w, seed=3))
    t = {k: upload(v, dev) for k, v in pw.items()}
    with torch.no_grad():
        feats = {p + "feat": m_w.frame_features({k: t[p + k] for k in FRAME_KEYS}).cpu().numpy()
                 for p in ("", "prev_")}
    l_full = small_step(whole, pw, dev, lr)[0]
    l_cached = small_step(whole, {k: pw[k] for k in ("det_boxes", "prev_det_boxes", "gt")}
                          | feats, dev, lr, cached=True)[0]
    check(abs(l_full - l_cached) <= 1e-5 * abs(l_full),
          f"cached loss {l_cached} != full loss {l_full} at caps that hold every set")
    print(f"phase 17: cache_features --batch {TRAIN_BATCH}: {n} frames in {nb} batches, launches "
          f"{launches_c}; cached train CLI: {steps} steps, losses "
          f"{[round(x, 4) for x in out_c['losses'][0]]}, launches {launches_ct}; small "
          f"configuration with whole sets: cached loss {l_cached:.6f} == full {l_full:.6f}")

    # g. times: the train loop (a second epoch run, warm), one profiled
    # step, the cached loop and the cache
    out2 = train.main(["--config", cfg_path, "--checkpoint", ckpt, "--work_dir",
                       os.path.join(root, "work2"), "--epochs", "1"])
    wait, step = np.asarray(out2["wait_s"]) * 1e3, np.asarray(out2["step_s"]) * 1e3
    pairs_s = B * steps / ((wait.sum() + step.sum()) / 1e3)
    print(f"phase 17: train loop, {steps} steps of {B} pairs (f32 trunk, full car config): "
          f"{pairs_s:.3f} pairs/s; ms per step waiting for the loader {np.round(wait, 3).tolist()}"
          f" (median {np.median(wait):.3f}), in the step {np.round(step, 3).tolist()} (median "
          f"{np.median(step):.3f}) ({smi})")
    m_p = load_model(cfg, ckpt, dev)
    tx = loop.make_optimizer(m_p)
    st = loop.create_train_state(m_p, tx)
    step_fn = loop.make_train_step(m_p, tx)
    step_fn(st, host)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, met = step_fn(st, host)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kernels_ms = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events
                         if e.device_type == cuda and not e.is_user_annotation
                         and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels_ms)
    spans = {e.key: round(e.cpu_time_total / 1e3, 3) for e in events
             if e.key.startswith("train.") and e.device_type != cuda}
    print(f"phase 17: one profiled train step (4 pairs from memory): wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%), peak device memory {peak:.3f} GiB "
          f"({smi}); host ms in the spans {spans}; device ms, launches, kernel:")
    for ms, count, key in kernels_ms[:8]:
        print(f"    {ms:9.3f} {count:7d}  {key[:100]}")
    wait_c, step_c = np.asarray(out_c["wait_s"]) * 1e3, np.asarray(out_c["step_s"]) * 1e3
    pairs_c = B * steps / ((wait_c.sum() + step_c.sum()) / 1e3)
    cache_s = {k: float(np.sum(res[k])) for k in ("read_s", "trunk_s", "write_s")}
    frames_s = n / sum(cache_s.values())
    print(f"phase 17: cached train loop {pairs_c:.3f} pairs/s (ms per step: loader median "
          f"{np.median(wait_c):.3f}, step median {np.median(step_c):.3f}); cache_features "
          f"{frames_s:.3f} frames/s (s over {nb} batches: read {cache_s['read_s']:.3f}, trunk and "
          f"sampling {cache_s['trunk_s']:.3f}, write {cache_s['write_s']:.3f}) ({smi})")
    shutil.rmtree(root, ignore_errors=True)
    launches_by = {"17b: train CLI": launches, "17f: cache_features CLI": launches_c,
                   "17f: cached train CLI": launches_ct}
    return launches_by, gather, dict(
        steps=steps, losses=losses, route=out["route"], frame_sets=frame_sets,
        voxels_per_frame=voxels, train_pairs_per_s=pairs_s, wait_ms=wait.tolist(),
        step_ms=step.tolist(), profiled_wall_ms=wall, device_busy_ms=busy,
        peak_device_gib=peak, train_spans_ms=spans,
        top_kernels=[{"ms": ms, "launches": c, "name": k} for ms, c, k in kernels_ms[:8]],
        cached_pairs_per_s=pairs_c, cached_wait_ms=wait_c.tolist(),
        cached_step_ms=step_c.tolist(), cache_frames_per_s=frames_s, cache_s=cache_s)


# the world of phase 18: one nuScenes scene is 20 s at 2 Hz (40 key frames);
# 40 moving cars and 60 false positives a frame, the fixture's noise (0.3 m)
# and miss rate (0.2), objects and false positives within 50 m of the ego
ORACLE_SCENES, ORACLE_FRAMES = 8, 40
ORACLE_WORLD = dict(n_scenes=ORACLE_SCENES, n_frames=ORACLE_FRAMES, n_objects=40,
                    fp_per_frame=60, span=50.0, seed=18)
SERVE_CHAIN_SCENES = 2
# the chain tree's frames whose lookups and convs are held against their
# plain versions: a scene's first key frame (no sweep) and its last (9)
CHAIN_GATHER = {f"chain tree frame {i}": i for i in (0, ORACLE_FRAMES - 1)}
SMALL_CHAIN_FRAMES = 4
GIOU_FRAMES = 4


def explain_flip(data, scene, fi, cfg):
    """Print, for the first frame whose track ids differ between cuda and
    cpu, the association and redundancy entries nearest their thresholds on
    both devices (the models run in step up to the frame before)."""
    import copy

    import numpy as np

    from shasta_tpu_torch.mot import MOTModel
    from shasta_tpu_torch.mot.association import compute_distance_matrix, geometry_matrix
    from shasta_tpu_torch.tools.run_oracle_mot import scene_frames

    frames = scene_frames(data, "cp", scene)
    models = {d: MOTModel(cfg, device=d) for d in ("cuda", "cpu")}
    for f in frames[:fi]:
        for m in models.values():
            m.frame_mot(copy.deepcopy(f))
    f = frames[fi]
    r, red = cfg["running"], cfg["redundancy"]
    thr = r["asso_thres"][r["asso"]]
    red_thr = red["det_dist_threshold"][r["asso"]]
    for name, m in models.items():
        trks = copy.deepcopy(m.trackers)
        preds = np.stack([t.predict(f.time_stamp, True) for t in trks]) if trks else None
        cand = f.dets[f.dets[:, 7] >= r["score_threshold"]]
        if preds is None or not len(cand):
            print(f"  {name}: {len(trks)} tracks, {len(cand)} candidates")
            continue
        dist = {d: compute_distance_matrix(cand, preds, r["asso"], device=d) for d in ("cuda", "cpu")}
        near = np.argsort(np.abs(dist["cuda"] - thr), axis=None)[:5]
        for k in near:
            i, j = np.unravel_index(k, dist["cuda"].shape)
            print(f"  {name} model, association pair (det {i}, track {j}): distance cuda "
                  f"{dist['cuda'][i, j]!r} cpu {dist['cpu'][i, j]!r}, threshold {thr}")
        low = f.dets[f.dets[:, 7] > red["det_score_threshold"][r["asso"]]]
        states = np.stack([t.get_state() for t in trks])
        geo = {d: geometry_matrix(low, states, r["asso"], d) for d in ("cuda", "cpu")}
        for k in np.argsort(np.abs(geo["cuda"] - red_thr), axis=None)[:5]:
            i, j = np.unravel_index(k, geo["cuda"].shape)
            print(f"  {name} model, redundancy pair (det {i}, track {j}): {r['asso']} cuda "
                  f"{geo['cuda'][i, j]!r} cpu {geo['cpu'][i, j]!r}, threshold {red_thr}")


def phase_chain(kernels, smi):
    """Phase 18: the offline chain and the oracle tracker on the card's
    machine. A synthetic nuScenes dataroot (data.synthetic
    build_synthetic_world, ORACLE_WORLD) goes through the chain's CLIs in
    process, each timed: make_scenes, preprocess_nuscenes (2 Hz),
    create_data (10 sweeps) and check_artifacts, which must find no
    problem; preprocess_nuscenes --mode 20hz on the micro tree
    (build_micro_nusc, with the sweeps between key frames). estimate_stats
    on the 2 Hz tree; run_oracle_mot (giou, bipartite, kf) on cuda and with
    --cpu: per-frame track ids and the MOTA summaries exactly equal, the
    giou distance matrices of the first frames within 1e-5 and the
    redundancy's one matrix per frame equal to its per-track calls on the
    card, bit for bit; the device busy share of one profiled oracle scene.
    Then the tools.track_scene CLI serves the chain's tree (its first two
    scenes, the infos create_data wrote, a random .pth) on cuda, launches
    counted; the path's lookups and f32 convs against their plain versions
    (phase_gather_kernels) on the CHAIN_GATHER frames; and at a small
    configuration on cuda and on cpu (ids exact, tracking_score within
    1e-4). Returns (launches, the path's kernel records per frame, numbers)."""
    import copy
    import pickle
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shasta_tpu_torch.data.synthetic import (build_micro_nusc, build_synthetic_world,
                                                 write_split_config)
    from shasta_tpu_torch.device import upload
    from shasta_tpu_torch.infer import FRAME_KEYS
    from shasta_tpu_torch.mot import MOTModel
    from shasta_tpu_torch.mot.association import compute_distance_matrix, geometry_matrix
    from shasta_tpu_torch.mot.mot_model import DEFAULT_CONFIG
    from shasta_tpu_torch.tools import (check_artifacts, create_data, estimate_stats, make_scenes,
                                        preprocess_nuscenes, run_oracle_mot, track_scene)
    from shasta_tpu_torch.tools.common import build_dataset, build_pipeline, load_model
    from shasta_tpu_torch.tools.run_oracle_mot import scene_frames
    from shasta_tpu_torch.utils import Config

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_chain")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stage_s = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        stage_s[stage] = time.perf_counter() - t0
        return out

    fx = timed("write dataroot", lambda: build_synthetic_world(os.path.join(root, "world"),
                                                               **ORACLE_WORLD))
    micro = build_micro_nusc(os.path.join(root, "micro"))
    raw = ["--dataroot", str(fx["root"]), "--version", "v1.0-mini"]
    out = os.path.join(root, "prep")
    data = os.path.join(out, "val_2hz")
    scenes = timed("make_scenes", lambda: make_scenes.main(
        raw + ["--out", os.path.join(out, "scenes_meta.json")]))["scenes"]
    check(list(scenes) == fx["scene_names"]
          and all(len(v) == ORACLE_FRAMES for v in scenes.values()),
          "make_scenes: scenes or frames missing")
    timed("preprocess_nuscenes", lambda: preprocess_nuscenes.main(
        raw + ["--results", str(fx["results"]), "--out", out, "--split", "val"]))
    infos_path = os.path.join(out, "infos_val_10sweeps.pkl")
    infos = timed("create_data", lambda: create_data.main(raw + ["--out", infos_path]))
    problems = timed("check_artifacts", lambda: check_artifacts.main(
        ["--data", out, "--split", "val"]))
    check(problems == 0, f"check_artifacts found {problems} problem(s) in the chain's tree")
    timed("preprocess_nuscenes --mode 20hz (micro tree)", lambda: preprocess_nuscenes.main(
        ["--dataroot", str(micro["root"]), "--version", "v1.0-mini", "--results",
         str(micro["results"]), "--out", os.path.join(root, "micro_prep"), "--split", "val",
         "--mode", "20hz"]))
    with open(os.path.join(root, "micro_prep", "val_20hz", "token_info", "scene-0001.json")) as f:
        rows = json.load(f)
    check([r[3] for r in rows] == [True, False, True, True, False, True, True],
          f"20 Hz chain: selection flags {[r[3] for r in rows]}")
    n_frames = ORACLE_SCENES * ORACLE_FRAMES
    check(len(infos) == n_frames and len(infos[-1]["sweeps"]) == 9,
          f"create_data: {len(infos)} infos, the last with {len(infos[-1]['sweeps'])} sweeps")
    timed("estimate_stats", lambda: estimate_stats.main(
        ["--data", data, "--out", os.path.join(root, "stats"), "--name", "cp_2hz_synthetic"]))
    per_scene = {k: v / ORACLE_SCENES for k, v in stage_s.items() if "micro" not in k}
    print(f"phase 18: chain over {ORACLE_SCENES} scenes x {ORACLE_FRAMES} key frames "
          f"({ORACLE_WORLD['n_objects']} objects, {ORACLE_WORLD['fp_per_frame']} false positives "
          f"a frame): seconds per scene {({k: round(v, 4) for k, v in per_scene.items()})}; "
          f"20 Hz micro tree {stage_s['preprocess_nuscenes --mode 20hz (micro tree)']:.3f} s; "
          f"check_artifacts: 0 problems")

    # the oracle tracker on cuda and on the CPU
    runs, fps = {}, {}
    for d in ("cuda", "cpu"):
        runs[d] = timed(f"run_oracle_mot {d}", lambda: run_oracle_mot.main(
            ["--data", data, "--out", os.path.join(root, f"mot_{d}.json")]
            + (["--cpu"] if d == "cpu" else [])))
        fps[d] = n_frames / stage_s[f"run_oracle_mot {d}"]
    t_checks = time.perf_counter()
    (sum_cuda, ids_cuda), (sum_cpu, ids_cpu) = runs["cuda"], runs["cpu"]
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    for scene in ids_cpu:
        for fi, (a, b) in enumerate(zip(ids_cuda[scene], ids_cpu[scene])):
            if a != b:
                print(f"phase 18: {scene} frame {fi}: track ids differ on cuda and cpu")
                explain_flip(data, scene, fi, cfg)
                check(False, f"oracle tracker: {scene} frame {fi}: ids differ")
    check(ids_cuda == ids_cpu and sum_cuda == sum_cpu,
          f"oracle tracker: cuda {sum_cuda} and cpu {sum_cpu} differ")
    n_ids = len({i for v in ids_cuda.values() for f in v for i in f})
    # the giou matrices of the first frames, and the redundancy's one
    # matrix against its per-track calls on the card
    frames = scene_frames(data, "cp", "scene-0000")
    giou_err, cols = 0.0, 0
    model = MOTModel(cfg, device="cuda")
    for prev, curr in zip(frames[:GIOU_FRAMES], frames[1:GIOU_FRAMES + 1]):
        m = {d: compute_distance_matrix(curr.dets, prev.dets, "giou", device=d)
             for d in ("cuda", "cpu")}
        check(m["cuda"].dtype == np.float32, "giou matrix is not f32")
        giou_err = max(giou_err, float(np.abs(m["cuda"] - m["cpu"]).max()))
        model.frame_mot(copy.deepcopy(prev))
        states = np.stack([t.get_state() for t in model.trackers])
        cand = curr.dets[curr.dets[:, 7] > cfg["redundancy"]["det_score_threshold"]["giou"]]
        full = geometry_matrix(cand, states, "giou", "cuda")
        for j in range(0, len(states), 8):
            col = geometry_matrix(cand, states[j:j + 1], "giou", "cuda")[:, 0]
            check(col.tobytes() == full[:, j].tobytes(),
                  f"redundancy matrix column {j} differs from its per-track call on the card")
            cols += 1
    check(giou_err <= 1e-5, f"giou matrices: cuda vs cpu max abs diff {giou_err}")
    stage_s["device checks"] = time.perf_counter() - t_checks
    # one profiled oracle scene (device activity only: its kernels' time)
    t_prof = time.perf_counter()
    scene0 = scene_frames(data, "cp", "scene-0000")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = MOTModel(cfg, device="cuda")
        for f in scene0:
            model.frame_mot(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(scene0) * 1e3
    # the raw device events (~100k): key_averages() would build an object
    # per event first, which takes longer than the scene
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
    busy = sum(e.duration_ns() for e in device) / 1e6 / len(scene0)
    launches_per_frame = len(device) / len(scene0)
    stage_s["profiled scene"] = time.perf_counter() - t_prof
    print(f"phase 18: run_oracle_mot (giou, bipartite, kf) over {n_frames} frames: cuda "
          f"{fps['cuda']:.3f} frames/s, cpu {fps['cpu']:.3f} frames/s ({smi}); ids and MOTA "
          f"summary equal on both ({n_ids} ids, MOTA {sum_cuda['mota']:.4f}); giou matrices of "
          f"{GIOU_FRAMES} frames within {giou_err:.3g}; {cols} redundancy columns == their "
          f"per-track calls; profiled scene: wall {wall:.3f} ms, device busy {busy:.3f} ms per "
          f"frame ({100 * busy / wall:.1f}%), {launches_per_frame:.0f} kernels a frame")

    # the port's served path on the chain's tree
    t_serve = time.perf_counter()
    car = os.path.join(repo, "configs", "nusc", "car.py")
    first = set(fx["scene_names"][:SERVE_CHAIN_SCENES])
    serve_infos = os.path.join(out, "infos_serve.pkl")
    create_data.main(raw + ["--out", serve_infos, "--scenes", *sorted(first)])
    val = dict(info_path=serve_infos,
               det_path=os.path.join(data, "detections", "cp", "sensor_individual_frames"),
               cls_info_path=os.path.join(data, "detections", "cp", "cls_individual_frames"),
               frame_info_path=os.path.join(out, "val_frame_info.json"), test_mode=True)
    cfg_path = write_split_config(car, val, os.path.join(root, "car.py"))
    ckpt = random_checkpoint(Config.fromfile(cfg_path), os.path.join(root, "car.pth"), seed=18)
    n_serve = SERVE_CHAIN_SCENES * ORACLE_FRAMES
    stage_s["serving set-up"] = time.perf_counter() - t_serve
    result, launches = timed("track_scene", lambda: counted(kernels, lambda: track_scene.main(
        ["--config", cfg_path, "--checkpoint", ckpt, "--out", os.path.join(root, "track.json")])))
    serve_fps = n_serve / stage_s["track_scene"]
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * n_serve, gather_conv=21 * n_serve,
                dense_conv=NECK_CONVS * n_serve)
    check(launches == want, f"track_scene over the chain's tree: expected 12 sorted_lookup + 21 "
                            f"gather_conv + {NECK_CONVS} dense_conv launches per frame, got "
                            f"{launches}")
    check(list(result["results"]) == [i["token"] for i in infos[:n_serve]],
          "track_scene over the chain's tree: tokens out of order")
    annos = [a for v in result["results"].values() for a in v]
    check(len(annos) > 0 and all(np.isfinite(a["tracking_score"]) for a in annos),
          "track_scene over the chain's tree: no annotation, or a score not finite")
    # the path's lookups and f32 convs against their plain versions on the
    # chain tree's own frames (~2.4k points a key frame, up to 9 earlier key
    # frames as sweeps: sets far smaller than phase 15's split)
    t_gather = time.perf_counter()
    chain_cfg = Config.fromfile(cfg_path)
    pipe = build_pipeline(chain_cfg, load_model(chain_cfg, ckpt, "cuda"))
    ds = build_dataset(chain_cfg, "val")
    gather, voxels = {}, {}
    for label, i in CHAIN_GATHER.items():
        sample = ds[i]
        voxels[label] = int(sample["voxels_valid"].sum())
        frame = {k: upload(sample[k][None], "cuda") for k in FRAME_KEYS}
        gather[label] = phase_gather_kernels(label, lambda: pipe.model.bev_single(frame))
    del pipe
    stage_s["kernels vs plain"] = time.perf_counter() - t_gather
    # cuda against cpu at the small configuration, the first frames of scene 0
    t_small = time.perf_counter()
    small_infos = os.path.join(out, "infos_small.pkl")
    with open(small_infos, "wb") as f:
        pickle.dump(infos[:SMALL_CHAIN_FRAMES], f)
    small = write_split_config(car, dict(val, info_path=small_infos),
                               os.path.join(root, "small.py"), **SERVE_SMALL)
    ck_s = random_checkpoint(Config.fromfile(small), os.path.join(root, "small.pth"), seed=19)
    small_runs = {d: track_scene.main(["--config", small, "--checkpoint", ck_s, "--out",
                                       os.path.join(root, f"small_{d}.json")]
                                      + (["--cpu"] if d == "cpu" else []))
                  for d in ("cuda", "cpu")}
    k = same_result(small_runs["cuda"], small_runs["cpu"], "chain tree, small config cuda vs cpu")
    check(k > 0, "chain tree, small config: no annotation")
    stage_s["small cuda vs cpu"] = time.perf_counter() - t_small
    print(f"phase 18: track_scene CLI over the chain's first {SERVE_CHAIN_SCENES} scenes on cuda: "
          f"{n_serve} frames at {serve_fps:.3f} frames/s (f32, full car config, reading "
          f"included), {len(annos)} annotations, launches {launches}; voxels of the frames held "
          f"against the plain versions {voxels}; small configuration on cuda == on cpu ({k} "
          f"annotations)")
    print(f"phase 18: seconds by part {({n: round(v, 3) for n, v in stage_s.items()})}")
    shutil.rmtree(root, ignore_errors=True)
    return launches, gather, dict(
        seconds_per_scene=per_scene, seconds_by_part=stage_s, micro_20hz_s=stage_s["preprocess_nuscenes --mode 20hz "
                                                          "(micro tree)"],
        oracle_frames=n_frames, oracle_frames_per_s_cuda=fps["cuda"],
        oracle_frames_per_s_cpu=fps["cpu"], oracle_summary=sum_cuda, oracle_ids=n_ids,
        giou_max_abs_diff=giou_err, redundancy_columns_checked=cols,
        profiled_scene_wall_ms=wall, profiled_scene_device_busy_ms=busy,
        profiled_scene_kernels_per_frame=launches_per_frame,
        serve_frames=n_serve, serve_frames_per_s=serve_fps, gather_voxels=voxels,
        small_annotations=k)


# phase 19: 2 Waymo segments of 20 frames at 10 Hz (a real segment has ~198:
# the one cut), at the real widths (TOP 64 x 2650, four 200 x 600 lasers, two
# returns, ~150k valid returns a frame), 80 labelled objects and 150
# detections a frame
WAYMO_SEGMENTS, WAYMO_FRAMES = 2, 20
WAYMO_WORLD = dict(n_segments=WAYMO_SEGMENTS, n_frames=WAYMO_FRAMES, n_objects=80,
                   dets_per_frame=150, seed=19)


def timed_calls(module, names, seconds, label=lambda name, args: name):
    """Wrap module.<name> for each name so that each call's wall time adds
    to seconds[label(name, args)]; returns a function that undoes it."""
    originals = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                key = label(name, args)
                seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return timed

    for n, fn in originals.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in originals.items()]


def same_pixels(a, b) -> bool:
    """Two PNGs decode to the same pixels."""
    import numpy as np
    from PIL import Image

    with Image.open(a) as x, Image.open(b) as y:
        pa, pb = np.asarray(x.convert("RGBA")), np.asarray(y.convert("RGBA"))
    return pa.shape == pb.shape and bool(np.array_equal(pa, pb))


def phase_waymo(kernels, smi):
    """Phase 19: the Waymo readers and the renderers. Synthetic raw segments
    (data.synthetic.build_synthetic_waymo, WAYMO_WORLD) go through
    tools.extract_waymo with every flag (--gt_bin, --det_bin/--det_name,
    --no_frame_gt, --raw_pc, --ground_removal), each stage timed per
    segment, then into the {split}/{lidar,annos} pkl tree and
    tools.create_data --waymo (10-sweep chains; load_waymo_points over the
    last frame's). Each segment is tracked by load_waymo_scene ->
    waymo_scene_to_mot_frames -> MOTModel on cuda and with device="cpu":
    per-frame ids and eval_waymo_tracking's summaries exactly equal,
    frames/s on both; write_objects_bin of the cuda tracks decodes back to
    the same boxes and ids. Then tools.track_scene --render serves the
    first scene of phase 15's split (write_track_split, seed 15, one scene:
    the same frames, whose lookups and convs phase 15 holds against their
    plain versions) at the full car configuration, 12 sorted_lookup + 21
    gather_conv per frame counted; its PNG equals render_scene_tracks on
    the JSON, pixel for pixel; and tools.visualize_scene renders the micro
    tree (6 files). Without matplotlib the renders are not run and say so;
    the serving runs all the same. Returns (launches, numbers)."""
    import importlib.util
    import pickle
    import shutil

    import numpy as np

    from shasta_tpu_torch.data.synthetic import (build_micro_nusc, build_synthetic_waymo,
                                                 write_split_config, write_track_split,
                                                 write_waymo_pkl_tree)
    from shasta_tpu_torch.data.waymo import (decode_objects_bin, eval_waymo_tracking,
                                             load_waymo_scene, waymo_scene_to_mot_frames,
                                             write_objects_bin)
    from shasta_tpu_torch.data.waymo_decode import load_waymo_points
    from shasta_tpu_torch.mot import MOTModel
    from shasta_tpu_torch.tools import create_data, extract_waymo, track_scene, visualize_scene
    from shasta_tpu_torch.utils import Config

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_waymo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stage_s = {}
    t0 = time.perf_counter()
    raw = build_synthetic_waymo(os.path.join(root, "raw"), **WAYMO_WORLD)
    stage_s["write segments"] = time.perf_counter() - t0
    n_frames = WAYMO_SEGMENTS * WAYMO_FRAMES
    check(all(140_000 <= p <= 160_000 for p in raw["points"]),
          f"waymo: valid returns of the first frames {raw['points']}")

    # the extraction CLI, every flag, its stages timed
    mot = os.path.join(root, "mot")
    det_name = "cp"
    undo = timed_calls(extract_waymo, ("extract_waymo_segment", "decode_objects_bin",
                                       "extract_raw_pc", "remove_ground_tree"), stage_s,
                       lambda n, a: f"{n} {a[2]}" if n == "decode_objects_bin" else n)
    try:
        segs = extract_waymo.main(
            ["--data_folder", str(raw["records"]), "--output_folder", mot, "--gt_bin",
             str(raw["gt_bin"]), "--det_bin", str(raw["det_bin"]), "--det_name", det_name,
             "--no_frame_gt", "--raw_pc", "--ground_removal"])
    finally:
        undo()
    check(segs == sorted(f"segment-{n}_with_camera_labels" for n in raw["segments"]),
          f"extract_waymo: segments {segs}")
    split_frame0 = {}  # raw, clean and ground points of each segment's first frame
    for seg in segs:
        pc = {sub: np.load(os.path.join(mot, "pc", sub, seg + ".npz"))
              for sub in ("raw_pc", "clean_pc", "ground_pc")}
        check(len(pc["raw_pc"].files) == WAYMO_FRAMES, f"{seg}: raw_pc frames")
        for k in pc["raw_pc"].files:
            n = [len(pc[sub][k]) for sub in ("raw_pc", "clean_pc", "ground_pc")]
            check(140_000 <= n[0] <= 160_000 and 0 < n[1] < n[0] and 0 < n[2] < n[0]
                  and n[1] + n[2] <= n[0],
                  f"{seg} frame {k}: {n[0]} points, {n[1]} clean, {n[2]} ground")
            split_frame0.setdefault(seg, n)
        gt = np.load(os.path.join(mot, "gt_info", seg + ".npz"), allow_pickle=True)
        dets = np.load(os.path.join(mot, "detections", det_name, "dets", seg + ".npz"),
                       allow_pickle=True)
        check([len(b) for b in gt["bboxes"]] == [WAYMO_WORLD["n_objects"]] * WAYMO_FRAMES
              and [len(b) for b in dets["bboxes"]] == [WAYMO_WORLD["dets_per_frame"]]
              * WAYMO_FRAMES and len(dets["velos"]) == WAYMO_FRAMES,
              f"{seg}: GT or detection rows per frame")
    # the {split}/{lidar,annos} pkl tree and create_data --waymo
    pkl = os.path.join(root, "pkl")
    t0 = time.perf_counter()
    write_waymo_pkl_tree(str(raw["records"]), pkl, "train")
    stage_s["pkl tree (decode_frame + decode_annos)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    infos_path = create_data.main(["--waymo", "--dataroot", pkl, "--split", "train"])
    stage_s["create_data --waymo"] = time.perf_counter() - t0
    with open(infos_path, "rb") as f:
        infos = pickle.load(f)
    check(len(infos) == n_frames and len(infos[-1]["sweeps"]) == 9
          and all(len(i["gt_boxes"]) for i in infos),
          f"create_data --waymo: {len(infos)} infos, the last with "
          f"{len(infos[-1]['sweeps'])} sweeps")
    t0 = time.perf_counter()
    pts = load_waymo_points(infos[-1], nsweeps=10)
    stage_s["load_waymo_points, 10 sweeps"] = time.perf_counter() - t0
    check(pts.shape[1] == 6 and len(pts) > 10 * 140_000 and bool(np.isfinite(pts).all()),
          f"load_waymo_points: {pts.shape}")
    per_segment = {k: v / WAYMO_SEGMENTS for k, v in stage_s.items()
                   if k != "load_waymo_points, 10 sweeps"}
    print(f"phase 19: {WAYMO_SEGMENTS} Waymo segments x {WAYMO_FRAMES} frames (depth cut from "
          f"~198 a segment), {raw['points']} valid returns in the first frames; seconds per "
          f"segment {({k: round(v, 4) for k, v in per_segment.items()})}; load_waymo_points "
          f"over 10 sweeps {stage_s['load_waymo_points, 10 sweeps']:.3f} s ({len(pts)} points)")

    # the oracle tracker over the Waymo scenes, cuda against cpu
    ids, results, seconds = {}, {}, {}
    for dev in ("cuda", "cpu"):
        ids[dev], results[dev] = {}, {}
        t0 = time.perf_counter()
        for seg in segs:
            model = MOTModel(device=dev)
            frames = [[{"id": tid, "bbox": row, "type": typ}
                       for row, tid, _, typ in model.frame_mot(fd)]
                      for fd in waymo_scene_to_mot_frames(load_waymo_scene(mot, seg, det_name))]
            results[dev][seg] = frames
            ids[dev][seg] = [[h["id"] for h in f] for f in frames]
        seconds[dev] = time.perf_counter() - t0
    check(ids["cuda"] == ids["cpu"], "waymo tracking: ids differ on cuda and cpu")
    summary = {d: eval_waymo_tracking(mot, results[d], det_name=det_name) for d in ("cuda", "cpu")}
    check(summary["cuda"] == summary["cpu"],
          f"waymo tracking: summaries differ: {summary['cuda']} vs {summary['cpu']}")
    fps = {d: n_frames / seconds[d] for d in seconds}
    n_ids = len({i for v in ids["cuda"].values() for f in v for i in f})
    # the cuda tracks as an Objects bin, decoded back
    ts = {seg: t for seg, t in zip(segs, raw["timestamps"])}
    bin_path = os.path.join(root, "tracking_pred.bin")
    n_obj = write_objects_bin({seg: {"timestamps": ts[seg], "frames": [
        [dict(h, id=str(h["id"])) for h in f] for f in results["cuda"][seg]]} for seg in segs},
        bin_path)
    decode_objects_bin(bin_path, mot, "tracking_back")
    for seg in segs:
        back = np.load(os.path.join(mot, "tracking_back", seg + ".npz"), allow_pickle=True)
        for fi, frame in enumerate(results["cuda"][seg]):
            check(list(back["ids"][fi]) == [str(h["id"]) for h in frame]
                  and np.allclose(np.asarray(back["bboxes"][fi], float).reshape(-1, 8)[:, :7],
                                  np.asarray([h["bbox"][:7] for h in frame]).reshape(-1, 7),
                                  atol=1e-5),
                  f"{seg} frame {fi}: the tracking bin does not decode back")
    veh = summary["cuda"]["vehicle"]
    print(f"phase 19: MOTModel (giou, bipartite, kf) over {n_frames} Waymo frames: cuda "
          f"{fps['cuda']:.3f} frames/s, cpu {fps['cpu']:.3f} frames/s ({smi}); ids and "
          f"eval_waymo_tracking equal on both ({n_ids} ids; vehicle MOTA {veh['mota']:.4f}); "
          f"{n_obj} tracked objects written to an Objects bin and decoded back")

    # track_scene --render over the first scene of phase 15's split
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    car = os.path.join(repo, "configs", "nusc", "car.py")
    sp = write_track_split(os.path.join(root, "split"), Config.fromfile(car), n_scenes=1,
                           n_frames=SERVE_FRAMES, seed=15)
    cfg_path = write_split_config(car, sp["val"], os.path.join(root, "car.py"))
    ckpt = random_checkpoint(Config.fromfile(cfg_path), os.path.join(root, "car.pth"), seed=15)
    png = os.path.join(root, "tracks.png")
    out = os.path.join(root, "tracking_result.json")
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--out", out]
    t0 = time.perf_counter()
    result, launches = counted(kernels, lambda: track_scene.main(
        args + (["--render", png] if have_mpl else [])))
    serve_s = time.perf_counter() - t0
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * SERVE_FRAMES, gather_conv=21 * SERVE_FRAMES,
                dense_conv=NECK_CONVS * SERVE_FRAMES)
    check(launches == want, f"track_scene --render: expected 12 sorted_lookup + 21 gather_conv "
                            f"+ {NECK_CONVS} dense_conv launches per frame, got {launches}")
    check(list(result["results"]) == sp["tokens"], "track_scene --render: tokens out of order")
    render = {}
    if have_mpl:
        from shasta_tpu_torch.viz.visualizer2d import render_scene_tracks

        with open(out) as f:
            t0 = time.perf_counter()
            render_scene_tracks(json.load(f)["results"], os.path.join(root, "again.png"))
            render["render_scene_tracks_s"] = time.perf_counter() - t0
        check(os.path.exists(png) and same_pixels(png, os.path.join(root, "again.png")),
              "track_scene --render: the PNG differs from render_scene_tracks on the JSON")
        micro = build_micro_nusc(os.path.join(root, "micro"))
        tr = os.path.join(root, "micro_tracks.json")
        with open(micro["results"]) as f:
            dets = json.load(f)["results"]
        with open(tr, "w") as f:
            json.dump({"results": {tok: [dict(d, tracking_id=str(k + 1),
                                              tracking_name=d["detection_name"],
                                              tracking_score=d["detection_score"])
                                         for k, d in enumerate(v)] for tok, v in dets.items()}},
                      f)
        t0 = time.perf_counter()
        written = visualize_scene.main(
            ["--dataroot", str(micro["root"]), "--version", "v1.0-mini", "--scene_name",
             "scene-0001", "--track_result_path", tr, "--save_path", os.path.join(root, "viz"),
             "--nsweeps", "2"])
        render["visualize_scene_s"] = time.perf_counter() - t0
        check(len(written) == 6 and all(os.path.getsize(w) > 5_000 for w in written),
              f"visualize_scene: {len(written)} files")
        print(f"phase 19: track_scene --render over {SERVE_FRAMES} frames in {serve_s:.3f} s, "
              f"launches {launches}; the PNG equals render_scene_tracks on the JSON "
              f"({render['render_scene_tracks_s']:.3f} s); visualize_scene wrote 6 files in "
              f"{render['visualize_scene_s']:.3f} s")
    else:
        print(f"phase 19: track_scene over {SERVE_FRAMES} frames in {serve_s:.3f} s, launches "
              f"{launches}; render: not run (matplotlib absent); visualize_scene: not run "
              f"(matplotlib absent)")
    seconds_phase = time.perf_counter() - t_phase
    print(f"phase 19: {seconds_phase:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return launches, dict(
        seconds_per_segment=per_segment, load_waymo_points_s=stage_s[
            "load_waymo_points, 10 sweeps"], valid_returns_first_frames=raw["points"],
        raw_clean_ground_points_frame0=split_frame0, oracle_frames=n_frames,
        oracle_frames_per_s_cuda=fps["cuda"], oracle_frames_per_s_cpu=fps["cpu"],
        oracle_ids=n_ids, summary=summary["cuda"], track_scene_s=serve_s,
        matplotlib=have_mpl, render=render or "not run (matplotlib absent)",
        seconds=seconds_phase)


ZOO_LABEL = "BEVMap frame"
# CenterPoint's nuScenes PointPillars widths (nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py)
PILLARS = dict(num_filters=(64, 64), num_input_features=5, voxel_size=(0.2, 0.2),
               pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0))
PILLAR_POINTS, PILLAR_MAX, PILLAR_GRID = 20, 30000, 512
DV_POINTS, DV_MAX = 300000, 120000
PSROI = dict(spatial_scale=0.125, output_dim=10, group_size=7, pooled_size=7,
             sample_per_part=4)


def max_err(got, want, atol, rtol, label):
    """Max abs error of got (the card) against want (the CPU); fails where
    |got - want| > atol + rtol |want| anywhere."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    check(got.shape == want.shape, f"{label}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: not finite on the card")
    bad = float(((got - want).abs() - rtol * want.abs()).max()) if got.numel() else 0.0
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(bad <= atol, f"{label}: cuda against cpu max abs err {err} (atol {atol}, rtol {rtol})")
    return err


def phase_zoo(kernels, smi):
    """Phase 20: the model zoo. BEVMap through register_all + build_from_cfg
    at configs/nusc/car.py's full width (f32, caps 100k/50k/25k/25k) from a
    trunk-only bev_map.pth (a random numpy tree through load_jax_variables,
    save_checkpoint, load_checkpoint, a strict load): one bench frame
    (V=120k, no plans) launches 12 sorted_lookup + 21 gather_conv + 14
    dense_conv and nothing else, the (1, 180, 180, 512) map is finite, the same tree's
    shared conv on it equals ShastaModel.bev_single, the path's lookups and
    convs hold against their plain versions (phase_gather_kernels), and its
    forward is timed. Then, cuda against cpu on the same weights and inputs:
    PillarFeatureNet + point_pillars_scatter at CenterPoint's nuScenes
    PointPillars widths (eval, 1e-5; the canvas exact), dynamic_voxelize and
    _virtual over 300k points at the car config's range and voxel (coords
    and valid exact, means 1e-5; one case overflows), DeformConv2d 64 -> 64
    at 1 x 180 x 180, modulated and not (1e-4), deform_psroi_pooling forward
    and its gradients with and without trans (1e-5, counts exact); and the
    profiler: a trace of two BEVMap forwards holds the second's annotate
    span and the 21 gather_conv kernels launched in it, StageTimer waits for the card, cost_analysis counts
    a 1024^3 matmul. Returns (launches, the path's kernel records, numbers)."""
    import shutil

    import numpy as np
    import torch

    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.models import (BEVMap, ShastaModel, dynamic_voxelize,
                                         dynamic_voxelize_virtual)
    from shasta_tpu_torch.models.bevmap import VOXEL_KEYS
    from shasta_tpu_torch.models.pillars import PillarFeatureNet, point_pillars_scatter
    from shasta_tpu_torch.ops.dcn import DeformConv2d, deform_psroi_pooling
    from shasta_tpu_torch.registry_setup import register_all
    from shasta_tpu_torch.timing import median_ms
    from shasta_tpu_torch.tools.common import JAX_ONLY_KEYS, model_config
    from shasta_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from shasta_tpu_torch.utils import Config, build_from_cfg
    from shasta_tpu_torch.utils.profiler import StageTimer, annotate, cost_analysis, trace

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_zoo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    nums = {}

    # BEVMap at the car config's full width from a trunk-only bev_map.pth
    car = Config.fromfile(os.path.join(repo, "configs", "nusc", "car.py"))
    served = ShastaModel(model_config(car), device="cuda")
    tree = random_jax_variables(served, seed=20)
    load_jax_variables(served, tree)
    host = BEVMap(model_config(car), device="cpu")
    load_jax_variables(host, tree)
    pth = os.path.join(root, "bev_map.pth")
    save_checkpoint(pth, host.state_dict())
    sd = load_checkpoint(pth)
    check({k.split(".")[0] for k in sd} == {"backbone", "neck"},
          f"bev_map.pth gives back {sorted({k.split('.')[0] for k in sd})}")
    regs = register_all()
    bev = build_from_cfg(dict({k: v for k, v in car.model.items() if k not in JAX_ONLY_KEYS},
                              type="BEVMap"), regs["models"])
    check(bev.device.type == "cuda" and bev.cfg.cap_conv2 == 100000 and bev.cfg.dtype is None,
          f"BEVMap built on {bev.device} with {bev.cfg}")
    bev.load_state_dict(sd, strict=True)
    batch = make_batch(bev.cfg, num_voxels_cap=120000, n_dets=60, seed=0)
    frame = {k: torch.from_numpy(batch[k]).cuda() for k in VOXEL_KEYS}
    with torch.no_grad():
        bev(frame)  # warm-up
        bmap, launches = counted(kernels, lambda: bev(frame))
        want = {k.__name__: 0 for k in kernels}
        want.update(sorted_lookup=12, gather_conv=21, dense_conv=NECK_CONVS - 1)
        check(launches == want, f"BEVMap: expected 12 sorted_lookup + 21 gather_conv + "
                                f"{NECK_CONVS - 1} dense_conv (no shared conv), got {launches}")
        check(tuple(bmap.shape) == (1, 180, 180, 512) and bool(torch.isfinite(bmap).all()),
              f"BEVMap: map {tuple(bmap.shape)}, not finite or not (1, 180, 180, 512)")
        mine = served.shared_conv(bmap.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        want_bev = served.bev_single(frame)
        diff = float((mine - want_bev).abs().max())
        check(diff <= 1e-5, f"BEVMap + shared conv differs from bev_single by {diff}")
        nums["bevmap_vs_bev_single_max_abs"] = diff
        nums["bevmap_vs_bev_single_bit_equal"] = bool(torch.equal(mine, want_bev))
        nums["bevmap_ms"] = median_ms(lambda: bev(frame))
    print(f"phase 20: BEVMap (register_all + build_from_cfg, car config, f32) from a "
          f"trunk-only bev_map.pth ({len(sd)} tensors, strict); one bench frame "
          f"({int(batch['voxels_valid'].sum())} voxels): launches {launches}, map "
          f"{tuple(bmap.shape)}; shared conv on it vs bev_single max abs {diff:.3g} (bit-equal "
          f"{nums['bevmap_vs_bev_single_bit_equal']}); forward {nums['bevmap_ms']:.3f} ms "
          f"({smi})")
    gather = phase_gather_kernels(ZOO_LABEL, lambda: bev(frame))

    rng = np.random.default_rng(20)
    # PointPillars: 30k pillars on distinct cells of the 512 x 512 canvas
    cells = rng.choice(PILLAR_GRID * PILLAR_GRID, PILLAR_MAX, replace=False)
    cy, cx = cells // PILLAR_GRID, cells % PILLAR_GRID
    npts = rng.integers(1, PILLAR_POINTS + 1, PILLAR_MAX).astype(np.int32)
    P = PILLAR_POINTS
    vox = np.zeros((PILLAR_MAX, P, 5), np.float32)
    vox[:, :, 0] = (cx[:, None] + rng.uniform(0, 1, (PILLAR_MAX, P))) * 0.2 - 51.2
    vox[:, :, 1] = (cy[:, None] + rng.uniform(0, 1, (PILLAR_MAX, P))) * 0.2 - 51.2
    vox[:, :, 2] = rng.uniform(-5, 3, (PILLAR_MAX, P))
    vox[:, :, 3:] = rng.uniform(0, 1, (PILLAR_MAX, P, 2))
    vox[np.arange(P)[None, :] >= npts[:, None]] = 0.0
    coords3 = np.stack([np.zeros_like(cy), cy, cx], 1).astype(np.int32)
    coords4 = np.concatenate([np.zeros((PILLAR_MAX, 1), np.int32), coords3], 1)
    valid = rng.random(PILLAR_MAX) > 0.05
    outs = {}
    for d in ("cuda", "cpu"):
        pfn = PillarFeatureNet(**PILLARS, device=d).eval()
        load_jax_variables(pfn, random_jax_variables(pfn, seed=21))
        args = [torch.from_numpy(a).to(d) for a in (vox, npts, coords3)]
        c4, ok = torch.from_numpy(coords4).to(d), torch.from_numpy(valid).to(d)

        def pillars():
            feats = pfn(*args)
            return feats, point_pillars_scatter(feats, c4, ok, 1, PILLAR_GRID, PILLAR_GRID)
        with torch.no_grad():
            outs[d] = pillars()
            if d == "cuda":
                nums["pillars_ms"] = median_ms(pillars)
    nums["pillars_max_abs"] = max_err(outs["cuda"][0], outs["cpu"][0], 1e-5, 1e-5,
                                      "PillarFeatureNet")
    check(torch.equal(outs["cuda"][1].cpu(), point_pillars_scatter(
        outs["cuda"][0].cpu(), torch.from_numpy(coords4), torch.from_numpy(valid), 1,
        PILLAR_GRID, PILLAR_GRID)), "point_pillars_scatter: the card's canvas differs")
    check(tuple(outs["cuda"][1].shape) == (1, PILLAR_GRID, PILLAR_GRID, 64)
          and int((outs["cuda"][1].abs().sum(-1) > 0).sum()) <= int(valid.sum()),
          "point_pillars_scatter: canvas shape or filled cells")
    print(f"phase 20: PillarFeatureNet (64, 64) + point_pillars_scatter over {PILLAR_MAX} "
          f"pillars x {P} points -> 1 x 512 x 512 x 64: cuda vs cpu max abs "
          f"{nums['pillars_max_abs']:.3g}, canvas exact; {nums['pillars_ms']:.3f} ms on the card")

    # dynamic voxels: 300k points around 30k spots of the car range (under the cap)
    cr, vs = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), (0.075, 0.075, 0.2)
    centers = rng.uniform([-54, -54, -5], [54, 54, 3], size=(30000, 3))
    xyz = centers[rng.integers(0, len(centers), DV_POINTS)] + rng.normal(0, 0.02, (DV_POINTS, 3))
    dv = {}
    for C, fn, name in ((5, dynamic_voxelize, "plain"), (16, dynamic_voxelize_virtual, "virtual")):
        pts = np.concatenate([xyz, rng.uniform(0, 1, (DV_POINTS, C - 3))], 1).astype(np.float32)
        if name == "virtual":
            pts[:, -2] = rng.choice([1.0, 0.0, -1.0], DV_POINTS)
        ok = np.ones(DV_POINTS, bool)
        ok[-1000:] = False
        for cap in (DV_MAX, None):
            res = {}
            for d in ("cuda", "cpu"):
                tp, tv = torch.from_numpy(pts).to(d), torch.from_numpy(ok).to(d)
                res[d] = fn(tp, tv, cr, vs, cap or dv["unique"] // 2)
            n = int(res["cpu"][2].sum())
            if cap:
                dv.setdefault("unique", n)
                check(n < DV_MAX, f"dynamic voxels: {n} voxels reach the cap {DV_MAX}")
            else:
                check(n == dv["unique"] // 2, f"dynamic voxels overflow: {n} slots")
            label = f"dynamic_voxelize {name} cap {cap or 'half'}"
            check(torch.equal(res["cuda"][1].cpu(), res["cpu"][1])
                  and torch.equal(res["cuda"][2].cpu(), res["cpu"][2]),
                  f"{label}: coords or valid differ on cuda and cpu")
            dv[label] = max_err(res["cuda"][0], res["cpu"][0], 1e-5, 1e-5, label)
        tp, tv = torch.from_numpy(pts).cuda(), torch.from_numpy(ok).cuda()
        dv[f"{name}_ms"] = median_ms(lambda: fn(tp, tv, cr, vs, DV_MAX))
    nums["dynamic_voxels"] = dv
    print(f"phase 20: dynamic voxels over {DV_POINTS} points ({dv['unique']} voxels of the "
          f"0.075 x 0.075 x 0.2 grid, cap {DV_MAX}; overflow at {dv['unique'] // 2}): coords "
          f"and valid exact, means max abs {max(v for k, v in dv.items() if 'cap' in k):.3g}; "
          f"{dv['plain_ms']:.3f} / {dv['virtual_ms']:.3f} ms (plain / virtual) on the card")

    # DCN at the neck's output widths
    x = rng.normal(size=(1, 180, 180, 64)).astype(np.float32)
    for modulated in (False, True):
        res = {}
        for d in ("cuda", "cpu"):
            m = DeformConv2d(64, 64, modulated=modulated, device=d)
            load_jax_variables(m, random_jax_variables(m, seed=22))
            with torch.no_grad():
                res[d] = m(torch.from_numpy(x).to(d))
                if d == "cuda":
                    tx = torch.from_numpy(x).cuda()
                    nums[f"dcn_{'v2' if modulated else 'v1'}_ms"] = median_ms(lambda: m(tx))
        nums[f"dcn_{'v2' if modulated else 'v1'}_max_abs"] = max_err(
            res["cuda"], res["cpu"], 1e-4, 1e-4, f"DeformConv2d modulated={modulated}")
    print(f"phase 20: DeformConv2d 64 -> 64 at 1 x 180 x 180: cuda vs cpu max abs "
          f"{nums['dcn_v1_max_abs']:.3g} (v1) / {nums['dcn_v2_max_abs']:.3g} (v2); "
          f"{nums['dcn_v1_ms']:.3f} / {nums['dcn_v2_ms']:.3f} ms on the card")

    # deformable PS-RoI pooling: 128 rois on a 2 x 180 x 180 x 490 map
    D, G = PSROI["output_dim"], PSROI["group_size"]
    data = rng.normal(size=(2, 180, 180, D * G * G)).astype(np.float32)
    xy = rng.uniform(0, 1400, (128, 2))
    wh = rng.uniform(16, 400, (128, 2))
    rois = np.concatenate([rng.integers(0, 2, (128, 1)), xy, xy + wh], 1).astype(np.float32)
    trans = rng.normal(size=(128, 2, 7, 7)).astype(np.float32)
    for with_trans in (False, True):
        kw = dict(PSROI, trans_std=0.1 if with_trans else 0.0)
        res = {}
        for d in ("cuda", "cpu"):
            td = torch.from_numpy(data).to(d).requires_grad_()
            tt = torch.from_numpy(trans).to(d).requires_grad_() if with_trans else None
            out, cnt = deform_psroi_pooling(td, torch.from_numpy(rois).to(d), tt, **kw)
            (out ** 2).sum().backward()
            res[d] = out, cnt, td.grad, None if tt is None else tt.grad
        tag = "trans" if with_trans else "no trans"
        check(torch.equal(res["cuda"][1].cpu(), res["cpu"][1]),
              f"deform_psroi_pooling {tag}: counts differ on cuda and cpu")
        nums[f"psroi_{tag}_max_abs"] = max(
            max_err(res["cuda"][i], res["cpu"][i], 1e-5, 1e-5,
                    f"deform_psroi_pooling {tag} {what}")
            for i, what in ((0, "out"), (2, "grad data"), (3, "grad trans"))
            if res["cpu"][i] is not None)
        td = torch.from_numpy(data).cuda()
        tt = torch.from_numpy(trans).cuda() if with_trans else None
        tr = torch.from_numpy(rois).cuda()
        with torch.no_grad():
            nums[f"psroi_{tag}_ms"] = median_ms(lambda: deform_psroi_pooling(td, tr, tt, **kw))
    print(f"phase 20: deform_psroi_pooling, 128 rois on 2 x 180 x 180 x 490, pooled 7, 4 "
          f"samples: forward and grads cuda vs cpu max abs {nums['psroi_no trans_max_abs']:.3g}"
          f" / {nums['psroi_trans_max_abs']:.3g} (without / with trans), counts exact; "
          f"forward {nums['psroi_no trans_ms']:.3f} / {nums['psroi_trans_ms']:.3f} ms on the card")

    # the profiler around one BEVMap forward
    prof_dir = os.path.join(root, "trace")
    with torch.no_grad(), trace(prof_dir):
        # a forward ahead of the spanned one: the window can lose its first
        # kernels, whose stamps on the card's clock fall before it opened
        bev(frame)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with annotate("zoo.bevmap"):
            bev(frame)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    files = [os.path.join(r, f) for r, _, fs in os.walk(prof_dir) for f in fs]
    check(len(files) == 1, f"trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "zoo.bevmap"
             and e.get("cat") == "user_annotation"]  # the host's span, not its card copy
    check(len(spans) == 1, f"the trace holds {len(spans)} zoo.bevmap spans")
    # the spanned forward's kernels: those whose launch lies inside the span
    t_a, t_b = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and t_a <= e["ts"] <= t_b
                and "correlation" in e.get("args", {})}
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched:
            by_name[e["name"]][0] += e["dur"] / 1e3
            by_name[e["name"]][1] += 1
    top = sorted(((ms, count, key) for key, (ms, count) in by_name.items()), reverse=True)
    busy = sum(t[0] for t in top)
    print(f"phase 20: one profiled BEVMap forward: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"over {sum(t[1] for t in top)} kernels launched in its span ({len(launched)} runtime "
          f"calls); device ms, launches, kernel:")
    for ms, count, key in top[:6]:
        print(f"    {ms:9.3f} {count:7d}  {key[:100]}")
    # gather_conv's device kernels are gather_mma.cuh's cores over its finder
    gconv = sum(count for _, count, key in top if "GatherFind" in key)
    check(gconv == 21, f"the trace holds {gconv} gather_conv kernels of the spanned forward, "
                       f"not 21")
    timer = StageTimer()
    big = torch.ones(4096, 4096, device="cuda")
    with timer.stage("matmul", block_on=big):
        big = big @ big
    ms_timer = timer.summary()["matmul"]["mean_ms"]
    a = torch.randn(1024, 1024, device="cuda")
    flops = cost_analysis(lambda u, v: u @ v, a, a)["flops"]
    check(flops >= 2 * 1024**3, f"cost_analysis of a 1024^3 matmul: {flops} FLOPs")
    nums.update(profiled_wall_ms=wall, device_busy_ms=busy,
                top_kernels=[{"ms": ms, "launches": c, "name": k} for ms, c, k in top[:6]],
                trace_events=len(events), trace_gather_conv_kernels=gconv,
                stage_timer_matmul_ms=ms_timer, cost_analysis_flops=flops)
    print(f"phase 20: profiler: a trace of {len(events)} events with the zoo.bevmap span and "
          f"{gconv} gather_conv kernels; StageTimer around a 4096^3 matmul {ms_timer:.3f} ms "
          f"(host clock, waited for the card); cost_analysis of a 1024^3 matmul {flops} FLOPs")
    nums["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20: {nums['seconds']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return launches, gather, nums


NECK_BATCHES = (1, 8)
# the pillar trunk (CenterPoint-PP under ShaSTA's car head) as the
# benchmark's configuration shasta-car-pp runs it: its neck takes a 64 x
# 512 x 512 canvas, 20 dense_conv launches a frame (the RPN's 16 convs and
# 3 deblocks, the shared conv 384 -> 64)
PILLAR_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trackbench",
                             "configs", "shasta-car-pp.json")
PILLAR_CONVS = 20


def pillar_model() -> dict:
    """The model keys of the benchmark's pillar configuration."""
    with open(PILLAR_CONFIG) as f:
        return json.load(f)["model"]


def pillar_neck_dims(m: dict) -> dict:
    """RPN's keyword arguments at the pillar configuration's neck."""
    return dict(layer_nums=m["layer_nums"], ds_layer_strides=m["ds_layer_strides"],
                ds_num_filters=m["ds_num_filters"], us_layer_strides=m["us_layer_strides"],
                us_num_filters=m["us_num_filters"], num_input_features=m["neck_input_features"])


def random_neck(dev, seed=0, dims=None):
    """A neck, RPN(**dims) (default the car neck, RPN 256 -> 512), and its
    shared conv (the deblocks' channels -> 64) on `dev` in eval mode:
    weights N(0, 1/fan_in), BN scales 1 + N(0, 0.1), shifts and means N(0,
    0.1), variances U(0.5, 2), biases N(0, 0.1)."""
    import torch
    from torch import nn

    from shasta_tpu_torch.models.rpn import RPN, SharedConv

    g = torch.Generator().manual_seed(seed)
    neck = RPN(**(dims or {}))
    shared = SharedConv(sum(d[0].out_channels for d in neck.deblocks), 64)
    with torch.no_grad():
        for m in (*neck.modules(), *shared.modules()):
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) else m.weight.shape[0]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    return neck.to(dev).eval(), shared.to(dev).eval()


def neck_convs(neck, shared, x):
    """[(name, NHWC input, Packed, conv module)] of the neck's convs in
    launch order on x (B, Cin, H, W), each input made by the plain version."""
    import torch

    from shasta_tpu_torch.models import rpn
    from shasta_tpu_torch.ops.kernels import dense_conv as dc

    out, cat, h = [], [], x.permute(0, 2, 3, 1).contiguous()
    for i, (blk, de) in enumerate(zip(neck.blocks, neck.deblocks)):
        for j, (conv, bn, pad) in enumerate(rpn._conv_bns(blk)):
            p = dc.pack(conv, bn, pad)
            out.append((f"block{i}.conv{j}", h, p, conv))
            h = dc.dense_conv_plain(h, p)
        (conv, bn, pad), = rpn._conv_bns(de)
        p = dc.pack(conv, bn, pad)
        out.append((f"deblock{i}", h, p, conv))
        cat.append(dc.dense_conv_plain(h, p))
    (conv, bn, pad), = rpn._conv_bns(shared)
    out.append(("shared", torch.cat(cat, dim=3).contiguous(), dc.pack(conv, bn, pad), conv))
    return out


def phase_neck(smi):
    """21. the neck's conv kernel (dense_conv) at two necks' shapes, f32,
    TF32 off: the car neck (256 x 180 x 180 in, B=1 and B=8, 15 convs) and
    the pillar neck (the published 64 x 512 x 512 canvas, B=1, 20 convs:
    64-channel 3x3 convs over 256 x 256, the 2x2 stride-2 deblock, the
    shared conv 384 -> 64 at 128 x 128). Each conv and the whole neck
    against the plain version within 1e-4 x max(1, |out|), the launches of
    a neck call (counted), and each conv's time beside its bound (the car
    neck: 2 M K N FLOPs at 495/3 TFLOP/s; the pillar neck:
    trackbench/count/pillars.py's, its FLOPs at that rate or its bytes at
    HBM's, the larger), its plain version's and the library's (F.conv2d or
    F.conv_transpose2d under cuDNN, TF32 off, on the NCHW input without
    BN: the route the neck took before, as a yardstick only); the whole
    neck by the kernel route and by `_run`."""
    import torch
    import torch.nn.functional as F

    from shasta_tpu_torch.models import rpn
    from shasta_tpu_torch.ops.kernels import dense_conv as dc
    from shasta_tpu_torch.timing import PRODUCT_FLOPS_PER_S, median_ms
    from trackbench.count import pillars as cp

    dev = torch.device("cuda")
    m = pillar_model()
    res = {"card": smi}
    for label, (neck, shared), shape, batches, n_convs, bounds in (
            ("car", random_neck(dev), (256, 180, 180), NECK_BATCHES, NECK_CONVS, None),
            ("pillars", random_neck(dev, 1, pillar_neck_dims(m)),
             (m["neck_input_features"], *m["grid_shape"][1:]), (1,), PILLAR_CONVS,
             {c["name"]: cp.conv_least_s(c) * 1e3 for c in cp.neck_convs(m)})):
        res[label] = {}
        for B in batches:
            x = torch.randn(B, *shape, generator=torch.Generator().manual_seed(B))
            if bounds:  # a pillar canvas holds the reader's ReLU outputs
                x = torch.relu(x)
            x = x.to(dev)
            recs = []
            with torch.no_grad():
                convs = neck_convs(neck, shared, x)
                check(len(convs) == n_convs, f"{label} neck: {len(convs)} convs, not {n_convs}")
                for name, h, p, conv in convs:
                    want = dc.dense_conv_plain(h, p)
                    got = dc.dense_conv(h, p)
                    err = (got - want).abs().max().item()
                    scale = max(1.0, want.abs().max().item())
                    check(err <= 1e-4 * scale, f"{label} neck B={B} {name}: max abs error "
                                               f"{err} over 1e-4 x {scale}")
                    Ho, Wo = dc.out_grid(h, p)
                    M, N, K = B * Ho * Wo, p.w.shape[0], p.w.shape[1]
                    flops = 2.0 * M * N * K
                    xin = h.permute(0, 3, 1, 2).contiguous()
                    if isinstance(conv, torch.nn.ConvTranspose2d):
                        lib = lambda: F.conv_transpose2d(xin, conv.weight, None, conv.stride)
                    else:
                        lib = lambda: F.conv2d(xin, conv.weight, conv.bias, conv.stride,
                                               p.pad)
                    recs.append(dict(
                        name=name, M=M, N=N, K=K, tile_rows=dc.tile_rows(M, N),
                        gflop=flops / 1e9, ms=median_ms(lambda: dc.dense_conv(h, p)),
                        plain_ms=median_ms(lambda: dc.dense_conv_plain(h, p)),
                        library_ms=median_ms(lib),
                        bound_ms=(bounds[name] if bounds
                                  else flops / PRODUCT_FLOPS_PER_S["float32"] * 1e3),
                        max_abs_err=err, scale=scale))
                    del want, got, xin
                del convs
                before = dc.dense_conv.launches
                got = shared(neck(x))
                launches = dc.dense_conv.launches - before
                check(launches == n_convs, f"{label} neck B={B}: {launches} dense_conv "
                                           f"launches, not {n_convs}")
                kernel_route, rpn.kernel_route = rpn.kernel_route, lambda m, t: False
                try:
                    want = shared(neck(x))
                    run_ms = median_ms(lambda: shared(neck(x)), reps=5)
                finally:
                    rpn.kernel_route = kernel_route
                err = (got - want).abs().max().item()
                scale = max(1.0, want.abs().max().item())
                check(err <= 1e-4 * scale, f"{label} neck B={B}: max abs error {err} over "
                                           f"1e-4 x {scale}")
                neck_ms = median_ms(lambda: shared(neck(x)))
            tot = {k: sum(r[k] for r in recs) for k in ("ms", "plain_ms", "library_ms",
                                                        "bound_ms", "gflop")}
            res[label][B] = dict(convs=recs, launches=launches, neck_ms=neck_ms, run_ms=run_ms,
                                 max_abs_err=err, **{"sum_" + k: v for k, v in tot.items()})
            print(f"phase 21: {label} neck B={B}: {n_convs} convs {tot['ms']:.4f} ms (bound "
                  f"{tot['bound_ms']:.4f}, {tot['gflop']:.1f} GFLOP; plain "
                  f"{tot['plain_ms']:.4f}, cuDNN {tot['library_ms']:.4f}); whole neck "
                  f"{neck_ms:.4f} ms by the kernel route, {run_ms:.4f} by _run; max abs error "
                  f"{err:.3g} ({smi})")
            for r in recs:
                print(f"  {r['name']}: M {r['M']} N {r['N']} K {r['K']} BM {r['tile_rows']}: "
                      f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, "
                      f"cuDNN {r['library_ms']:.4f}), err {r['max_abs_err']:.3g}")
            del x, got, want
        del neck, shared
    return res


PILLAR_SCENES, PILLAR_FRAMES = 2, 6
PILLAR_LABEL = "pillar trunk, track_scene"


def phase_pillars(kernels, smi):
    """22. the pillar trunk served: configs/nusc/pp/car.py (CenterPoint-PP's
    reader, scatter and three-block neck at published widths, under
    ShaSTA's car head and tracker) over a synthetic split, each frame
    voxelized by the config's point pipeline into 60,000 x 20 pillar
    slots, through tools.track_scene (ScenePipeline.step_frame, f32): the
    launches counted from 0 just before (20 dense_conv a frame and no
    other kernel), ids carried over frames; a served frame's BEV map by
    the kernel route against `_run` (1e-4 x max(1, |out|)); one traced
    frame, after another: its step.pillars span inside step.trunk and no
    step.sparse_trunk, the pillars.* and neck.kernel_convs counters, the
    20 dense_conv kernels launched under step.neck and no library conv or
    GEMM there; and the step's frames/s over the frames in memory.
    Returns (launches, numbers)."""
    import re
    import shutil

    import torch

    from shasta_tpu_torch.data.synthetic import write_split_config, write_track_split
    from shasta_tpu_torch.device import upload
    from shasta_tpu_torch.infer import FRAME_KEYS, track_scene_dataset
    from shasta_tpu_torch.models import rpn
    from shasta_tpu_torch.tools import track_scene
    from shasta_tpu_torch.tools.common import (build_dataset, build_model, build_pipeline,
                                               load_model)
    from shasta_tpu_torch.train.checkpoint import save_checkpoint
    from shasta_tpu_torch.utils import Config, profiler

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "work_dirs", "chip_smoke_pillars")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    base = os.path.join(repo, "configs", "nusc", "pp", "car.py")
    sp = write_track_split(os.path.join(root, "data"), Config.fromfile(base),
                           n_scenes=PILLAR_SCENES, n_frames=PILLAR_FRAMES, seed=22)
    cfg_path = write_split_config(base, sp["val"], os.path.join(root, "car_pp.py"))
    cfg = Config.fromfile(cfg_path)
    sd = build_model(cfg, "cpu", seed=22).state_dict()
    # random heads are near uniform and fire no decision: sharpen the last layer
    sd["aff.10.weight"] *= 10.0
    sd["aff.10.bias"] *= 10.0
    sd["aff.10.bias"][-2:] += 5.0
    ckpt = os.path.join(root, "car_pp.pth")
    save_checkpoint(ckpt, sd)
    n = PILLAR_SCENES * PILLAR_FRAMES

    # the CLI on the card, counted
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--out", os.path.join(root, "t.json")]
    result, launches = counted(kernels, lambda: track_scene.main(args))
    want = {k.__name__: 0 for k in kernels}
    want["dense_conv"] = PILLAR_CONVS * n
    check(launches == want, f"pillar trunk: expected {PILLAR_CONVS} dense_conv launches a "
                            f"frame and no other kernel, got {launches}")
    check(list(result["results"]) == sp["tokens"], "pillar trunk: tokens out of order")
    ids = [{a["tracking_id"] for a in result["results"][t]} for t in sp["tokens"]]
    carried = sum(len(a & b) for a, b in zip(ids, ids[1:]))
    check(carried > 0, "pillar trunk: no id carried over a frame")
    ds = build_dataset(cfg, "val")
    samples = [ds[i] for i in range(n)]
    kept = [int(s["voxels_valid"].sum()) for s in samples]
    check(samples[0]["voxels"].shape == (60000, 20, 5),
          f"pillar trunk: a frame's pillars {samples[0]['voxels'].shape}")
    print(f"phase 22: track_scene CLI, pillar trunk on cuda: {n} frames, "
          f"{sum(map(len, result['results'].values()))} annotations, {carried} ids carried "
          f"over frames; launches {launches} ({launches['dense_conv'] / n:g} dense_conv a "
          f"frame); filled pillars a frame {kept} of 60,000")

    # a served frame's map by the kernel route against _run
    pipe = build_pipeline(cfg, load_model(cfg, ckpt, "cuda"))
    frame = {k: upload(samples[1][k][None], "cuda") for k in FRAME_KEYS}
    with torch.no_grad():
        got = pipe.model.bev_single(frame)
        kernel_route, rpn.kernel_route = rpn.kernel_route, lambda m, t: False
        try:
            want_bev = pipe.model.bev_single(frame)
        finally:
            rpn.kernel_route = kernel_route
    err = (got - want_bev).abs().max().item()
    scale = max(1.0, want_bev.abs().max().item())
    check(tuple(got.shape) == (1, 128, 128, 64) and err <= 1e-4 * scale,
          f"pillar trunk: map {tuple(got.shape)}, max abs error {err} over 1e-4 x {scale}")
    del got, want_bev, frame

    # one traced frame, after another
    def step(s):
        pipe.step_frame({k: s[k][None] for k in FRAME_KEYS}, len(s["cls_det_boxes"]), 0.5)
        torch.cuda.synchronize()

    prof_dir = os.path.join(root, "trace")
    profiler.reset_counters()
    with profiler.trace(prof_dir):
        step(samples[0])
        step(samples[1])
    counts = profiler.counters()
    profiler.reset_counters()
    check(counts.get("pillars.kept") == [kept[0] + kept[1]]
          and counts.get("pillars.slots") == [2 * 60000]
          and counts.get("neck.kernel_convs") == 2 * PILLAR_CONVS,
          f"pillar trunk: counters {counts}, filled pillars {kept[:2]}")
    files = [os.path.join(r, f) for r, _, fs in os.walk(prof_dir) for f in fs]
    check(len(files) == 1, f"trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("step."):
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    check(len(spans["step.pillars"]) == 2 and not spans["step.sparse_trunk"]
          and all(any(a <= p and q <= b for a, b in spans["step.trunk"])
                  for p, q in spans["step.pillars"]),
          f"pillar trunk: spans {dict(spans)}")

    def kernels_in(span):  # the kernels whose launch lies inside the span
        t_a, t_b = span
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver") and t_a <= e["ts"] <= t_b
                    and "correlation" in e.get("args", {})}
        return [(e["name"], e["dur"] / 1e3) for e in events
                if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched]

    in_neck = kernels_in(spans["step.neck"][-1])
    in_pillars = kernels_in(spans["step.pillars"][-1])
    n_dense = sum("dense_conv" in k for k, _ in in_neck)
    library = sorted({k for k, _ in in_neck if "dense_conv" not in k
                      and re.search("cudnn|conv|fft|gemm|gemv", k, re.I)})
    check(n_dense == PILLAR_CONVS and not library,
          f"pillar trunk: {n_dense} dense_conv kernels under step.neck, library {library}")
    neck_dev_ms = sum(ms for _, ms in in_neck)
    pillars_dev_ms = sum(ms for _, ms in in_pillars)
    print(f"phase 22: a traced frame: step.pillars inside step.trunk, no step.sparse_trunk; "
          f"counters {counts}; under step.neck {len(in_neck)} kernels, {n_dense} dense_conv, "
          f"no library conv or GEMM, {neck_dev_ms:.4f} device ms; under step.pillars "
          f"{len(in_pillars)} kernels, {pillars_dev_ms:.4f} device ms")

    # the step's frames/s over the frames in memory
    track_scene_dataset(pipe, samples)  # warm-up
    runs = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        track_scene_dataset(pipe, samples)
        torch.cuda.synchronize()
        runs.append(n / (time.perf_counter() - t0))
    fps = statistics.median(runs)
    shutil.rmtree(root, ignore_errors=True)
    nums = dict(frames=n, dense_conv_per_frame=launches["dense_conv"] / n, filled_pillars=kept,
                bev_max_abs_err=err, counters=counts, neck_kernels=len(in_neck),
                neck_dev_ms=neck_dev_ms, pillars_dev_ms=pillars_dev_ms, frames_per_s=fps,
                frames_per_s_runs=runs, seconds=time.perf_counter() - t_phase)
    print(f"phase 22: {TIMED_RUNS} runs of {n} frames from memory at "
          f"{[round(x, 3) for x in runs]} frames/s (median {fps:.3f}) ({smi}); "
          f"{nums['seconds']:.1f} s")
    return launches, nums


def bound_of(rec) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of a kernel record's counted
    bytes and operations on the H100 (shasta_tpu_torch.timing): a conv's
    products at the rate of its record's dtype (bf16 on the tensor cores,
    f32 as three TF32 passes)."""
    from shasta_tpu_torch.timing import HBM_BYTES_PER_S, PRODUCT_FLOPS_PER_S, ops_ms

    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_ms(int32=rec["ops"]) if "ops" in rec
             else rec["flops"] / PRODUCT_FLOPS_PER_S[rec["dtype"]] * 1e3)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", metavar="CSRC",
                    help="also time gather_conv's f32 route built from this csrc directory "
                         "(another checkout's shasta_tpu_torch/csrc, such as a redesign's "
                         "parent) in turns with this one, on every f32 path's tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from shasta_tpu_torch import resolve_device
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.infer import FRAME_KEYS, BatchedScenePipeline, ScenePipeline
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.ops.kernels import (block_conv, block_extract, build, dense_conv,
                                              gather_conv, lookup, window_conv)
    from shasta_tpu_torch.plans import attach_plans, frame_plans
    from shasta_tpu_torch.profile_step import (CAR, bench_frame, car_setup, multiclass_setup,
                                               without_plans)

    t_start = time.perf_counter()
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
    if args.before:
        global BEFORE_CONV
        t0 = time.perf_counter()
        BEFORE_CONV = load_before_conv(args.before)
        print(f"phase 2: built gather_conv from {args.before} (--before) in "
              f"{time.perf_counter() - t0:.1f} s")
    kernels = (block_conv.rulebook_conv, window_conv.keyed_conv, lookup.sorted_lookup,
               gather_conv.gather_conv, block_extract.block_extract, dense_conv.dense_conv)
    path_launches = {}  # main path -> {kernel: launches in its run}

    # bench-scale frame, its host plans and the bf16 model (bench.py:39-41,121-148)
    t0 = time.perf_counter()
    cfg, batch, plans, model, frame = car_setup(dev)
    print(f"set-up (frame, host plans, weights): {time.perf_counter() - t0:.2f} s")
    # the 4-lane frame and model of bench.py --lanes 4 (bench.py:75-97,121-134)
    t0 = time.perf_counter()
    cfg4, _, _, model4, frame4 = car_setup(dev, lanes=LANES)
    # the two-frame forward's pair: the frames of seeds 0 and 1, caps that
    # hold both frames' sets whole
    cfg2 = ShastaConfig(**dict(CAR, **PAIR_CAPS), dtype=torch.bfloat16)
    _, _, frame2 = bench_frame(cfg2, dev, lanes=2)
    model2 = ShastaModel(cfg2, device=dev)
    load_jax_variables(model2, random_jax_variables(model2, seed=0))
    print(f"set-up, {LANES} and 2 lanes (frames, weights): {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    print("phase 3: kernels vs plain versions at main-path shapes")
    per_kernel = phase_kernels(cfg, batch, plans, dev)
    gather_paths = {}
    for phase, label, run in (
            ("3b", f"{LANES}-lane step", lambda: model4.bev_single(frame4)),
            ("3c", "B=1 frame without plans", lambda: model.bev_single(without_plans(frame))),
            ("3d", "two-frame forward", lambda: model2.bev_maps(
                {p + k: frame2[k][i:i + 1] for i, p in enumerate(("", "prev_"))
                 for k in FRAME_KEYS}))):
        print(f"phase {phase}: kernels vs plain versions at the {label}'s shapes")
        gather_paths[label] = phase_gather_kernels(label, run)
    per_kernel.update(gather_paths[f"{LANES}-lane step"])

    # 4. full-width serving step
    drive_pipeline(model, frame, 60, WARMUP_FRAMES)
    fps_runs, outs = [], []

    def timed4():
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            outs.extend(drive_pipeline(model, frame, 60, TIMED_FRAMES))
            torch.cuda.synchronize()
            fps_runs.append(TIMED_FRAMES / (time.perf_counter() - t0))
    _, launches = counted(kernels, timed4)
    path_launches["4: B=1 step with plans"] = launches
    fps = statistics.median(fps_runs)
    n_frames = TIMED_RUNS * TIMED_FRAMES
    print(f"phase 4: {TIMED_RUNS} runs of {TIMED_FRAMES} frames at "
          f"{[round(x, 3) for x in fps_runs]} frames/s (median {fps:.3f}); "
          f"launches {launches}")
    want = {k.__name__: 0 for k in kernels}
    want.update(rulebook_conv=11 * n_frames, keyed_conv=10 * n_frames)
    check(launches == want, f"expected 11 + 10 kernel launches per frame, got {launches}")
    with torch.no_grad():
        feat = model.frame_features(frame)
        m1, m2 = model.affinity_step(frame["det_boxes"], frame["det_boxes"], feat, feat)
    want_shape = (1, cfg.max_obj, cfg.num_point * cfg.share_conv_channel)
    check(tuple(feat.shape) == want_shape and bool(torch.isfinite(feat).all()),
          f"descriptors are not finite {want_shape}")
    check_affinity(m1, m2, "B=1")
    for out in outs:
        check(out.used.any() and bool((out.tid[out.used] >= 1).all()),
              "a used det row has no id >= 1")
    print(f"phase 4 checks ok; last ids {outs[-1].tid[:12].tolist()}")

    # 5. small configuration, with host plans and without: cuda against cpu
    small_cfg = ShastaConfig(**SMALL)
    for route in ("plans", "no plans"):
        runs = {}
        for d in ("cuda", "cpu"):
            m = ShastaModel(small_cfg, device=d)
            load_jax_variables(m, random_jax_variables(m, seed=1))
            pipe5 = ScenePipeline(m, cls_id=2)
            res = []
            for s in range(3):
                b = make_batch(small_cfg, num_voxels_cap=2500, n_dets=7, seed=s)
                if route == "plans":
                    b = attach_plans(b, frame_plans(b["coordinates"][0], b["voxels_valid"][0],
                                                    small_cfg))
                res.append(pipe5.step_frame(b, 7, 0.5))
            runs[d] = res
        for a, b in zip(runs["cuda"], runs["cpu"]):
            for field in ("tid", "used", "keep", "fn"):
                check(np.array_equal(getattr(a, field), getattr(b, field)),
                      f"small config, {route}: cuda and cpu differ in {field}")
            check(np.allclose(a.ref, b.ref, atol=1e-4), f"small config, {route}: ref differs")
    print("phase 5: small config cuda == cpu, with host plans and without")

    # 6. full-width scene-batched step, 4 lanes
    drive_batched(model4, frame4, 2)
    sps_runs, outs4 = [], []

    def timed6():
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            outs4.extend(drive_batched(model4, frame4, TIMED_STEPS))
            torch.cuda.synchronize()
            sps_runs.append(LANES * TIMED_STEPS / (time.perf_counter() - t0))
    _, launches6 = counted(kernels, timed6)
    path_launches[f"6: {LANES}-lane step"] = launches6
    fps4 = statistics.median(sps_runs)
    n_steps = TIMED_RUNS * TIMED_STEPS
    print(f"phase 6: {TIMED_RUNS} runs of {TIMED_STEPS} steps x {LANES} lanes at "
          f"{[round(x, 3) for x in sps_runs]} frames/s (median {fps4:.3f}); "
          f"launches {launches6}")
    want = {k.__name__: 0 for k in kernels}
    want.update(sorted_lookup=12 * n_steps, gather_conv=21 * n_steps)
    check(launches6 == want,
          f"expected 12 sorted_lookup + 21 gather_conv launches per step, got {launches6}")
    with torch.no_grad():
        feat = model4.frame_features(frame4)
        m1, m2 = model4.affinity_step(frame4["det_boxes"], frame4["det_boxes"], feat, feat)
    check(tuple(feat.shape) == (LANES,) + want_shape[1:] and bool(torch.isfinite(feat).all()),
          "4-lane descriptors are not finite")
    check_affinity(m1, m2, f"{LANES} lanes")
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
    n_probe, probe_recs = phase_probe()
    path_launches["8: probe run"] = {k.__name__: 0 for k in kernels}
    path_launches["8: probe run"]["block_extract"] = n_probe
    per_kernel["block_extract"] = dict(
        ms=sum(r["ms"] for r in probe_recs), plain_ms=sum(r["plain_ms"] for r in probe_recs),
        bound=sum(r["bound_ms"] for r in probe_recs), err=max(r["max_abs_err"] for r in probe_recs),
        by="operations" if 2 * sum(r["bound_ms"] for r in probe_recs
                                   if r["bound_by"] == "operations")
        >= sum(r["bound_ms"] for r in probe_recs) else "bytes")
    print(f"phase 8: {n_probe} launches in the probe run, every variant "
          f"== its plain version and its rerun; probe run {per_kernel['block_extract']['ms']:.4f}"
          f" ms against a bound of {per_kernel['block_extract']['bound']:.4f} ms")

    # 9. the fused 7-class step at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup9 = multiclass_setup(dev)
    print(f"set-up, 7 classes (class models on the host, stacked heads): "
          f"{time.perf_counter() - t0:.2f} s; classes {setup9[0].max_obj}")
    fps7, fps7_runs, path_launches["9: 7-class step"] = phase_multiclass(*setup9, kernels,
                                                                         n_frames)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 9: peak device memory {peak_gb:.3f} GiB ({smi})")
    del setup9

    # 10. small 3-class configuration: cuda against cpu, and car against a
    # single-class pipeline on cuda
    phase_small_multiclass("cuda", "cpu")
    print("phase 10: 3 classes cuda == cpu, and car == its single-class pipeline")

    # 11. the B=1 step without plans
    print("phase 11: the B=1 step without host plans (every index built on the card)")
    fps_nop, fps_nop_runs, path_launches["11: B=1 step without plans"], profiles = \
        phase_unplanned(model, frame, outs, kernels)

    # 12. step_chunk at B=1 and at 4 lanes
    path_launches["12: step_chunk"] = phase_chunk(model, frame, model4, frame4, kernels)

    # 13. the two-frame forward
    path_launches["13: two-frame forward"] = phase_forward(model2, frame2, kernels)

    # 14. device box ops
    phase_box_ops(dev)

    # 15. a split served by the CLIs
    path_launches["15: serving CLI"], gather_paths[SERVE_LABEL], serving = phase_serving(
        kernels, smi)
    print(f"phase 15: serving loop {serving['frames_per_s']:.3f} frames/s (f32) beside phase "
          f"11's step alone {fps_nop:.3f} frames/s (bf16 bench frame)")

    # 16. the official per-class eval flow
    (path_launches[f"16: eval CLI, {EVAL_LANES} lanes"], path_launches["16: eval CLI, parity"],
     gather_paths[EVAL_LABEL], eval_flow) = phase_eval(kernels, smi)

    # 17. training on the card
    launches17, gather17, training = phase_training(kernels, smi)
    path_launches.update(launches17)
    gather_paths.update(gather17)

    # 18. the offline chain, the oracle tracker and the chain's tree served
    path_launches["18: track_scene over the chain's tree"], gather18, chain = phase_chain(
        kernels, smi)
    gather_paths.update(gather18)

    # 19. the Waymo readers, the Waymo oracle and the renderers
    path_launches["19: track_scene --render"], waymo = phase_waymo(kernels, smi)

    # 20. the model zoo, the registry and the profiler
    path_launches[f"20: {ZOO_LABEL}"], gather_paths[ZOO_LABEL], zoo = phase_zoo(kernels, smi)

    # 21. the neck's conv kernel
    neck = phase_neck(smi)

    # 22. the pillar trunk served
    path_launches[f"22: {PILLAR_LABEL}"], pillars = phase_pillars(kernels, smi)

    src = {"rulebook_conv": ("shasta_tpu_torch/csrc/block_conv.cu",
                             "shasta_tpu/ops/pallas/block_conv.py:117", "B=1 frame with plans"),
           "keyed_conv": ("shasta_tpu_torch/csrc/window_conv.cu",
                          "shasta_tpu/ops/pallas/window_conv.py:719", "B=1 frame with plans"),
           "sorted_lookup": ("shasta_tpu_torch/csrc/lookup.cu",
                             "shasta_tpu/ops/pallas/window_conv.py:170", f"{LANES}-lane step"),
           "gather_conv": ("shasta_tpu_torch/csrc/gather_conv.cu",
                           "shasta_tpu/ops/pallas/window_conv.py:480", f"{LANES}-lane step")}
    out_kernels = []
    for name, rec in per_kernel.items():
        by_path = {p: n[name] for p, n in path_launches.items() if n[name]}
        entry = {"name": name, "route": "cuda", "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "max_abs_err": rec["err"], "ms": rec["ms"],
                 "plain_ms": rec["plain_ms"]}
        if name == "block_extract":
            entry.update(
                source="shasta_tpu_torch/csrc/block_extract.cu",
                replaces="tools/probe_block_conv.py:43", bound_ms=rec["bound"],
                bound_by=rec["by"], library_ms=None,
                per="one probe run: the sum over its 10 launches (s0, s1 x five variants), "
                    f"each the median of {PROBE_ITERS} CUDA-event-timed launches, f32; "
                    "library: none, no PyTorch call computes the block extraction",
                cases=[{k: r[k] for k in ("shape", "variant", "hits", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "share", "max_abs_err")}
                       for r in probe_recs])
            out_kernels.append(entry)
            continue
        bound_ms, bound_by = bound_of(rec)
        unit = src[name][2]
        entry.update(
            source=src[name][0], replaces=src[name][1], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=rec.get("library_ms"),
            per=(f"one {unit}'s launches (sum over its calls, each call's time the "
                 f"median of 10 CUDA-event-timed calls)"
                 + (f" in {rec['dtype']}" if "flops" in rec else "")
                 + ("; library: torch.searchsorted on the same flattened queries, "
                    "positions only (no perm gather, no hit test, one search per "
                    "triple centre)" if name == "sorted_lookup" else "")))
        if name in ("sorted_lookup", "gather_conv"):
            entry["paths"] = {}
            for label, recs in gather_paths.items():
                r = recs[name]
                b_ms, b_by = bound_of(r)
                entry["paths"][label] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                                             bound_by=b_by, library_ms=r["library_ms"],
                                             max_abs_err=r["err"])
                entry["paths"][label].update(
                    {k: r[k] for k in ("dtype", "bf16_ms", "before_ms") if k in r})
        out_kernels.append(entry)
    by_path = {p: n["dense_conv"] for p, n in path_launches.items() if n["dense_conv"]}
    out_kernels.append({
        "name": "dense_conv", "route": "cuda", "source": "shasta_tpu_torch/csrc/dense_conv.cu",
        "replaces": "none: XLA convs in the JAX package", "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "launches_a_pillar_frame": pillars["dense_conv_per_frame"],
        "per": "one neck call (the sum over its convs, 15 of the car neck, 20 of the pillar "
               "neck, each the median of 10 CUDA-event-timed launches), f32; library: "
               "F.conv2d / F.conv_transpose2d under cuDNN, TF32 off, without BN",
        **{key: {B: {k: r[k] for k in ("launches", "sum_ms", "sum_bound_ms", "sum_plain_ms",
                                        "sum_library_ms", "neck_ms", "run_ms", "max_abs_err")}
                 for B, r in neck[label].items()}
           for key, label in (("batches", "car"), ("pillar_batches", "pillars"))}})
    print(json.dumps({"frames_per_s": fps, "frames_per_s_runs": fps_runs,
                      "b1_no_plans_frames_per_s": fps_nop,
                      "b1_no_plans_frames_per_s_runs": fps_nop_runs,
                      "b1_profiles": profiles,
                      "lanes4_frames_per_s": fps4, "lanes4_frames_per_s_runs": sps_runs,
                      "classes7_frames_per_s": fps7, "classes7_frames_per_s_runs": fps7_runs,
                      "classes7_peak_device_gib": peak_gb, "serving": serving,
                      "eval_flow": eval_flow, "training": training, "chain": chain,
                      "waymo": waymo, "zoo": zoo, "neck": neck, "pillars": pillars,
                      "card": smi, "host": host,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": out_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
