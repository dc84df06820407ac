"""Where the time of one serving step goes, on the card.

    python -m shasta_tpu_torch.profile_step [--frames 10] [--lanes 1] [--no-plans]
                                            [--classes 0]

Sets up the bench-scale car frame (`car_setup`, shared with chip_smoke.py:
V=120k voxels per lane, max_obj 90, 60 real dets, caps 50k/25k/12k/12k
per lane, bf16 trunk, random weights from a numpy seed), warms up, then
profiles `--frames` steps with torch.profiler: ScenePipeline.step_frame
with host plans at --lanes 1 (without them, every index built on the
card, with --no-plans), BatchedScenePipeline.step_frames over
--lanes scene lanes otherwise (bench.py --lanes N), and with --classes K
the fused multi-class step (MultiClassScenePipeline, `multiclass_setup`)
over the first K classes of NUSC_MAX_OBJ. Prints, per step:
host wall time, device busy time and its share of the wall, the step's
record_function spans (host time and the device time of their kernels'
range), the kernels by device time, and the host-device synchronisations
inside one more step (torch.cuda's sync debug mode: a call that makes the
host wait for the card, such as a copy from pageable memory or an
.item()). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

from .convert import class_models_from_jax, load_jax_variables, random_jax_variables
from .data.synthetic import make_batch
from .device import resolve_device
from .infer import FRAME_KEYS, BatchedScenePipeline, MultiClassScenePipeline, ScenePipeline
from .models import ShastaConfig, ShastaModel
from .ops import sparse as sp
from .plans import frame_plans

CAR = dict(max_obj=90, cap_conv2=50000, cap_conv3=25000, cap_conv4=12000,
           cap_extra=12000)
N_DETS = 60
# per-class max_obj of configs/nusc/*.py (car.py:6, ped.py:6, ..., bus.py:6)
NUSC_MAX_OBJ = {"car": 90, "pedestrian": 90, "truck": 60, "trailer": 60, "bus": 20,
                "motorcycle": 50, "bicycle": 50}


def bench_frame(cfg, dev, seed: int = 0, lanes: int = 1):
    """(numpy batch, plans on dev or None, frame on dev) at the bench shape
    of bench.py:39-41,75-97,121-148: at lanes == 1 one frame with its host
    plans; at lanes > 1 the frames of seeds seed..seed+B-1 concatenated (B
    lanes, no plans)."""
    parts = [make_batch(cfg, num_voxels_cap=120000, n_dets=N_DETS, seed=seed + s)
             for s in range(lanes)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    frame = {k: torch.as_tensor(batch[k]).to(dev) for k in FRAME_KEYS}
    plans = None
    if lanes == 1:
        plans = {k: torch.from_numpy(v).to(dev) for k, v in frame_plans(
            batch["coordinates"][0], batch["voxels_valid"][0], cfg).items()}
        frame.update({"plan_" + k: v for k, v in plans.items()})
    return batch, plans, frame


def b1_conv_cases(cfg, frame, plans, dev):
    """The B=1 step's 21 convs as (kernel, case, launches per frame, V, Cin,
    Co, index tensors): each kernel's indices at the shapes the bench frame
    (numpy `frame`, its host `plans` on dev) gives it."""
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


def car_setup(dev, dtype=torch.bfloat16, seed: int = 0, lanes: int = 1):
    """(cfg, numpy batch, plans on dev or None, model, frame on dev): the
    bench frame of `bench_frame` and the car model, the stage caps times
    the lanes."""
    cfg = ShastaConfig(**{k: v * (lanes if k.startswith("cap_") else 1)
                          for k, v in CAR.items()}, dtype=dtype)
    batch, plans, frame = bench_frame(cfg, dev, seed, lanes)
    model = ShastaModel(cfg, device=dev)
    load_jax_variables(model, random_jax_variables(model, seed=seed))
    return cfg, batch, plans, model, frame


def multiclass_setup(dev, classes: int = 7):
    """(pipeline, frame on dev with its host plans, class_boxes) of the fused
    multi-class step at full width over the first `classes` entries of
    NUSC_MAX_OBJ: the bf16 car trunk and frame of `car_setup` (seed 0), each
    class's max_obj,
    min(N_DETS, max_obj) real dets per class at rest (velocity 0: on a
    repeated frame each det sits on its own track, so its id holds; with
    the synthetic N(0, 1) velocities, dets a metre apart trade tracks),
    random trees from numpy seeds 1.. through
    class_models_from_jax (built on the host; car's trunk shared)."""
    cfgs = {n: ShastaConfig(**dict(CAR, max_obj=m), dtype=torch.bfloat16)
            for n, m in list(NUSC_MAX_OBJ.items())[:classes]}
    _, _, frame = bench_frame(cfgs["car"], dev)
    trees, class_boxes = {}, {}
    for i, (n, cfg) in enumerate(cfgs.items()):
        trees[n] = random_jax_variables(ShastaModel(cfg, device="cpu"), seed=1 + i)
        n_dets = min(N_DETS, cfg.max_obj)
        b = make_batch(cfg, num_voxels_cap=16, n_dets=n_dets, seed=1 + i)["det_boxes"]
        b[..., 7:9] = 0.0
        class_boxes[n] = (b, n_dets)
    pipe = MultiClassScenePipeline(class_models_from_jax(cfgs, trees), trunk_key="car",
                                   device=dev)
    return pipe, frame, class_boxes


def without_plans(frame: dict) -> dict:
    """The frame without its plan_* arrays (the B=1 unplanned step)."""
    return {k: v for k, v in frame.items() if not k.startswith("plan_")}


def step_fn(model, frame, lanes: int):
    """A fresh pipeline's step on `frame` at N_DETS real dets, lag 0.5:
    ScenePipeline at one lane, BatchedScenePipeline (reset on its first
    step) above."""
    if lanes == 1:
        pipe = ScenePipeline(model, cls_id=2)
        return lambda: pipe.step_frame(frame, N_DETS, 0.5)
    pipe = BatchedScenePipeline(model, cls_id=2, batch=lanes)
    first = [True]

    def step():
        out = pipe.step_frames(frame, [N_DETS] * lanes, [first[0]] * lanes,
                               [0.5] * lanes)
        first[0] = False
        return out
    return step


def sync_calls(step) -> list[str]:
    """Messages of the host-device synchronisations inside one `step()`,
    as torch.cuda's sync debug mode reports them (a prototype: it may miss
    some, never invents one)."""
    torch.cuda.set_sync_debug_mode("warn")  # warns once that it is a prototype
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out.tid
    return [str(w.message) for w in caught]


def profile_steps(step, frames: int) -> dict:
    """`frames` calls of `step()` under torch.profiler after the caller's
    warm-up -> {wall_ms, busy_ms per step (profiler on), spans {name: (host
    ms, device-range ms) per step}, kernels [(device ms, launches per step,
    name)] by device time, launches: device kernels and copies per step}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            out = step()
        out.tid
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / frames * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events only: CPU ops also carry the time of the kernels
    # they launch, and record_function spans the range of theirs
    kernels = [e for e in events if e.device_type == cuda and not e.is_user_annotation
               and e.self_device_time_total > 0]
    device_span = {e.key: e.device_time_total for e in events
                   if e.is_user_annotation and e.device_type == cuda}
    return dict(
        wall_ms=wall,
        busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3 / frames,
        spans={e.key: (e.cpu_time_total / 1e3 / frames,
                       device_span.get(e.key, 0) / 1e3 / frames)
               for e in events if e.key.startswith("step.") and e.device_type != cuda},
        kernels=[(e.self_device_time_total / 1e3 / frames, e.count / frames, e.key)
                 for e in sorted(kernels, key=lambda e: -e.self_device_time_total)],
        launches=sum(e.count for e in kernels) / frames)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--no-plans", action="store_true",
                    help="at one lane, step frames without host plans (every index "
                         "built on the card)")
    ap.add_argument("--classes", type=int, default=0,
                    help="profile the fused multi-class step over this many classes")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    if args.classes:
        pipe, frame, class_boxes = multiclass_setup(dev, args.classes)

        def step():
            return pipe.dispatch_frame(frame, class_boxes, 0.5)[0]
    else:
        _, _, _, model, frame = car_setup(dev, lanes=args.lanes)
        if args.no_plans:
            frame = without_plans(frame)
        step = step_fn(model, frame, args.lanes)
    for _ in range(3):
        step().tid
    p = profile_steps(step, args.frames)
    print(f"per step: host wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms "
          f"({100 * p['busy_ms'] / p['wall_ms']:.1f}% of the wall; profiler on)")
    print("spans (ms per step: host, device range):")
    for key, (host, device) in p["spans"].items():
        print(f"  {key:18s} {host:9.3f} {device:9.3f}")
    print("kernels by device time (ms per step, launches per step):")
    for ms, n, key in p["kernels"][:25]:
        print(f"  {ms:8.4f}  {n:6.1f}  {key[:90]}")
    print(f"device kernels and copies per step: {p['launches']:.0f}")
    syncs = sync_calls(step)
    print(f"host-device synchronisations in one step: {len(syncs)}")
    for msg in sorted(set(syncs)):
        print(f"  {syncs.count(msg)}x {msg[:100]}")


if __name__ == "__main__":
    main()
