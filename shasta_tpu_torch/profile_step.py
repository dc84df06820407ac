"""Where the time of one serving step goes, on the card.

    python -m shasta_tpu_torch.profile_step [--frames 10]

Sets up the bench-scale car frame (`car_setup`, shared with chip_smoke.py:
V=120k voxels, max_obj 90, 60 real dets, caps 50k/25k/12k/12k, bf16
trunk, random weights from a numpy seed), warms up, then profiles
`--frames` step_frame calls with torch.profiler and prints: host wall
time per frame, device busy time per frame and its share of the wall,
the step's record_function spans (host time and the device time
of their kernels' range), and the kernels by device time.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import time

import torch

from .convert import load_jax_variables, random_jax_variables
from .data.synthetic import make_batch
from .device import resolve_device
from .infer import FRAME_KEYS, ScenePipeline
from .models import ShastaConfig, ShastaModel
from .plans import frame_plans

CAR = dict(max_obj=90, cap_conv2=50000, cap_conv3=25000, cap_conv4=12000,
           cap_extra=12000)
N_DETS = 60


def car_setup(dev, dtype=torch.bfloat16, seed: int = 0):
    """(cfg, numpy batch, plans on dev, model, frame on dev) at the bench
    shape of bench.py:39-41,75-97,121-148."""
    cfg = ShastaConfig(**CAR, dtype=dtype)
    batch = make_batch(cfg, num_voxels_cap=120000, n_dets=N_DETS, seed=seed)
    plans = {k: torch.from_numpy(v).to(dev) for k, v in frame_plans(
        batch["coordinates"][0], batch["voxels_valid"][0], cfg).items()}
    model = ShastaModel(cfg, device=dev)
    load_jax_variables(model, random_jax_variables(model, seed=seed))
    frame = {k: torch.as_tensor(batch[k]).to(dev) for k in FRAME_KEYS}
    frame.update({"plan_" + k: v for k, v in plans.items()})
    return cfg, batch, plans, model, frame


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device("cuda")
    _, _, _, model, frame = car_setup(dev)
    pipe = ScenePipeline(model, cls_id=2)
    for _ in range(3):
        pipe.step_frame(frame, N_DETS, 0.5).tid
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            out = pipe.step_frame(frame, N_DETS, 0.5)
        out.tid
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.frames * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events only: CPU ops also carry the time of the kernels
    # they launch, and record_function spans the range of theirs
    kernels = [e for e in events if e.device_type == cuda and not e.is_user_annotation
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.frames
    print(f"per frame: host wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% of the wall; profiler on)")
    print("spans (ms per frame: host, device range):")
    device_span = {e.key: e.device_time_total for e in events
                   if e.is_user_annotation and e.device_type == cuda}
    for e in events:
        if e.key.startswith("step.") and e.device_type != cuda:
            print(f"  {e.key:18s} {e.cpu_time_total / 1e3 / args.frames:9.3f} "
                  f"{device_span.get(e.key, 0) / 1e3 / args.frames:9.3f}")
    print("kernels by device time (ms per frame, launches per frame):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3 / args.frames:8.4f}  "
              f"{e.count / args.frames:6.1f}  {e.key[:90]}")
    n_launch = sum(e.count for e in kernels) / args.frames
    print(f"device kernels and copies per frame: {n_launch:.0f}")

if __name__ == "__main__":
    main()
