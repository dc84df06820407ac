"""The f32 route of the sparse convs (3xTF32 in csrc/gather_mma.cuh) beside
the design it was chosen against and beside timing-only builds that drop
part of its arithmetic, on the card, at a served frame's shapes.

    python -m shasta_tpu_torch.probe_f32_route [--reps 10]

Builds csrc/gather_conv.cu five ways, from copies of csrc with one edit to
gather_mma.cuh (under shasta_tpu_torch/_build/variants/, one nvcc each, in
parallel):
  as is      the kernel of the repo;
  KC 32      the staged core's f32 stages at 32 input channels, not 64:
             half the bytes a stage, twice the stages;
  NJ 2       the staged core's f32 items at Co = 128 of 32 columns, as
             bf16's, not 64: twice the items, each A fragment split by
             twice the warps;
  one pass   timing only: hi*hi alone, without the lo*hi and hi*lo MMAs;
  no split   timing only: x as hi and 0 as lo, without the cvt, sub, cvt
             that split each operand (the three MMAs stay).
The two timing-only builds are not f32-accurate: their results are not
checked; what they save is what those parts of the arithmetic cost. The
frame is a served one: configs/nusc/car.py's split of
data.synthetic.write_track_split (seed 15, its second frame, written under
work_dirs/probe_f32_route) through the unplanned f32 trunk of a model with
seeded weights; each of its 21 gather_conv calls is timed on each build
(timing.median_ms), the checked builds held against gather_conv_plain
within 1e-4 x max(1, |out|) and a rerun (the same bits). Prints per conv
and per frame, and one JSON line; exits non-zero if a build fails or a
checked build disagrees. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys

import torch

from .device import resolve_device, upload
from .infer import FRAME_KEYS
from .ops.kernels import build
from .ops.kernels.gather_conv import build_conv, gather_conv_plain
from .probe_b1_routes import recorded
from .timing import median_ms

_OP = ("struct Op<float> {            // 3xTF32 on mma.sync m16n8k8\n"
       "  static constexpr int KSTEP = 8, VEC = 4, KC = 64,")
VARIANTS = {
    "as is": None,
    "KC 32": ("gather_mma.cuh", _OP, _OP.replace("KC = 64,", "KC = 32,")),
    "NJ 2": ("gather_mma.cuh", "std::is_same_v<T, float> && CO >= 128 ? 4 : ", ""),
    "one pass": ("gather_mma.cuh",
                 "  if (pass == 0) mma_tf32(d, a.lo, b0.hi, b1.hi);\n"
                 "  else if (pass == 1) mma_tf32(d, a.hi, b0.lo, b1.lo);\n",
                 "  if (pass < 2) return;\n"),
    "no split": ("gather_mma.cuh",
                 '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(s.hi) : "f"(x));\n'
                 '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(s.lo) : "f"(x - __uint_as_float(s.hi)));\n',
                 "  s.hi = __float_as_uint(x);\n  s.lo = 0u;\n"),
}
TIMING_ONLY = ("one pass", "no split")
CONVS = ("conv_input", "res0", "down1", "res1", "down2", "res2", "down3", "res3", "extra")


def build_variant(name: str, edit):
    """gather_conv(f, idx, w) from csrc/gather_conv.cu built with `edit`."""
    return build_conv(build.build_variant("gather_conv", "f32_" + name.replace(" ", "_"), edit))


def served_frame_convs(dev):
    """The 21 gather_conv calls (feats, table, weight) of a served frame's
    f32 trunk, grouped by conv (CONVS order)."""
    from .data.synthetic import write_split_config, write_track_split
    from .tools.common import build_dataset, build_model
    from .utils import Config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    car = os.path.join(repo, "configs", "nusc", "car.py")
    root = os.path.join(repo, "work_dirs", "probe_f32_route")
    sp = write_track_split(os.path.join(root, "data"), Config.fromfile(car), n_scenes=1,
                           n_frames=2, seed=15)
    cfg = Config.fromfile(write_split_config(car, sp["val"], os.path.join(root, "car.py")))
    sample = build_dataset(cfg, "val")[1]
    frame = {k: upload(sample[k][None], dev) for k in FRAME_KEYS}
    with recorded("gather_conv") as calls, torch.no_grad():
        build_model(cfg, dev, seed=15).bev_single(frame)
    groups = {}
    for f, idx, w in calls["gather_conv"]:
        groups.setdefault((f.shape, idx.data_ptr(), w.shape), []).append((f, idx, w))
    if len(groups) != len(CONVS):
        raise RuntimeError(f"{len(groups)} conv groups in the trunk")
    return dict(zip(CONVS, groups.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    with cf.ThreadPoolExecutor(len(VARIANTS)) as ex:
        builds = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS, VARIANTS.values())))
    per_frame = dict.fromkeys(VARIANTS, 0.0)
    rows, ok = [], True
    for conv, calls in served_frame_convs(dev).items():
        f, idx, w = calls[0]
        want = gather_conv_plain(f, idx, w)
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        row = {"conv": conv, "calls": len(calls), "cin": f.shape[1], "co": w.shape[2],
               "hits_per_row": int(((idx >= 0) & (idx < f.shape[0])).sum()) / idx.shape[0]}
        for name, kern in builds.items():
            got = kern(f, idx, w)
            torch.cuda.synchronize()
            if name not in TIMING_ONLY:
                ok &= float((got - want).abs().max()) <= tol and torch.equal(kern(f, idx, w), got)
            row[name] = median_ms(lambda: kern(f, idx, w), reps=args.reps)
            per_frame[name] += len(calls) * row[name]
        rows.append(row)
        print(f"  {conv:10s} {row['cin']:3d}->{row['co']:3d} x{len(calls)}  "
              f"{row['hits_per_row']:.3f} hits/row  " + "  ".join(
                  f"{name} {row[name]:.4f} ms" for name in VARIANTS), flush=True)
    print("per frame: " + "  ".join(f"{k} {v:.4f} ms" for k, v in per_frame.items()))
    print(json.dumps({"per_frame_ms": per_frame, "convs": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
