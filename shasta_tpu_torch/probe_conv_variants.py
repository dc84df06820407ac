"""The designs keyed_conv's tensor-core launch was chosen against, timed on
the card at the B=1 step's shapes.

    python -m shasta_tpu_torch.probe_conv_variants [--reps 20]

Builds csrc/window_conv.cu three ways, from copies of csrc with one line
changed (under shasta_tpu_torch/_build/variants/, one nvcc each, in
parallel):
  as is      the kernel of the repo;
  rows 64    the staged core on 64-row tiles (gmma::TM = 64): B=1's 12k-row
             stage 3 then fills 188 blocks instead of 94 on the 132 SMs,
             but each block still loads all of W;
  per query  the staged core without keyed_conv's tile resolver: one full
             binary search per (row, tap), as the CUDA-core core does.
For each keyed conv of the bench frame (res2, down3, res3, extra; the
frame, plans and indices of profile_step.car_setup and b1_conv_cases) it
holds each build's bf16 result against keyed_conv_plain (atol/rtol 2e-2),
times it (timing.median_ms) and prints the per-frame sums and one JSON
line; it exits non-zero if a build fails or disagrees. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import sys

import torch

from .device import resolve_device
from .ops.kernels import build
from .ops.kernels.window_conv import keyed_conv_plain, keyed_rows
from .profile_step import b1_conv_cases, car_setup
from .timing import median_ms

VARIANTS = {
    "as is": None,
    "rows 64": ("gather_mma.cuh", "constexpr int TM = 128;", "constexpr int TM = 64;"),
    "per query": ("window_conv.cu", "static constexpr bool kResolvesTile = true;",
                  "static constexpr bool kResolvesTile = false;"),
}


def build_variant(name: str, edit) -> ctypes.CDLL:
    """window_conv.cu built from a copy of csrc with `edit` applied."""
    lib = build.build_variant("window_conv", name.replace(" ", "_"), edit)
    lib.keyed_conv_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.keyed_conv_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    with cf.ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS, VARIANTS.values())))
    cfg, batch, plans, _, _ = car_setup(dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cpu").manual_seed(0)
    per_frame = dict.fromkeys(VARIANTS, 0.0)
    rows, ok = [], True
    for kernel, case, n, V, cin, co, idx in b1_conv_cases(cfg, batch, plans, dev):
        if kernel != "keyed_conv":
            continue
        (M, K) = idx[-1].shape
        f = torch.randn(V, cin, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(K, cin, co, generator=g) / (K * cin) ** 0.5).to(dev, torch.bfloat16)
        want = keyed_conv_plain(*idx, f, w)
        out = torch.empty((M, co), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in (*idx, f, w, out)]
        row = {"case": case, "calls": n, "hits_per_row": int((keyed_rows(*idx) < V).sum()) / M}
        for name, lib in libs.items():
            def call():
                err = lib.keyed_conv_launch(*ptrs, V, M, K, cin, co, 1, stream)
                if err:
                    raise RuntimeError(f"{name} {case}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            bad = float(((out - want).abs() - 2e-2 * want.abs()).max())
            ok &= bad <= 2e-2
            row[name] = median_ms(call, reps=args.reps)
            per_frame[name] += n * row[name]
        rows.append(row)
        print(f"  {case:20s} x{n}  {row['hits_per_row']:.3f} hits/row  " + "  ".join(
            f"{name} {row[name]:.4f} ms" for name in VARIANTS), flush=True)
    print("per frame: " + "  ".join(f"{k} {v:.4f} ms" for k, v in per_frame.items()))
    print(json.dumps({"per_frame_ms": per_frame, "convs": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
