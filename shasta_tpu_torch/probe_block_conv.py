"""The block-extraction probe on the card: the port's entry point for the
`block_extract` kernel (the TPU probe is tools/probe_block_conv.py).

    python -m shasta_tpu_torch.probe_block_conv [--iters N] [--device cpu]
                                                [--rows-study]

For both probe shapes (s0: V=119808, C=16, H=4, NBWL=128; s1: V=49920,
C=32, H=2, NBWL=256; tile 128; tools/probe_block_conv.py:151-153) it makes
the inputs from numpy seed 0, runs each of the five variants once through
`block_extract` (10 launches), then holds each result against the plain
version (f32, atol/rtol 1e-5) and against a second launch (the same bits),
and times the kernel and the plain version (timing.median_ms: the median
of N launches, each between CUDA events) beside the bound (`work`,
`bound`). --rows-study also times each variant with the block size the
kernel does not take (`rows_study`). It prints one line per (shape,
variant), then one JSON line, and exits non-zero if a variant disagrees.
It runs on the card unless --device cpu is given; on the CPU the wrapper
computes the plain version and the times are host times.

Inputs that hit. The TPU probe draws its guard rows at random and sets
sg2 = sg1 + 1, so a row's window test `sg1 < a <= sg2` holds only where a
random guard equals a - 1: every output is zero, and a comparison on that
data proves nothing. Here (recipe "hit") the key table holds V distinct
keys drawn from [0, 2V), so about half of a key's dx neighbours are keys
too; block b covers keys[b*H .. b*H + H - 1], its guards are
sg1 = keys[b*H] - 1 and sg2 = keys[b*H + H - 1], and k2q holds the byte
quarters of pair-block b's 2H keys. Recipe "dup" widens each window to the
pair block (sg2 = keys[b*H + 2H - 1]), so neighbouring windows overlap and
rows hit two of them; recipe "probe" is the TPU probe's own data.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .device import resolve_device
from .ops.kernels.block_extract import F, GB, VARIANTS, block_extract, block_extract_plain
from .timing import HBM_BYTES_PER_S, median_ms, ops_ms

# (name, V, C, H, NBWL, tile): tools/probe_block_conv.py:151-153
SHAPES = (("s0", 119808, 16, 4, 128, 128), ("s1", 49920, 32, 2, 256, 128))
ATOL = RTOL = 1e-5
INT32_MAX = np.iinfo(np.int32).max


def probe_inputs(V: int, C: int, H: int, NBWL: int, tile: int, seed: int = 0,
                 recipe: str = "hit") -> dict:
    """The kernel's arguments as numpy arrays (see the module doc for the
    recipes), shaped as tools/probe_block_conv.py:155-181 shapes them."""
    rng = np.random.default_rng(seed)
    K, G = 27, 9
    NBr = max(1, -(-(-(-V // H)) // GB))
    NBP = (NBr - 1) * GB + NBWL
    Mp = -(-V // tile) * tile
    T = Mp // tile
    span = 2**26 if recipe == "probe" else 2 * V
    keys = np.sort(rng.choice(span, size=V, replace=False)).astype(np.int32)
    ramp = (np.arange(Mp) * (V / Mp)).astype(np.int64)
    q = np.zeros((Mp, K), np.int32)
    for g in range(G):
        c = keys[np.minimum(ramp + g, V - 1)]
        q[:, 3 * g:3 * g + 3] = np.stack([c - 1, c, c + 1], 1)
    blk = (ramp[::tile] // (H * GB)).astype(np.int32)
    bases = np.repeat(np.clip(blk - 1, 0, NBr - 1)[:, None], G, 1).astype(np.int32)
    w = (rng.normal(size=(G, 3, F, 3 * C)) / np.sqrt(F)).astype(np.float32)
    if recipe == "probe":
        sg1 = np.sort(rng.integers(0, 2**26, size=(NBr, NBWL)), 1).astype(np.int32)
        sg2 = sg1 + 1
        k2q = rng.integers(0, 255, size=(NBP, 8 * H)).astype(np.float32)
    else:
        # keys past V read as INT32_MAX: their windows never open
        kp = np.concatenate([keys, np.full(NBP * H + 2 * H, INT32_MAX, np.int32)])
        b = np.arange(NBr)[:, None] * GB + np.arange(NBWL)[None]
        sg1 = np.where(b * H < V, kp[b * H].astype(np.int64) - 1, INT32_MAX).astype(np.int32)
        sg2 = kp[b * H + (2 * H if recipe == "dup" else H) - 1]
        pair = kp[np.arange(NBP)[:, None] * H + np.arange(2 * H)[None]]  # (NBP, 2H)
        k2q = np.concatenate([(pair >> (8 * c)) & 255 for c in range(4)], 1).astype(np.float32)
    f2 = rng.normal(size=(NBP, F)).astype(np.float32)
    return dict(q=q, bases=bases, sg1=sg1, sg2=sg2, k2q=k2q, f2=f2, w=w)


def work(variant: str, args: dict, H: int, C: int, hits: int) -> dict:
    """What the function needs for these inputs: `bytes`, each input read
    once and the output written once (of q, only column 3g+1 where the
    variant reads no other: ohonly, extract); `flops`, the weight product's
    (per (row, group) 2*128*C for extract, 2*3C*C for the others); and the
    lane instructions besides, per (row, group) unless said: `int32`, the
    2*NBWL guard compares, the 3 sign tests of q (nokeys) or the 3*8H
    key-quarter compares (noselect, full); `f32`, the adds per hit of the
    afeat lanes the variant reads (extract 128, noselect C, the others 2H*C)
    and of the 8H key lanes (noselect, full), then nokeys' 2H*C adds of the
    blocks and 3C selects, noselect's 3C products, full's 3*2H*C selects;
    ohonly counts its hits and adds the count to C columns."""
    Mp, K = args["q"].shape
    G = K // 3
    NBr, NBWL = args["sg1"].shape
    NBP = args["f2"].shape[0]
    pairs = Mp * G
    keys = variant in ("noselect", "full")
    q_cols = G if variant in ("ohonly", "extract") else K
    nbytes = 4 * (Mp * q_cols + args["bases"].numel() + 2 * NBr * NBWL + Mp * C)
    int32 = pairs * 2 * NBWL
    if variant == "ohonly":
        return dict(bytes=float(nbytes), flops=0.0, f32=float(hits + pairs * C),
                    int32=float(int32))
    nbytes += 4 * NBP * F + (4 * NBP * 8 * H if keys else 0)
    if variant == "extract":
        return dict(bytes=float(nbytes + 4 * G * F * C), flops=float(pairs * 2 * F * C),
                    f32=float(hits * F), int32=float(int32))
    lanes = {"nokeys": 2 * H * C, "noselect": C, "full": 2 * H * C}[variant]
    f32 = hits * (lanes + (8 * H if keys else 0)) + pairs * {
        "nokeys": 2 * H * C + 3 * C, "noselect": 3 * C, "full": 3 * 2 * H * C}[variant]
    int32 += pairs * 3 * (8 * H if keys else 1)
    return dict(bytes=float(nbytes + 4 * G * 3 * C * C), flops=float(pairs * 2 * 3 * C * C),
                f32=float(f32), int32=float(int32))


def bound(need: dict) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for `work`'s counts on the H100."""
    t_bytes = need["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(need["flops"], need["f32"], need["int32"])
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cases(dev) -> list[dict]:
    """Both probe shapes' hitting inputs (seed 0) on `dev`, with their hit
    counts."""
    out = []
    for name, V, C, H, NBWL, tile in SHAPES:
        args = {k: torch.from_numpy(v).to(dev)
                for k, v in probe_inputs(V, C, H, NBWL, tile).items()}
        oh = block_extract_plain(**args, H=H, C=C, tile=tile, variant="ohonly")
        out.append(dict(name=name, V=V, C=C, H=H, NBWL=NBWL, tile=tile, args=args,
                        hits=int(oh[:, 0].sum())))
    return out


def drive(shape_cases: list[dict]) -> dict:
    """The probe's run: each variant once per shape through block_extract
    (one launch each on the card). Returns {(shape, variant): output}."""
    return {(c["name"], v): block_extract(**c["args"], H=c["H"], C=c["C"],
                                          tile=c["tile"], variant=v)
            for c in shape_cases for v in VARIANTS}


def measure(shape_cases: list[dict], outs: dict, iters: int) -> list[dict]:
    """Each output of `drive` against the plain version and against a second
    launch (the same bits on the card), and the times of the kernel and of
    the plain version beside the bound; one record per (shape, variant)."""
    recs = []
    for c in shape_cases:
        kw = dict(H=c["H"], C=c["C"], tile=c["tile"])
        on_card = c["args"]["q"].is_cuda
        for v in VARIANTS:
            got = outs[(c["name"], v)]
            want = block_extract_plain(**c["args"], **kw, variant=v)
            again = block_extract(**c["args"], **kw, variant=v)
            if got.is_cuda:
                torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, atol=ATOL, rtol=RTOL))
            need = work(v, c["args"], c["H"], c["C"], c["hits"])
            bound_ms, bound_by = bound(need)
            ms = median_ms(lambda: block_extract(**c["args"], **kw, variant=v), iters, on_card)
            recs.append(dict(
                shape=c["name"], variant=v, V=c["V"], C=c["C"], H=c["H"],
                NBWL=c["NBWL"], hits=c["hits"], nonzero_rows=int((want != 0).any(1).sum()),
                max_abs_err=err, ok=ok, same_bits=bool(torch.equal(got, again)), ms=ms,
                plain_ms=median_ms(lambda: block_extract_plain(**c["args"], **kw, variant=v),
                                   max(3, iters // 4), on_card),
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms, **need))
    return recs


def negative_bases(shape_cases: list[dict]) -> list[dict]:
    """Bases below 0, as interpret mode reads them (block_extract_plain's
    `window_start`): per shape, variant and r in (-1, -2, -NBr), the first
    and the last tile take base r; block_extract against the plain version
    at atol/rtol 1e-5. One record per case: shape, variant, r, max_abs_err,
    ok, nonzero_rows."""
    recs = []
    for c in shape_cases:
        kw = dict(H=c["H"], C=c["C"], tile=c["tile"])
        NBr = c["args"]["sg1"].shape[0]
        for r in (-1, -2, -NBr):
            args = dict(c["args"], bases=c["args"]["bases"].clone())
            args["bases"][[0, -1]] = r
            for v in VARIANTS:
                got = block_extract(**args, **kw, variant=v)
                want = block_extract_plain(**args, **kw, variant=v)
                recs.append(dict(shape=c["name"], variant=v, r=r,
                                 max_abs_err=float((got - want).abs().max()),
                                 ok=bool(torch.allclose(got, want, atol=ATOL, rtol=RTOL)),
                                 nonzero_rows=int((want != 0).any(1).sum())))
    return recs


ROWS_LINE = "return variant == OHONLY ? 128 : 64;"  # csrc/block_extract.cu rows_of


def rows_study(shape_cases: list[dict], iters: int) -> list[dict]:
    """Each (shape, variant) with the kernel's blocks of rows_of(variant)
    rows and with the other size (64 <-> 128): the second from a copy of
    csrc/block_extract.cu with rows_of's line swapped, built under
    _build/variants/. Each held against the plain version, and timed. Needs
    the card; the variant build's launches are not counted."""
    import ctypes

    from .ops.kernels import build
    from .ops.kernels.block_conv import _ptr

    lib = build.build_variant("block_extract", "block_extract_rows_swapped", (
        "block_extract.cu", ROWS_LINE, "return variant == OHONLY ? 64 : 128;"))
    fn = lib.block_extract_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    recs = []
    for c in shape_cases:
        kw = dict(H=c["H"], C=c["C"], tile=c["tile"])
        a = c["args"]
        NBr, NBWL = a["sg1"].shape
        for v in VARIANTS:
            want = block_extract_plain(**a, **kw, variant=v)
            out = torch.empty_like(want)
            ins = [a[k] for k in ("q", "bases", "sg1", "sg2", "k2q", "f2", "w")]
            ptrs = [_ptr(t) for t in (*ins, out)]
            dims = (a["q"].shape[0], c["tile"], a["q"].shape[1] // 3, NBr, a["f2"].shape[0],
                    NBWL, c["H"], c["C"], a["w"].shape[3], VARIANTS.index(v))

            def swapped():
                err = fn(*ptrs, *dims, stream)
                if err:
                    raise RuntimeError(f"block_extract rows swapped {v}: CUDA error {err}")

            shipped = block_extract(**a, **kw, variant=v)
            swapped()
            torch.cuda.synchronize()
            rows = 128 if v == "ohonly" else 64
            recs.append(dict(
                shape=c["name"], variant=v, rows=rows, other_rows=192 - rows,
                ok=bool(torch.allclose(shipped, want, atol=ATOL, rtol=RTOL)
                        and torch.allclose(out, want, atol=ATOL, rtol=RTOL)),
                ms=median_ms(lambda: block_extract(**a, **kw, variant=v), iters),
                other_ms=median_ms(swapped, iters)))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rows-study", action="store_true",
                    help="also time each variant with the other block size (card only)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape_cases = cases(dev)
    recs = measure(shape_cases, drive(shape_cases), args.iters)
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu (host times)"
    for r in recs:
        print(f"{r['shape']} {r['variant']:9s} hits {r['hits']:8d}  kernel {r['ms']:.4f} ms"
              f"  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['share']:.1f}% of it)  max abs err "
              f"{r['max_abs_err']:.3g}  {'ok' if r['ok'] else 'DIFFERS'}"
              f"{'' if r['same_bits'] else '  RERUN DIFFERS'}")
    print(f"probe run: kernel {sum(r['ms'] for r in recs):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in recs):.4f} ms")
    study = rows_study(shape_cases, args.iters) if args.rows_study else []
    for r in study:
        print(f"{r['shape']} {r['variant']:9s} rows {r['rows']} (the kernel's) {r['ms']:.4f} ms,"
              f" rows {r['other_rows']} {r['other_ms']:.4f} ms{'' if r['ok'] else '  DIFFERS'}")
    print(json.dumps({"device": where, "iters": args.iters, "probe": recs, "rows": study}))
    ok = all(r["ok"] and r["same_bits"] for r in recs)
    return 0 if ok and all(r["ok"] for r in study) else 1


if __name__ == "__main__":
    raise SystemExit(main())
