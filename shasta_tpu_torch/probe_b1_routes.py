"""The B=1 step without host plans, by two trunk routes, on the card.

    python -m shasta_tpu_torch.probe_b1_routes [--frames 20] [--runs 3]

Without host plans the B=1 trunk finds each conv's neighbours on the
device, one of two ways:
- gather, the port's route (SparseBackbone._built): sorted_lookup builds
  every (M, K) gather table (12 launches per frame) and the 21 convs run
  gather_conv;
- keyed, the counterpart of the JAX B=1 `fused` route
  (shasta_tpu/models/backbone.py:217-226): every conv's input rows are
  found by key inside keyed_conv (21 launches), the strided output sets
  come from `strided_output_set` (4 identity-mode sorted_lookup launches),
  and no gather table is built. `keyed_trunk` below is that route.
On the bench frame (`car_setup`) the probe prints each stage's output set
against its cap (`stage_sets`), holds each route's BEV map against the
planned route's, holds every keyed_conv call of the keyed route against
its plain version (bf16, atol/rtol 2e-2) and times it, then alternates
the two routes over
`--runs` runs of `--frames` ScenePipeline.step_frame calls (frames/s) and
profiles each route (host wall and device busy per step). Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .device import resolve_device
from .infer import ScenePipeline
from .models.backbone import SparseBackbone, _blocks
from .ops import sparse as sp
from .ops.kernels.lookup import SENTINEL


@contextlib.contextmanager
def recorded(*names):
    """Record the arguments of every call of the named functions of
    ops/sparse.py (the trunk calls its kernels and index builders by these
    module-level names): yields {name: [positional args, ...]}, in call order."""
    calls = {n: [] for n in names}
    real = {n: getattr(sp, n) for n in names}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append(args)
            return real[name](*args, **kwargs)
        return call

    try:
        for n in names:
            setattr(sp, n, recorder(n))
        yield calls
    finally:
        for n, fn in real.items():
            setattr(sp, n, fn)


def _keyed_plan(x: sp.SparseTensor, stage, cap: int, table) -> sp.StridedPlan:
    coords, valid, shape = sp.strided_output_set(x, *stage.geometry(), cap)
    q = sp.strided_queries(coords, valid, x.shape, *stage.geometry())
    return sp.StridedPlan(coords, valid, sp.KeyedIndex(*table, q), shape)


def keyed_trunk(bb: SparseBackbone, st: sp.SparseTensor) -> sp.SparseTensor:
    """The keyed route: `_built` with every index a KeyedIndex (the
    stage-0 table sorted, later ones presorted), all 21 convs on keyed_conv."""
    dt = bb.dtype
    table = sp.key_table(st)
    x = bb._stage0(st, sp.KeyedIndex(*table, sp.subm_queries(st)), dt)
    for stage, cap in zip((bb.conv2, bb.conv3, bb.conv4), bb.caps):
        x = stage(x, _keyed_plan(x, stage, cap, table), dt)
        table = sp.key_table_presorted(x)
        x = _blocks(stage, x, sp.KeyedIndex(*table, sp.subm_queries(x)), dt)
    return bb.extra_conv(x, _keyed_plan(x, bb.extra_conv, bb.caps[3], table), dt)


@contextlib.contextmanager
def route(model, name: str):
    """Run the model's unplanned trunk by `name` ("gather" or "keyed")."""
    if name == "keyed":
        model.backbone._built = functools.partial(keyed_trunk, model.backbone)
    try:
        yield
    finally:
        model.backbone.__dict__.pop("_built", None)


STAGES = ("down1", "down2", "down3", "extra")


def stage_sets(run) -> list[dict]:
    """The four strided output sets of the unplanned trunk pass `run()`
    makes: per stage its name, its distinct outputs before the cap, the
    cap, the set it keeps (coords, valid), its geometry (input shape,
    kernel, stride, padding) and per frame of the batch its distinct
    outputs and those kept ("lane_distinct", "lane_kept"). A set larger
    than its cap keeps its cap's smallest keys, as host plans do
    (plans.py), so the routes build the same sets either way; keys are
    batch-major, so those are the first frames'."""
    with recorded("strided_output_set") as calls, torch.no_grad():
        run()
    out = []
    for name, args in zip(STAGES, calls["strided_output_set"]):
        st, kernel, stride, padding, cap = args
        cand, out_shape = sp._strided_candidates(st, kernel, stride, padding)
        uniq = torch.unique(cand[cand != SENTINEL]).long()
        lane = torch.div(uniq, int(np.prod(out_shape)) + 1, rounding_mode="floor")
        coords, valid, _ = sp.strided_output_set(*args)
        B = st.batch_size
        out.append(dict(name=name, distinct=int(uniq.numel()), cap=cap, coords=coords,
                        valid=valid, geometry=(st.shape, kernel, stride, padding),
                        lane_distinct=torch.bincount(lane, minlength=B).tolist(),
                        lane_kept=torch.bincount(coords[valid, 0].long(), minlength=B).tolist()))
    return out


def keyed_conv_cases(model, frame) -> list[dict]:
    """Each keyed_conv call of the keyed route on `frame` against its plain
    version (bf16, atol/rtol 2e-2), a second run (the same bits) and the
    times: [{cin, co, K, M, V, err, ms, plain_ms, hits}]."""
    from .ops.kernels import window_conv as wc
    from .timing import median_ms

    with route(model, "keyed"), recorded("keyed_conv") as calls, torch.no_grad():
        model.bev_single(frame)
    recs = []
    for skeys, perm, q, f, w in calls["keyed_conv"]:
        got, want = wc.keyed_conv(skeys, perm, q, f, w), wc.keyed_conv_plain(skeys, perm, q, f, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bad = float(((got - want).abs() - 2e-2 * want.abs()).max())
        if bad > 2e-2:
            raise RuntimeError(f"keyed_conv {tuple(w.shape)} M={q.shape[0]}: max abs err {err}")
        if not torch.equal(wc.keyed_conv(skeys, perm, q, f, w), got):
            raise RuntimeError(f"keyed_conv {tuple(w.shape)}: two runs differ")
        recs.append(dict(K=w.shape[0], cin=w.shape[1], co=w.shape[2], M=q.shape[0],
                         V=f.shape[0], err=err,
                         hits=int((wc.keyed_rows(skeys, perm, q) < f.shape[0]).sum()),
                         ms=median_ms(lambda: wc.keyed_conv(skeys, perm, q, f, w)),
                         plain_ms=median_ms(lambda: wc.keyed_conv_plain(skeys, perm, q, f, w))))
    return recs


def gather_kernel_ms(model, frame) -> dict:
    """Per frame of the gather route: the summed kernel time of its
    sorted_lookup and gather_conv calls (each the median of CUDA-event-timed
    calls) and the calls' count."""
    from .ops.kernels import gather_conv as gc
    from .ops.kernels import lookup as lk
    from .timing import median_ms

    with recorded("sorted_lookup", "gather_conv") as calls, torch.no_grad():
        model.bev_single(frame)
    return {"sorted_lookup": (sum(median_ms(lambda a=a: lk.sorted_lookup(*a))
                                  for a in calls["sorted_lookup"]), len(calls["sorted_lookup"])),
            "gather_conv": (sum(median_ms(lambda a=a: gc.gather_conv(*a))
                                for a in calls["gather_conv"]), len(calls["gather_conv"]))}


def drive(model, frame, frames: int):
    """`frames` step_frame calls of a fresh pipeline, outputs fetched two
    frames deep; returns the outputs."""
    pipe = ScenePipeline(model, cls_id=2)
    outs, pending = [], collections.deque()
    for _ in range(frames):
        out = pipe.step_frame(frame, 60, 0.5).start_fetch()
        pending.append(out)
        outs.append(out)
        if len(pending) > 2:
            pending.popleft().tid
    for out in pending:
        out.tid
    return outs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    from .ops.kernels import gather_conv, lookup, window_conv
    from .profile_step import car_setup, profile_steps, step_fn, without_plans

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    _, _, _, model, planned = car_setup(dev)
    frame = without_plans(planned)
    for st in stage_sets(lambda: model.bev_single(frame)):
        print(f"  {st['name']:6s} output set {st['distinct']:7d} of cap {st['cap']:7d}"
              + ("  truncated to the cap" if st["distinct"] > st["cap"] else ""))
    with torch.no_grad():
        ref = model.bev_single(planned)
        for r in ("gather", "keyed"):
            with route(model, r):
                bev = model.bev_single(frame)
            print(f"  {r:6s} BEV max abs diff from the planned route "
                  f"{float((bev - ref).abs().max()):.4g} (max |planned| "
                  f"{float(ref.abs().max()):.4g}, bf16)")
    result = {"card": smi, "keyed_conv": keyed_conv_cases(model, frame),
              "gather": gather_kernel_ms(model, frame)}
    for c in result["keyed_conv"]:
        print(f"  keyed_conv {c['cin']:3d}->{c['co']:3d} K={c['K']:2d} M={c['M']:6d} "
              f"hits {c['hits'] / c['M']:.3f}/row  kernel {c['ms']:.4f} ms  plain "
              f"{c['plain_ms']:.4f} ms  err {c['err']:.3g}")
    print(f"  keyed route kernels per frame: keyed_conv "
          f"{sum(c['ms'] for c in result['keyed_conv']):.4f} ms over "
          f"{len(result['keyed_conv'])} calls")
    print(f"  gather route kernels per frame: " + ", ".join(
        f"{k} {ms:.4f} ms over {n} calls" for k, (ms, n) in result["gather"].items()))

    counted = (lookup.sorted_lookup, gather_conv.gather_conv, window_conv.keyed_conv)
    fps = {"gather": [], "keyed": []}
    launches = {}
    for _ in range(args.runs):
        for r in fps:
            with route(model, r):
                drive(model, frame, 3)
                torch.cuda.synchronize()
                for k in counted:
                    k.launches = 0
                t0 = time.perf_counter()
                drive(model, frame, args.frames)
                torch.cuda.synchronize()
                fps[r].append(args.frames / (time.perf_counter() - t0))
                launches[r] = {k.__name__: k.launches / args.frames for k in counted}
    result["frames_per_s"] = fps
    result["launches_per_frame"] = launches
    result["profile"] = {}
    for r in fps:
        with route(model, r):
            step = step_fn(model, frame, 1)
            for _ in range(3):
                step().tid
            p = profile_steps(step, 10)
        result["profile"][r] = {k: p[k] for k in ("wall_ms", "busy_ms", "spans", "launches")}
        print(f"  {r:6s} frames/s {[round(x, 3) for x in fps[r]]} (median "
              f"{statistics.median(fps[r]):.3f}); launches per frame {launches[r]}; "
              f"profiled: host wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms, "
              f"trunk span {p['spans'].get('step.sparse_trunk', (0, 0))}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
