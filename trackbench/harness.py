"""What the drivers share: the process's start, the weights of a
configuration, the reduction of a profiler trace to spans, busy time and a
breakdown, and the comparisons that decide `correct`."""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

from .reference import model as rm


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def sub_seed(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (k + 1)) % (2**63)


def model_config(cls, model: dict, **over):
    """The port's ShastaConfig (cls) of a configuration's model keys: the
    keys it has fields for, lists as tuples, `over` on top."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items() if k in names}
    return cls(**{**kw, **over})


def caps(cfg: dict, lanes: int) -> dict:
    """The stage caps a configuration runs at `lanes` frames a step."""
    return dict(zip(("cap_conv2", "cap_conv3", "cap_conv4", "cap_extra"),
                    cfg["assumed"]["caps"][str(lanes)]))


def report_sets(sets: list, caps: dict, lanes: int) -> None:
    """Prints the reference's largest set of each strided stage against the
    cap the program runs (a step holds `lanes` frames)."""
    big = [max(x) for x in zip(*sets)][1:]
    held = all(lanes * b <= c for b, c in zip(big, caps.values()))
    print(f"trackbench: largest strided sets of {len(sets)} frames {big} x {lanes} lanes "
          f"against caps {list(caps.values())}: {'held' if held else 'CUT'}", file=sys.stderr)


def class_weights(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(trunk weights, {class: head weights}) of a configuration, made on
    `device` from the seed: the trunk shared by every class, one head per
    class at its own max_obj."""
    m = cfg["model"]
    trunk = rm.make_weights(rm.trunk_spec(m["num_input_features"], m["share_conv_channel"]),
                            sub_seed(seed, 0), device)
    heads = {c["name"]: rm.make_weights(
        rm.head_spec(c["max_obj"], m["num_feats"], m["num_point"], m["share_conv_channel"]),
        sub_seed(seed, 1 + i), device) for i, c in enumerate(cfg["classes"])}
    return trunk, heads


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def _union(iv: list) -> tuple[float, list]:
    """Total length of the intervals [(start, end)] and the gaps between them."""
    iv = sorted(iv)
    busy, gaps = 0.0, []
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps


def reduce_trace(prof) -> dict:
    """From a torch.profiler run (its Chrome trace): busy seconds on the
    device (the union of its kernels and copies), per span name its host
    seconds and the device seconds of the operations launched inside it,
    the ten device operations that took most time, and the ten longest idle
    gaps, each named by the innermost span the host had open when it began.
    A device operation whose launch the trace lacks counts for the span of
    the operation before it on the device."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans, launch, dev = [], {}, []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat is None:
            continue
        s = int(round(float(e["ts"]) * 1e3))
        end = s + int(round(float(e.get("dur", 0)) * 1e3))
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation":
            spans.append((s, end, e["name"]))
        elif cat in LAUNCH_KINDS and corr is not None:
            launch[corr] = s
        elif cat in DEVICE_KINDS:
            dev.append((s, end, e["name"], corr))
    dev.sort()
    spans.sort()
    names = sorted({n for _, _, n in spans})
    by_name = {n: [(s, e) for s, e, m in spans if m == n] for n in names}
    starts = {n: np.array([s for s, _ in v]) for n, v in by_name.items()}
    ends = {n: np.array([e for _, e in v]) for n, v in by_name.items()}

    if not dev:
        return {"busy_s": 0.0, "device_ops": [], "idle_gaps": [],
                "spans": {n: {"host_s": sum(e - s for s, e in by_name[n]) * 1e-9,
                              "device_s": 0.0, "count": len(by_name[n])} for n in names}}
    t = np.array([launch.get(c, -1) for _, _, _, c in dev], np.int64)
    known = t >= 0
    # an operation without its launch in the trace takes the owner of the one before it
    src = np.maximum.accumulate(np.where(known, np.arange(len(dev)), -1))
    dur = np.array([e - s for s, e, _, _ in dev], np.float64) * 1e-9
    span_dev = {}
    for n in names:
        i = np.searchsorted(starts[n], t, side="right") - 1
        own = (i >= 0) & (ends[n][np.maximum(i, 0)] >= t) & known
        own = np.where(src >= 0, own[np.maximum(src, 0)], False)
        span_dev[n] = float(dur[own].sum())
    ops: dict = {}
    for (_, _, name, _), d in zip(dev, dur):
        ops[name] = ops.get(name, 0.0) + d
    busy, gaps = _union([(s, e) for s, e, _, _ in dev])

    def host_at(t):
        best = None
        for n in names:
            i = np.searchsorted(starts[n], t, side="right") - 1
            if i >= 0 and ends[n][i] >= t:
                length = ends[n][i] - starts[n][i]
                if best is None or length < best[0]:
                    best = (length, n)
        return best[1] if best else "outside every span"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy * 1e-9,
        "spans": {n: {"host_s": sum(e - s for s, e in by_name[n]) * 1e-9,
                      "device_s": span_dev[n], "count": len(by_name[n])} for n in names},
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[host_at(s), (e - s) * 1e-9] for s, e in gaps[:10]],
    }


def traced(fn):
    """fn() under torch.profiler (CPU and CUDA). Returns (fn's result,
    the trace's reduction, the traced wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, reduce_trace(prof), wall


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

class Tally:
    """The compared numbers of a run. `rows_differ`: the share of compared
    rows whose outputs differ from the reference's (a flag, a track id that
    breaks the one-to-one map between the program's ids and the
    reference's in its scene pass, or a tracker score off by more than
    float32 rounding); `score_gap`: the widest gap of the eval's refined
    scores; `desc_gap`: the widest gap of the descriptors the step carries,
    over the reference's largest magnitude."""

    def __init__(self):
        self.gap, self.bad, self.rows, self.desc = None, 0, 0, None

    def descriptors(self, got: np.ndarray, want: np.ndarray) -> None:
        g = float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))
        self.desc = max(self.desc or 0.0, g)

    def score(self, got: float, want: float) -> None:
        self.gap = max(self.gap or 0.0, abs(got - want))

    def numbers(self) -> dict:
        out = {"rows_differ": self.bad / max(self.rows, 1)}
        for k, v in (("score_gap", self.gap), ("desc_gap", self.desc)):
            if v is not None:
                out[k] = v
        return out


class IdMap:
    """The one-to-one map of one scene pass: a row breaks it when its
    program id is already mapped to another reference id, or back."""

    def __init__(self):
        self.fwd, self.back = {}, {}

    def same(self, a: int, b: int) -> bool:
        return self.fwd.setdefault(a, b) == b and self.back.setdefault(b, a) == a


def compare_rows(tally: Tally, ids: IdMap, got: dict | None, want: np.ndarray) -> None:
    """One class's step outputs: got {tid, used, ref (2N), keep, fn (N)}
    against the reference's (6, 2N) rows [tid, used, ref, keep, fn, 1]."""
    N = want.shape[1] // 2
    w_used, w_keep, w_fn = want[1] > 0.5, want[3, :N] > 0.5, want[4, :N] > 0.5
    if got is None:  # the class's outputs never came: every row it tracks differs
        n = int(w_used.sum())
        tally.rows += n
        tally.bad += n
        return
    g_used = np.asarray(got["used"], bool)
    g_keep, g_fn = np.asarray(got["keep"], bool), np.asarray(got["fn"], bool)
    g_ref = np.asarray(got["ref"], np.float64)
    flagged = np.zeros(2 * N, bool)
    flagged[:N] = g_keep | g_fn | w_keep | w_fn
    for r in np.nonzero(g_used | w_used | flagged)[0]:
        tally.rows += 1
        ok = g_used[r] == w_used[r]
        if ok and w_used[r]:
            ok = (ids.same(int(got["tid"][r]), int(want[0, r]))
                  and abs(g_ref[r] - want[2, r]) <= 1e-6 * max(1.0, abs(want[2, r])))
        if r < N:
            ok = ok and g_keep[r] == w_keep[r] and g_fn[r] == w_fn[r]
        tally.bad += not ok


FLAGS = ("FN", "newborn", "dead")


def compare_annos(tally: Tally, got: list, want: list) -> None:
    """One frame's eval annotations, in order: the same detections with the
    same flags, and their refined scores."""
    tally.rows += max(len(got), len(want))
    tally.bad += abs(len(got) - len(want))
    for g, w in zip(got, want):
        same = (g["translation"] == w["translation"] and g["detection_score"]
                == w["detection_score"] and all(bool(g.get(k)) == bool(w.get(k)) for k in FLAGS))
        tally.bad += not same
        if same:
            tally.score(g["ref_detection_score"], w["ref_detection_score"])
