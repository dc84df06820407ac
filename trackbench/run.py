"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m trackbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's driver (drivers/<the mix's driver>.py): weights
and traffic from the seed, the program, a warm-up of every shape. Then
either the window runs for --seconds (--trace 0: the cell's end-to-end
metrics) or a fixed number of frames runs under torch.profiler (--trace 1:
the cell's per-layer metrics, each read by metrics/<name>.py). Once the
program's state is freed, the plain reference decides `correct`. The last
line of standard output is one JSON object; the compared numbers and their
limits end standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

# the host's math libraries on few threads: a steadier load from one process
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "shasta_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str) -> tuple[dict, dict, dict, list, list]:
    """(cell, configuration, mix, end-to-end metrics, per-layer metrics)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]
    return cell, cfg, mix, mine(bench["end_to_end"]), mine(bench["per_layer"])


def reader(name: str):
    """metrics/<name>.py, loaded by its file name."""
    spec = importlib.util.spec_from_file_location(f"trackbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loaded_banned() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, float), q))


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str,
             e2e: list, per_layer: list, dtype=None) -> dict:
    """Set-up, the window or the traced frames, the check. Returns the
    result line's fields (without `device`'s card readings) and the
    compared numbers."""
    import torch

    from . import harness

    driver = importlib.import_module(f"trackbench.drivers.{mix['driver']}")
    cell = driver.Cell(cfg, mix, seed, device, dtype)
    try:
        setup_s = harness.process_age_s()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if trace:
            rec, tr, wall = harness.traced(cell.trace_frames)
        else:
            rec, tr = cell.window(seconds), None
            wall = rec["wall_s"]
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        cell.release()
        compared = cell.check()
        out = {"attempted": rec["frames"], "frames": rec["frames"], "wall_s": wall,
               "memory_peak_bytes": peak, "compared": compared}
        if trace:
            ctx = dict(rec, trace=tr, wall_s=wall, **cell.work())
            metrics = {}
            for m in per_layer:
                v = reader(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            out.update(metrics=metrics, busy_s=tr["busy_s"], window_s=wall,
                       breakdown={"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]})
        else:
            values = {"setup_s": setup_s, "frames_per_s": rec["frames"] / rec["wall_s"]}
            if "latency_s" in rec:
                values["frame_p90_ms"] = percentile(rec["latency_s"], 90) * 1e3
            out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                              for m in e2e}
        return out
    finally:
        if hasattr(cell, "close"):
            cell.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, mix, e2e, per_layer = cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"trackbench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    limits = load_json(HERE, "limits", args.workload + ".json")
    t0 = time.perf_counter()
    out = run_cell(cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda", e2e, per_layer)
    banned = loaded_banned()
    if banned:
        print(f"trackbench: the run loaded {banned}", file=sys.stderr)
        return 3
    compared = {k: {"value": v, "limit": limits[k]} for k, v in out["compared"].items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    line = {"correct": correct, "attempted": out["attempted"], "failed": 0,
            "metrics": out["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["compared"] = compared
    print(f"trackbench: {args.workload} seed {args.seed}: {out['frames']} frames in "
          f"{out['wall_s']:.3f} s, {time.perf_counter() - t0:.1f} s in all", file=sys.stderr)
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
