"""The lower-precision control of a cell, and its readings over seeds.

    python3 -m trackbench.control --workload <cell> --seeds 1,2,3 --seconds <s> [--dtype bfloat16]

Runs the cell's set-up, a window of --seconds and the check once per seed
in one process, the program's trunk in --dtype (bfloat16: the port's own
lower-precision path; float32: the program as configured), and prints one
JSON line of compared numbers per seed. The benchmark's runs never run it;
the limits in limits/<cell>.json lie between the two dtypes' readings.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import run


def readings(workload: str, seeds, seconds: float, dtype: str) -> list[dict]:
    import torch

    _, cfg, mix, e2e, _ = run.cell_spec(workload)
    dt = None if dtype == "float32" else getattr(torch, dtype)
    out = []
    for seed in seeds:
        r = run.run_cell(cfg, mix, seed, seconds, False, "cuda", e2e, [], dtype=dt)
        out.append({"seed": seed, "dtype": dtype, "frames": r["frames"], **r["compared"]})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds, args.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
