"""Merge the per-class cp_{split}.json files into one: the port of
tools/merge_results.py (tools/nusc_shasta/merge_results.py:34-61).

    python -m shasta_tpu_torch.tools.merge_results --inputs work_dirs/*_eval/cp_val.json \\
        --output work_dirs/merged/cp_val.json
"""
from __future__ import annotations

import argparse
import json
import os


def merge(paths: list[str]) -> dict:
    """One result whose frames hold the annotations of every input, in input
    order; the last input's meta that is set."""
    merged: dict = {"results": {}, "meta": None}
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        merged["meta"] = data.get("meta") or merged["meta"]
        for token, annos in data["results"].items():
            merged["results"].setdefault(token, []).extend(annos)
    return merged


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", nargs="+", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    out = merge(args.inputs)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"merged {len(args.inputs)} files -> {args.output} ({len(out['results'])} frames)")
    return out


if __name__ == "__main__":
    main()
