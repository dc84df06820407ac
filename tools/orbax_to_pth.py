#!/usr/bin/env python
"""Convert an orbax checkpoint of the JAX package into a .pth that the
PyTorch port (shasta_tpu_torch) loads.

Usage:
  python tools/orbax_to_pth.py --checkpoint work_dirs/car/epoch_3 \
      --out work_dirs/car/epoch_3.pth [--config configs/nusc/car.py]

The tree is read with shasta_tpu.train.checkpoint.load_checkpoint, so this
script needs orbax, and with it JAX: it runs where the JAX package runs
(a TPU host, or any machine with jax and orbax), and the .pth it writes
is then copied to the machine that serves with the port, which needs
neither. The tree decides the port model, built on the CPU from the
config's model section: a full ShastaModel when the tree has the
affinity head, else a BEVMap (a backbone + neck tree). The weights go in
through shasta_tpu_torch.convert.load_jax_variables, which fails on any
missing leaf or shape mismatch (a head sized for another max_obj: pass
that model's config), and out through the port's save_checkpoint:
`shasta_tpu_torch.train.checkpoint.load_checkpoint` reads the file back.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="orbax checkpoint of shasta_tpu -> .pth of the port")
    p.add_argument("--checkpoint", required=True, help="orbax checkpoint directory")
    p.add_argument("--out", required=True, help="the .pth to write")
    p.add_argument("--config", default=os.path.join(REPO, "configs", "nusc", "car.py"),
                   help="the config whose model section sizes the port model")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Convert; returns the model type written ("ShastaModel" or "BEVMap")."""
    args = parse_args(argv)
    import jax
    import numpy as np

    from shasta_tpu.train.checkpoint import load_checkpoint
    from shasta_tpu_torch.convert import load_jax_variables
    from shasta_tpu_torch.models import BEVMap, ShastaModel
    from shasta_tpu_torch.tools.common import model_config
    from shasta_tpu_torch.train.checkpoint import save_checkpoint
    from shasta_tpu_torch.utils import Config

    if not os.path.isdir(args.checkpoint):
        raise SystemExit(f"{args.checkpoint}: not an orbax checkpoint directory")
    if not args.out.endswith((".pth", ".pt")):
        raise SystemExit(f"{args.out}: the port loads .pth/.pt files")
    tree = jax.tree.map(np.asarray, load_checkpoint(args.checkpoint))
    cls = ShastaModel if "affinity" in tree["params"] else BEVMap
    model = cls(model_config(Config.fromfile(args.config)), device="cpu")
    load_jax_variables(model, tree)
    save_checkpoint(args.out, model.state_dict())
    print(f"wrote {args.out}: {cls.__name__}, {len(model.state_dict())} tensors")
    return cls.__name__


if __name__ == "__main__":
    main()
