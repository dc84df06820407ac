"""Checkpoint save and load: the port of shasta_tpu/train/checkpoint.py.

Behavioral reference: det3d/torchie/trainer/checkpoint.py:166-290
(load_checkpoint/save_checkpoint) and shasta.py:111-119 (non-strict
pretrained loading). The port's modules carry det3d's state_dict names and
layouts, so a reference .pth loads as it is, with two repairs: a
`module.` prefix (DDP) is stripped, and sparse-conv weights in the spconv
2.x native layout (out, kz, ky, kx, in) go to the port's spconv 1.x dense
layout (kz, ky, kx, in, out), as the JAX converter accepts both
(shasta_tpu/train/convert.py:82-98).

Two files load: the full Shasta checkpoint, and the trunk-only
`bev_map.pth` (reader, backbone and neck), which fills reader, backbone and
neck. They are told apart by their top-level names, as the JAX loader does.
A CenterPoint-PP checkpoint's pillar reader is det3d's PFNLayer list,
`reader.pfn_layers.{i}.linear.weight` and `.norm.*`: it loads as the
port's `reader.pfn_{i}.weight` and `reader.bn_{i}.*` (`_port_name`); its
neck's names already match.
Orbax directories (the JAX package's own checkpoints) cannot be read here:
tools/orbax_to_pth.py, run where the JAX package and orbax are installed,
converts one into a .pth.

    save_checkpoint(path, model.state_dict())
    model.load_state_dict(merge_pretrained(model.state_dict(), load_checkpoint(path)))
"""
from __future__ import annotations

import os

import torch

# the parts of the model each file fills (shasta_tpu/train/convert.py:180-206)
TRUNK_PARTS = ("reader", "backbone", "neck")
FULL_PARTS = TRUNK_PARTS + ("shared_conv", "aug_shape", "aug_dets", "fuse_shape",
                            "fuse_det", "res_coeff", "aff")
SPARSE_KERNELS = ((3, 3, 3), (3, 1, 1))


def save_checkpoint(path: str, state_dict: dict) -> None:
    """torch.save of a state_dict (CPU copies), a .pth that load_checkpoint
    and the JAX package's loader both read."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def _dense_sparse_layout(key: str, w: torch.Tensor) -> torch.Tensor:
    """A backbone sparse-conv weight in the port's (kz, ky, kx, in, out)."""
    if key.startswith("backbone.") and w.dim() == 5:
        if tuple(w.shape[:3]) not in SPARSE_KERNELS and tuple(w.shape[1:4]) in SPARSE_KERNELS:
            return w.permute(1, 2, 3, 4, 0).contiguous()
    return w


def _port_name(key: str) -> str:
    """det3d's name of a pillar reader's tensor in the port's names."""
    parts = key.split(".")
    if parts[:2] == ["reader", "pfn_layers"] and len(parts) >= 5:
        i, kind = parts[2], parts[3]
        if kind == "linear":
            return ".".join(["reader", f"pfn_{i}", *parts[4:]])
        if kind == "norm":
            return ".".join(["reader", f"bn_{i}", *parts[4:]])
    return key


def load_checkpoint(path: str) -> dict:
    """A .pth/.pt file as a state_dict in the port's names and layouts:
    the full Shasta checkpoint's reader, backbone, neck, shared conv and
    affinity head, or a bev_map.pth's (or a CenterPoint checkpoint's)
    reader, backbone and neck."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: orbax checkpoints of the JAX package cannot be "
            "read by the port; convert it with `python tools/orbax_to_pth.py "
            f"--checkpoint {path} --out <file.pth>` where jax and orbax are installed, "
            "or give a .pth (det3d's, or one save_checkpoint wrote)")
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: the port loads .pth/.pt checkpoints only")
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {_port_name(k.removeprefix("module.")): v for k, v in sd.items()}
    tops = {k.split(".")[0] for k in sd}
    full = "shared_conv" in tops or any(t.startswith("aug_shape") for t in tops)
    parts = FULL_PARTS if full else TRUNK_PARTS
    return {k: _dense_sparse_layout(k, torch.as_tensor(v)) for k, v in sd.items()
            if k.split(".")[0] in parts}


def merge_pretrained(state_dict: dict, pretrained: dict) -> dict:
    """Non-strict merge (checkpoint.py:49-83 laxity + shasta.py:116
    strict=False): a copy of `state_dict` in which each tensor that
    `pretrained` has under the same name and shape is replaced by it."""
    out = dict(state_dict)
    for k, v in pretrained.items():
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = v
    return out
