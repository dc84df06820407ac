"""Uniform-width affinity heads for the fused 7-class step: the port of
shasta_tpu/multiclass.py:36-131.

The 7 per-class models have their own max_obj (car 90, bicycle 50, bus 20,
... configs/nusc/*.py), and the anchor MLPs (aug_*) and the aff MLP's
width depend on it. `pad_affinity_params` turns a max_obj=n_old head into
an exactly equivalent max_obj=n_new >= n_old head:

- anchor-MLP input columns and hidden units are zero-scattered (padded
  entity slots carry zero features, padded hidden units zero bias and zero
  outgoing weights);
- the aff MLP's entity inputs/outputs stay at [0, n_old) and its two anchor
  slots move from [n_old, n_old+2) to [n_new, n_new+2);
- the pairwise MLPs do not depend on max_obj and copy through.

With AffinityNet(n_real=n_old), which keeps padded rows out of the column
normalisation and gives padded rows/cols no softmax mass, the padded head
equals the original on every real row, col and anchor.

The heads are the port's state_dicts (det3d names, torch Linear layout
(out, in)), as torch tensors or numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

HEAD_PREFIXES = ("aug_shape.", "aug_dets.", "fuse_shape.", "fuse_det.", "res_coeff.",
                 "aff.")


def head_state(state: dict) -> dict:
    """The affinity-head entries of a ShastaModel (or AffinityNet) state_dict."""
    return {k: v for k, v in state.items() if k.startswith(HEAD_PREFIXES)}


def _scatter(shape, src, rows=None, cols=None) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    r = np.arange(src.shape[0]) if rows is None else rows
    if src.ndim == 1:
        out[r] = src
    else:
        out[np.ix_(r, np.arange(src.shape[1]) if cols is None else cols)] = src
    return out


def pad_affinity_params(state: dict, n_old: int, n_new: int, F: int = 320) -> dict:
    """state: the affinity-head entries of a max_obj=n_old model. Returns the
    equivalent max_obj=n_new entries, torch tensors if `state` holds any,
    numpy arrays otherwise (see the module doc)."""
    if n_old == n_new:
        return dict(state)
    assert n_old < n_new
    as_torch = any(isinstance(v, torch.Tensor) for v in state.values())
    src = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in state.items()}
    out = dict(src)
    # anchor slots move from [n_old, n_old+2) to [n_new, n_new+2)
    slots = np.concatenate([np.arange(n_old), [n_new, n_new + 1]])
    for name, width, div in (("aug_shape", F, 64), ("aug_dets", 7, 32)):
        h_new = n_new * width // div
        for i in range(4):
            p = f"{name}.{i}"
            out[f"{p}.0.weight"] = _scatter((h_new, n_new * width), src[f"{p}.0.weight"])
            out[f"{p}.0.bias"] = _scatter((h_new,), src[f"{p}.0.bias"])
            w1 = src[f"{p}.2.weight"]
            out[f"{p}.2.weight"] = _scatter((w1.shape[0], h_new), w1)
    out["aff.0.weight"] = _scatter((128, n_new + 2), src["aff.0.weight"],
                                   cols=slots)
    out["aff.10.weight"] = _scatter((n_new + 2, 128), src["aff.10.weight"], rows=slots)
    out["aff.10.bias"] = _scatter((n_new + 2,), src["aff.10.bias"], rows=slots)
    if as_torch:
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
    return out


def stack_class_heads(class_models: dict, names, n_max: int):
    """class_models: {name: ShastaModel}. Returns ({key: (C, ...) tensor on
    the CPU}, n_real (C,) int32): each class's head padded to n_max and
    stacked along a leading class axis, in `names` order."""
    padded, n_real = [], []
    for n in names:
        m = class_models[n]
        cfg = m.cfg
        padded.append(pad_affinity_params(head_state(m.state_dict()), cfg.max_obj, n_max,
                                          F=cfg.num_point * cfg.share_conv_channel))
        n_real.append(cfg.max_obj)
    stacked = {k: torch.stack([torch.as_tensor(p[k]).cpu() for p in padded])
               for k in padded[0]}
    return stacked, torch.tensor(n_real, dtype=torch.int32)


def pad_rows(a: np.ndarray, n_new: int) -> np.ndarray:
    """Pad the entity axis 1 of (B, N_old, ...) boxes or descriptors to
    n_new with zeros: the padded slots the equivalence transform expects."""
    pad = [(0, 0)] * np.ndim(a)
    pad[1] = (0, n_new - np.shape(a)[1])
    return np.pad(a, pad)
