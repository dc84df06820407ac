"""Weights between the JAX package's variable tree and the port.

The port's parameters carry det3d state_dict names and layouts (the keys
shasta_tpu/train/convert.py:109-192 reads), so a reference checkpoint
loads with `load_state_dict` as is. `load_jax_variables` carries a JAX
`{'params', 'batch_stats'}` tree, given as numpy arrays, into the port:
it is the inverse of that converter, including the spconv-1.x sparse
layout (kz, ky, kx, in, out), the ZeroPad-indexed neck.blocks.{i}.{j} and
the deconv tap flip (convert.py:70-75).

    load_jax_variables(model, variables_np)
    random_jax_variables(model, seed)  # a seeded random tree of that layout
    class_models_from_jax(cfgs, trees, trunk_key)  # the multi-class step's models

The model is a ShastaModel, a BEVMap (its backbone and neck), a
PillarFeatureNet (pfn_{i} Dense and bn_{i}) or a DeformConv2d
(offset_conv, kernel (K*C, F) and bias).
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from torch import nn

from .models.bevmap import BEVMap
from .models.pillars import PillarFeatureNet
from .models.shasta import ShastaModel
from .ops.dcn import DeformConv2d

# (port key, path in the JAX tree, port-from-jax, jax-from-port)
Entry = tuple[str, tuple, Callable, Callable]


def _ident(a):
    return a


def _lin_t(a):
    return a.T


def _conv_to_port(a):  # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
    return a.transpose(3, 2, 0, 1)


def _conv_to_jax(a):
    return a.transpose(2, 3, 1, 0)


def _deconv_to_port(a):  # flax (kh, kw, in, out), taps flipped -> torch (in, out, kh, kw)
    return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _deconv_to_jax(a):
    return a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)


def _sparse(ks):
    def to_port(a):  # (K, in, out) -> (kz, ky, kx, in, out)
        return a.reshape(*ks, *a.shape[1:])

    def to_jax(a):
        return a.reshape(-1, *a.shape[3:])
    return to_port, to_jax


def _bn(port: str, params: tuple, stats: tuple) -> Iterator[Entry]:
    yield f"{port}.weight", ("params", *params, "scale"), _ident, _ident
    yield f"{port}.bias", ("params", *params, "bias"), _ident, _ident
    yield f"{port}.running_mean", ("batch_stats", *stats, "mean"), _ident, _ident
    yield f"{port}.running_var", ("batch_stats", *stats, "var"), _ident, _ident


def _linear(port: str, path: tuple) -> Iterator[Entry]:
    yield f"{port}.weight", ("params", *path, "kernel"), _lin_t, _lin_t
    yield f"{port}.bias", ("params", *path, "bias"), _ident, _ident


def _trunk_entries(model: ShastaModel | BEVMap) -> Iterator[Entry]:
    """The backbone and the neck."""
    s3 = _sparse((3, 3, 3))
    bb = ("backbone",)
    yield ("backbone.conv_input.0.weight", ("params", *bb, "conv_input_kernel"), *s3)
    yield from _bn("backbone.conv_input.1", (*bb, "conv_input_bn"), (*bb, "conv_input_bn"))

    def block(port, name):
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            yield f"{port}.{conv}.weight", ("params", *bb, name, conv, "kernel"), *s3
            yield f"{port}.{conv}.bias", ("params", *bb, name, conv, "bias"), _ident, _ident
            yield from _bn(f"{port}.{bn}", (*bb, name, bn), (*bb, name, bn))

    yield from block("backbone.conv1.0", "res0a")
    yield from block("backbone.conv1.1", "res0b")
    for stage, down, blocks in (("conv2", "down1", ("res1a", "res1b")),
                                ("conv3", "down2", ("res2a", "res2b")),
                                ("conv4", "down3", ("res3a", "res3b")),
                                ("extra_conv", "extra", ())):
        ks = (3, 1, 1) if stage == "extra_conv" else (3, 3, 3)
        yield (f"backbone.{stage}.0.weight", ("params", *bb, down, "kernel"), *_sparse(ks))
        yield from _bn(f"backbone.{stage}.1", (*bb, down, "bn"), (*bb, down, "bn"))
        for i, name in enumerate(blocks):
            yield from block(f"backbone.{stage}.{3 + i}", name)

    for i, blk in enumerate(model.neck.blocks):
        n = (len(blk) - 4) // 3
        path = ("neck", f"block_{i}")
        yield (f"neck.blocks.{i}.1.weight", ("params", *path, "down", "conv", "kernel"),
               _conv_to_port, _conv_to_jax)
        yield from _bn(f"neck.blocks.{i}.2", (*path, "down", "bn"), (*path, "down", "bn"))
        for j in range(n):
            idx = 4 + 3 * j
            yield (f"neck.blocks.{i}.{idx}.weight",
                   ("params", *path, f"conv_{j}", "conv", "kernel"), _conv_to_port, _conv_to_jax)
            yield from _bn(f"neck.blocks.{i}.{idx + 1}", (*path, f"conv_{j}", "bn"),
                           (*path, f"conv_{j}", "bn"))
        dpath = ("neck", f"deblock_{i}")
        if isinstance(model.neck.deblocks[i][0], torch.nn.ConvTranspose2d):
            yield (f"neck.deblocks.{i}.0.weight", ("params", *dpath, "deconv", "kernel"),
                   _deconv_to_port, _deconv_to_jax)
        else:
            yield (f"neck.deblocks.{i}.0.weight", ("params", *dpath, "conv", "kernel"),
                   _conv_to_port, _conv_to_jax)
        yield from _bn(f"neck.deblocks.{i}.1", (*dpath, "bn"), (*dpath, "bn"))


def _shasta_entries(model: ShastaModel) -> Iterator[Entry]:
    yield from _trunk_entries(model)
    sc = ("shared_conv",)
    yield ("shared_conv.0.weight", ("params", *sc, "conv", "kernel"), _conv_to_port, _conv_to_jax)
    yield "shared_conv.0.bias", ("params", *sc, "conv", "bias"), _ident, _ident
    yield from _bn("shared_conv.1", (*sc, "bn"), (*sc, "bn"))

    af = ("affinity",)
    for i in range(4):
        for name in ("aug_shape", "aug_dets"):
            for li, t in enumerate((0, 2)):
                yield from _linear(f"{name}.{i}.{t}", (*af, f"{name}_{i}", f"layers_{li}"))
    for name, idx in (("fuse_shape", (0, 2, 4, 6)), ("fuse_det", (0, 2, 4)),
                      ("res_coeff", (0, 2, 4))):
        yield (f"{name}.0.weight", ("params", *af, name, "layers_0_kernel"),
               _lin_t, _lin_t)
        yield f"{name}.0.bias", ("params", *af, name, "layers_0_bias"), _ident, _ident
        for li, t in enumerate(idx[1:], start=1):
            yield from _linear(f"{name}.{t}", (*af, name, f"layers_{li}"))
    for li, t in enumerate((0, 2, 4, 6, 8, 10)):
        yield from _linear(f"aff.{t}", (*af, "aff", f"layers_{li}"))


def _pillar_entries(model: PillarFeatureNet) -> Iterator[Entry]:
    for i in range(len(model.num_filters)):
        yield f"pfn_{i}.weight", ("params", f"pfn_{i}", "kernel"), _lin_t, _lin_t
        yield from _bn(f"bn_{i}", (f"bn_{i}",), (f"bn_{i}",))


def _dcn_entries(model: DeformConv2d) -> Iterator[Entry]:
    yield ("offset_conv.weight", ("params", "offset_conv", "kernel"), _conv_to_port,
           _conv_to_jax)
    yield "offset_conv.bias", ("params", "offset_conv", "bias"), _ident, _ident
    yield "kernel", ("params", "kernel"), _ident, _ident  # (K*C, F) in both
    yield "bias", ("params", "bias"), _ident, _ident


def _entries(model: nn.Module) -> Iterator[Entry]:
    for cls, entries in ((ShastaModel, _shasta_entries), (BEVMap, _trunk_entries),
                         (PillarFeatureNet, _pillar_entries), (DeformConv2d, _dcn_entries)):
        if isinstance(model, cls):
            return entries(model)
    raise TypeError(f"no JAX layout for {type(model).__name__}")


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def load_jax_variables(model: nn.Module, variables_np) -> None:
    """Load a JAX variable tree (numpy leaves) of the model's JAX
    counterpart into `model`, strictly: every port parameter and running
    statistic gets a value."""
    sd = model.state_dict()
    new = {}
    for key, path, to_port, _ in _entries(model):
        a = np.ascontiguousarray(to_port(np.asarray(_get(variables_np, path), np.float32)))
        if tuple(a.shape) != tuple(sd[key].shape):
            raise ValueError(f"{key}: JAX {path} gives {a.shape}, port wants "
                             f"{tuple(sd[key].shape)}")
        new[key] = torch.from_numpy(a)
    # BN batch counters carry no JAX counterpart
    missing = [k for k in sd if k not in new and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"no JAX value for port keys {missing}")
    for k in sd:
        new.setdefault(k, sd[k])
    model.load_state_dict(new, strict=True)


def random_jax_variables(model: nn.Module, seed: int = 0) -> dict:
    """A seeded random variable tree in the JAX layout, sized for `model`:
    weights ~ N(0, 1/fan_in), BN scale ~ N(1, 0.1), bias and mean ~
    N(0, 0.1), var ~ U(0.5, 2). Made with numpy only."""
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    tree: dict = {}
    for key, path, _, to_jax in _entries(model):
        shape = tuple(sd[key].shape)
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif key.endswith(("running_mean", "bias")):
            a = rng.normal(0.0, 0.1, shape)
        elif len(shape) == 1:  # BN scale
            a = rng.normal(1.0, 0.1, shape)
        else:
            if "backbone" in key:  # (kz, ky, kx, in, out)
                fan_in = int(np.prod(shape[:-1]))
            elif to_jax is _deconv_to_jax:  # (in, out, 2, 2), stride 2: one tap each
                fan_in = shape[0]
            elif key == "kernel":  # DeformConv2d's (K*C, F)
                fan_in = shape[0]
            else:  # Linear (out, in), Conv2d (out, in, kh, kw)
                fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0.0, fan_in ** -0.5, shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(to_jax(a.astype(np.float32)))
    return tree


TRUNK_PARTS = ("backbone", "neck", "shared_conv")


def class_models_from_jax(cfgs: dict, trees: dict, trunk_key: str = "car") -> dict:
    """{name: ShastaModel} for MultiClassScenePipeline from one JAX variable
    tree per class (numpy leaves), through `load_jax_variables`: each
    class's affinity head from its own tree, the trunk (backbone, neck,
    shared conv) from `trunk_key`'s tree for every class, as the released
    per-class models share one frozen trunk. cfgs: {name: ShastaConfig}.
    The models are built on the CPU: the pipeline stacks their heads and
    copies one trunk to its card."""
    trunk = trees[trunk_key]
    models = {}
    for name, cfg in cfgs.items():
        tree = {col: dict(trees[name].get(col, {})) for col in ("params", "batch_stats")}
        for col in tree:
            tree[col].update({p: trunk[col][p] for p in TRUNK_PARTS if p in trunk.get(col, {})})
        models[name] = ShastaModel(cfg, device="cpu")
        load_jax_variables(models[name], tree)
    return models
