"""Sparse 3D ResNet trunk (SpMiddleResNetFHD): the port of
shasta_tpu/models/backbone.py.

Module and parameter names follow the det3d state_dict that
shasta_tpu/train/convert.py reads (scn.py:99-161): conv_input.{0,1},
conv1.{0,1}, conv{2,3,4}.{0,1,3,4} and extra_conv.{0,1}; sparse weights
keep the spconv-1.x layout (kz, ky, kx, in, out).

Two routes:
- with host plans (B=1): the C_in <= 32 convs (conv_input, res0, down1,
  res1, down2: 11 per frame) run `rulebook_conv` on host-built rulebooks
  (shasta_tpu_torch/plans.py); the C_in >= 64 convs (res2, down3, res3,
  extra: 10 per frame) run `keyed_conv` on query keys built on the device,
  the split of backbone.py:210-287;
- without plans (any B): every index is built on the device through
  `sorted_lookup` (12 launches per step) and all 21 convs run
  `gather_conv`, the JAX B > 1 route (backbone.py:217-226). On the card,
  in eval mode and with no gradient to record, that route is one CUDA
  graph a call, captured once per input key (models/trunk_graph.py).

The kernels have no backward. A trunk whose parameters require grad, with
grad mode on, runs the route without plans on the kernels' plain versions,
which autograd differentiates (the JAX XLA route, use_pallas_gather=False).
In train mode the BNs normalise with the valid rows' batch statistics and
update their running statistics (training with bn_train).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import sparse as sp
from .trunk_graph import TrunkGraphs


class SparseBN(nn.BatchNorm1d):
    """BatchNorm1d (eps 1e-3) over the valid rows. Eval mode: the running
    statistics. Train mode (backbone.py:40-53): the valid rows' mean and
    biased variance, and the running statistics move 0.01 of the way to
    them; with `sync` their parts are summed over the process group first."""

    def __init__(self, num_features: int, sync: bool = False):
        super().__init__(num_features, eps=1e-3, momentum=0.01)
        self.sync = sync

    def forward(self, feats, valid):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = sp.masked_batch_stats(feats, valid, self.sync)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(mean * self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(var * self.momentum)
        return sp.masked_batch_norm(feats, valid, self.weight, self.bias, mean, var,
                                    self.eps)


class SubMConv(nn.Module):
    """Sparse conv weight in spconv-1.x layout (kz, ky, kx, in, out), with
    an optional bias. Serves both the submanifold and the strided convs:
    the index decides where outputs sit."""

    def __init__(self, c_in: int, c_out: int, kernel=(3, 3, 3), bias: bool = True):
        super().__init__()
        fan_in = c_in * kernel[0] * kernel[1] * kernel[2]
        self.weight = nn.Parameter(torch.randn(*kernel, c_in, c_out) / fan_in**0.5)
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, feats, index, valid, compute_dtype=None):
        K = self.weight.shape[0] * self.weight.shape[1] * self.weight.shape[2]
        w = self.weight.reshape(K, *self.weight.shape[3:])
        out = sp.sparse_conv(feats, index, w, compute_dtype)
        if self.bias is not None:
            out = out + self.bias
        return torch.where(valid[:, None], out, 0.0)


class SparseBasicBlock(nn.Module):
    """Residual block (scn.py:52-95): conv-bn-relu-conv-bn + identity, relu."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = SubMConv(planes, planes)
        self.bn1 = SparseBN(planes)
        self.conv2 = SubMConv(planes, planes)
        self.bn2 = SparseBN(planes)

    def forward(self, st: sp.SparseTensor, index, compute_dtype=None):
        identity = st.feats
        f = self.conv1(st.feats, index, st.valid, compute_dtype)
        f = torch.relu(self.bn1(f, st.valid))
        f = self.conv2(f, index, st.valid, compute_dtype)
        f = torch.relu(self.bn2(f, st.valid) + identity)
        return st._replace(feats=torch.where(st.valid[:, None], f, 0.0))


class StridedConvBNReLU(nn.Sequential):
    """det3d's stage Sequential: strided sparse conv (no bias), BN, ReLU,
    then the stage's residual blocks at indices 3 and 4."""

    def __init__(self, c_in, c_out, kernel, stride, padding, blocks: int = 2):
        super().__init__(SubMConv(c_in, c_out, kernel, bias=False),
                         SparseBN(c_out), nn.ReLU(),
                         *[SparseBasicBlock(c_out) for _ in range(blocks)])
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, st: sp.SparseTensor, plan: sp.StridedPlan, compute_dtype=None):
        """The strided conv over `plan` (output set and index), BN, ReLU.
        Returns the strided output only; the backbone drives the blocks
        (they need the stage index)."""
        f = self[0](st.feats, plan.index, plan.valid, compute_dtype)
        f = torch.relu(self[1](f, plan.valid))
        return sp.SparseTensor(f, plan.coords, plan.valid, plan.out_shape, st.batch_size)

    def geometry(self):
        return self.kernel, self.stride, self.padding

    def blocks(self):
        return list(self)[3:]


def _planned(st: sp.SparseTensor, stage: StridedConvBNReLU, out_keys, index_of):
    """StridedPlan from a host-built output set; index_of(out_coords,
    out_valid) gives the conv's index."""
    coords, valid, shape = sp.decode_strided_keys(out_keys, st.shape, *stage.geometry(),
                                                  st.batch_size)
    return sp.StridedPlan(coords, valid, index_of(coords, valid), shape)


def _keyed_subm(st: sp.SparseTensor) -> sp.KeyedIndex:
    skeys, perm = sp.key_table(st)
    return sp.KeyedIndex(skeys, perm, sp.subm_queries(st))


def _keyed_strided(st: sp.SparseTensor, stage: StridedConvBNReLU):
    """index_of for a strided conv whose input rows are found by key."""
    skeys, perm = sp.key_table(st)

    def index_of(coords, valid):
        q = sp.strided_queries(coords, valid, st.shape, *stage.geometry())
        return sp.KeyedIndex(skeys, perm, q)
    return index_of


def _blocks(stage: StridedConvBNReLU, x: sp.SparseTensor, index, dt):
    for blk in stage.blocks():
        x = blk(x, index, dt)
    return x


class SparseBackbone(nn.Module):
    """Returns the dense BEV map NCHW (B, C*D, H, W), channel c*D + d."""

    def __init__(self, num_input_features: int = 5, dtype=None,
                 caps=(60000, 30000, 15000, 15000), bn_sync: bool = False):
        super().__init__()
        self.dtype = dtype  # torch.bfloat16: conv inputs in bf16, f32 sums
        # output-set caps of conv2, conv3, conv4 and extra_conv (unplanned route)
        self.caps = tuple(caps)
        self.conv_input = nn.Sequential(
            SubMConv(num_input_features, 16, bias=False), SparseBN(16), nn.ReLU())
        self.conv1 = nn.Sequential(SparseBasicBlock(16), SparseBasicBlock(16))
        self.conv2 = StridedConvBNReLU(16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        self.conv3 = StridedConvBNReLU(32, 64, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        # z unpadded: padding (0, 1, 1), scn.py:146
        self.conv4 = StridedConvBNReLU(64, 128, (3, 3, 3), (2, 2, 2), (0, 1, 1))
        # (3,1,1) stride (2,1,1), no blocks (scn.py:155-161)
        self.extra_conv = StridedConvBNReLU(128, 128, (3, 1, 1), (2, 1, 1),
                                            (0, 0, 0), blocks=0)
        for m in self.modules():
            if isinstance(m, SparseBN):
                m.sync = bn_sync
        self._graphs = TrunkGraphs()

    def _apply(self, fn, *args, **kwargs):
        # a graph reads the parameters' memory: one that .to() or the like
        # replaces leaves every graph stale
        self._graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _stage0(self, st: sp.SparseTensor, idx0, dt):
        """conv_input and res0, which share one index."""
        f = self.conv_input[0](st.feats, idx0, st.valid, dt)
        x = st._replace(feats=torch.relu(self.conv_input[1](f, st.valid)))
        for blk in self.conv1:
            x = blk(x, idx0, dt)
        return x

    def _planned(self, st: sp.SparseTensor, plans: dict) -> sp.SparseTensor:
        """B=1 with host plans: 11 rulebook_conv + 10 keyed_conv."""
        dt = self.dtype
        # stage 0: host rulebook shared by conv_input and res0
        x = self._stage0(st, sp.Rulebook(plans["s0_rb"]), dt)
        # stages 1-2: output sets and rulebooks from the host
        x = self.conv2(x, _planned(x, self.conv2, plans["d1_keys"],
                                   lambda c, v: sp.Rulebook(plans["d1_rb"])), dt)
        x = _blocks(self.conv2, x, sp.Rulebook(plans["d1s_rb"]), dt)
        x = self.conv3(x, _planned(x, self.conv3, plans["d2_keys"],
                                   lambda c, v: sp.Rulebook(plans["d2_rb"])), dt)
        # stages 2-3 and extra: neighbours found by key inside keyed_conv
        x = _blocks(self.conv3, x, _keyed_subm(x), dt)
        x = self.conv4(x, _planned(x, self.conv4, plans["d3_keys"],
                                   _keyed_strided(x, self.conv4)), dt)
        x = _blocks(self.conv4, x, _keyed_subm(x), dt)
        return self.extra_conv(x, _planned(x, self.extra_conv, plans["ex_keys"],
                                           _keyed_strided(x, self.extra_conv)), dt)

    def _built(self, st: sp.SparseTensor, plain: bool = False,
               tally: list | None = None) -> sp.SparseTensor:
        """Any B, no plans: every index built on the device through
        sorted_lookup (4 subm triple + 3 strided triple + 1 strided plain
        + 4 identity compactions) and all 21 convs on gather_conv (plain:
        their plain versions). The stage-0 table takes a stable argsort;
        every strided output set is key-sorted, so later tables need none
        (backbone.py:210-287). While a profiler records, each strided stage
        counts its set against its cap (trunk.cap.<stage>.*, per lane), or
        into `tally` (`sp.strided_output_set`)."""
        dt = self.dtype
        table = sp.key_table(st)
        x = self._stage0(st, sp.build_subm_index(st, table, plain), dt)
        for name, stage, cap in zip(("conv2", "conv3", "conv4"),
                                    (self.conv2, self.conv3, self.conv4), self.caps):
            x = stage(x, sp.build_strided_plan(x, *stage.geometry(), cap, table, plain,
                                               name, tally), dt)
            table = sp.key_table_presorted(x)
            x = _blocks(stage, x, sp.build_subm_index(x, table, plain), dt)
        return self.extra_conv(x, sp.build_strided_plan(
            x, *self.extra_conv.geometry(), self.caps[3], table, plain, "extra", tally), dt)

    def trains(self) -> bool:
        """Whether this call builds a graph through the trunk: grad mode is
        on and a parameter requires grad (the kernels cannot take part)."""
        return torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())

    def graphed(self, st: sp.SparseTensor, plans: dict | None) -> bool:
        """Whether this call runs the route without plans as a CUDA graph:
        on the card, in eval mode, with no gradient to record (grad mode
        off, or neither a parameter nor the input requires one)."""
        return (plans is None and st.feats.is_cuda and not self.training and not self.trains()
                and not (torch.is_grad_enabled() and st.feats.requires_grad))

    def forward(self, st: sp.SparseTensor, plans: dict | None = None) -> torch.Tensor:
        """plans: the host plans of a B=1 frame (shasta_tpu_torch/plans.py),
        or None to build every index on the device. Where `graphed`, the
        result is a graph's static output, which the next call at the same
        shapes overwrites: read it before calling the trunk again."""
        if plans is not None and self.trains():
            raise ValueError("host plans serve inference: a trunk that trains runs without")
        if self.graphed(st, plans):
            key = (st.feats.shape, st.feats.dtype, st.coords.shape, st.coords.dtype,
                   st.valid.dtype, st.feats.device, st.batch_size, st.shape, self.caps,
                   self.dtype)
            dense = self._graphs(lambda s, tally: self._dense(self._built(s, tally=tally)),
                                 st, key)
            if dense is not None:
                return dense
        return self._dense(self._built(st, self.trains()) if plans is None
                           else self._planned(st, plans))

    @staticmethod
    def _dense(x: sp.SparseTensor) -> torch.Tensor:
        dense = sp.to_dense(x)  # (B, D, H, W, C)
        B, D, H, W, C = dense.shape
        # torch views (N, C, D, H, W) as (N, C*D, H, W): channel c*D + d
        return dense.permute(0, 4, 1, 2, 3).reshape(B, C * D, H, W)
