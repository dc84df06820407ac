"""rulebook_conv: the port of the TPU kernel `_pos_conv_kernel`
(shasta_tpu/ops/pallas/block_conv.py:117, launched by `_pos_conv_call`
:181, wrapped by `pos_conv_apply` :218).

    rulebook_conv(feats (V, Cin), nbr (M, K) int32, weight (K, Cin, Co))
        -> (M, Co) f32,   out[m] = sum_k feats[nbr[m, k]] @ weight[k]

A rulebook entry of -1 (or any row outside [0, V)) is a miss and adds
nothing. feats and weight share one dtype, f32 or bf16; the sum is f32.

The CUDA kernel (csrc/block_conv.cu) reads the rulebook as gather_conv
reads its table. Both dtypes run the tensor-core cores of
csrc/gather_mma.cuh (f32 sums, no atomics): bf16 (the planned step's trunk)
on mma.sync m16n8k16, every conv of the path on the warp core: all of W
(at most 124 KB at 32 -> 64) once per block in shared memory, each warp
reads its 16 rows' rulebook entries in one coalesced load and walks their
hit taps, the sums in registers. f32 (the parity route) runs as three TF32
passes on m16n8k8, f32-accurate: the warp core through 32 -> 32, the staged
core for 32 -> 64, whose f32 W does not fit. What bounds it on the H100:
2*hits*Cin*Co FLOPs against the rulebook (M*K*4 bytes, most of them), the
output (M*Co*4) and the gathered rows; the V x Cin table (at most 120k x 16
x 2 bytes at bench scale in bf16) fits in the 50 MB L2, so gathers hit L2.
At the main path's Cin*Co <= 2048 the bound is the bytes.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import refuse_autograd

_DTYPES = (torch.float32, torch.bfloat16)
CO_SUPPORTED = (16, 32, 64, 128)
K_MAX = 27


def rulebook_conv_plain(feats: torch.Tensor, nbr: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """Pad a zero row, gather (M, K, Cin), one f32 matmul."""
    V, C = feats.shape
    M, K = nbr.shape
    idx = torch.where((nbr >= 0) & (nbr < V), nbr, V).long()
    padded = torch.cat([feats, feats.new_zeros((1, C))]).float()
    gathered = padded[idx].reshape(M, K * C)
    return gathered @ weight.float().reshape(K * C, -1)


def check_conv_args(feats, weight, index_tensors, K):
    """Shared argument checks of the two conv wrappers."""
    if feats.dtype not in _DTYPES or weight.dtype != feats.dtype:
        raise TypeError(f"feats/weight must share f32 or bf16, got "
                        f"{feats.dtype}/{weight.dtype}")
    if feats.dim() != 2 or weight.dim() != 3:
        raise ValueError("feats must be (V, Cin) and weight (K, Cin, Co)")
    Kw, Cin, Co = weight.shape
    if Kw != K or Cin != feats.shape[1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match K={K}, "
                         f"Cin={feats.shape[1]}")
    for t in index_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")
    for t in (feats, weight, *index_tensors):
        if t.device != feats.device:
            raise ValueError("all inputs must lie on one device")
        if feats.is_cuda and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if feats.is_cuda and (Co not in CO_SUPPORTED or not 1 <= K <= K_MAX):
        raise ValueError(f"kernel supports Co in {CO_SUPPORTED} and K <= "
                         f"{K_MAX}, got Co={Co}, K={K}")
    if not (feats.is_cuda or feats.device.type == "cpu"):
        raise ValueError(f"unsupported device {feats.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.cache
def _launch_fn():
    from .build import library

    fn = library("block_conv").rulebook_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rulebook_conv(feats: torch.Tensor, nbr: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    refuse_autograd("rulebook_conv", feats, weight)
    if nbr.dim() != 2:
        raise ValueError("nbr must be (M, K)")
    M, K = nbr.shape
    check_conv_args(feats, weight, (nbr,), K)
    if not feats.is_cuda:
        return rulebook_conv_plain(feats, nbr, weight)
    V, Cin = feats.shape
    Co = weight.shape[2]
    out = torch.empty((M, Co), dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = _launch_fn()(_ptr(feats), _ptr(nbr), _ptr(weight), _ptr(out), V, M,
                       K, Cin, Co, int(feats.dtype == torch.bfloat16),
                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rulebook_conv launch failed: CUDA error {err}")
    rulebook_conv.launches += 1
    return out


rulebook_conv.launches = 0
