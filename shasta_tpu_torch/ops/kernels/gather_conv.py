"""gather_conv: the port of the TPU kernel `_conv_kernel`
(shasta_tpu/ops/pallas/window_conv.py:480, launched by `_conv_call` :545,
wrapped by `windowed_gather_matmul` :568).

    gather_conv(feats (V, Cin), gather (M, K) int32, weight (K, Cin, Co))
        -> (M, Co) f32,   out[m] = sum_k feats[gather[m, k]] @ weight[k]

The gather table is the JAX NeighborIndex as it is: a row >= V (the JAX
miss) or < 0 adds nothing. K is 27 or 3 (the extra conv); feats and
weight share one dtype, f32 or bf16; the sum is f32.

The CUDA kernel (csrc/gather_conv.cu) takes one launch for all lanes, with
no windows and no coverage check. bf16 inputs run the tensor-core cores of
csrc/gather_mma.cuh (mma.sync m16n8k16, f32 sums, no atomics), shared with
rulebook_conv and keyed_conv: where all of W fits shared memory, the warp
core (each warp walks its 16 rows' hit taps alone with the sums in
registers); the wider convs the staged core (each tap's hit rows compacted
per 128-row tile, gathered by cp.async, summed into a shared tile).
`mma_core` names the core a conv's shapes take. f32 inputs run the
CUDA-core core csrc/gather_conv.cuh, the f32 parity route of all three.
What bounds it on the H100: bytes (the gather table M*K*4, the output
M*Co*4, the table and W) against 2*hits*Cin*Co FLOPs; the scene-batched
step's convs sit on the bytes side.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import refuse_autograd
from .block_conv import _ptr, check_conv_args, rulebook_conv_plain

# The plain version is the XLA path of ops/sparse.py:217-224: pad a zero
# row, gather (M, K, Cin), one f32 matmul; a row outside [0, V) takes the
# zero row. rulebook_conv's plain version is that same function.
gather_conv_plain = rulebook_conv_plain

MMA_CORES = ("warp", "staged")


def mma_core(K: int, Cin: int, Co: int) -> str:
    """The tensor-core core (MMA_CORES) that a bf16 conv of these shapes
    takes on the card, in any of the three conv kernels: gather_mma.cuh's
    own choice (`core_of`)."""
    from .build import library

    fn = library("gather_conv").gather_mma_core
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return MMA_CORES[fn(K, Cin, Co)]


@functools.cache
def _launch_fn():
    from .build import library

    fn = library("gather_conv").gather_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_conv(feats: torch.Tensor, gather: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    refuse_autograd("gather_conv", feats, weight)
    if gather.dim() != 2:
        raise ValueError("gather must be (M, K)")
    M, K = gather.shape
    check_conv_args(feats, weight, (gather,), K)
    if not feats.is_cuda:
        return gather_conv_plain(feats, gather, weight)
    V, Cin = feats.shape
    Co = weight.shape[2]
    out = torch.empty((M, Co), dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = _launch_fn()(_ptr(feats), _ptr(gather), _ptr(weight), _ptr(out), V, M,
                       K, Cin, Co, int(feats.dtype == torch.bfloat16),
                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"gather_conv launch failed: CUDA error {err}")
    gather_conv.launches += 1
    return out


gather_conv.launches = 0
