"""gather_conv: the port of the TPU kernel `_conv_kernel`
(shasta_tpu/ops/pallas/window_conv.py:480, launched by `_conv_call` :545,
wrapped by `windowed_gather_matmul` :568).

    gather_conv(feats (V, Cin), gather (M, K) int32, weight (K, Cin, Co))
        -> (M, Co) f32,   out[m] = sum_k feats[gather[m, k]] @ weight[k]

The gather table is the JAX NeighborIndex as it is: a row >= V (the JAX
miss) or < 0 adds nothing. K is 27 or 3 (the extra conv); feats and
weight share one dtype, f32 or bf16; the sum is f32.

The CUDA kernel (csrc/gather_conv.cu) takes one launch for all lanes, with
no windows and no coverage check. Both dtypes run the tensor-core cores of
csrc/gather_mma.cuh (f32 sums, no atomics, the same bits from run to run),
shared with rulebook_conv and keyed_conv: bf16 on mma.sync m16n8k16, f32
(every CLI path's trunk) at f32 accuracy as three TF32 passes on m16n8k8,
each operand split into tf32 hi and lo parts as its fragment is loaded
(`gather_conv_3xtf32` is the written model of that arithmetic). Where all
of W fits shared memory, the warp core (each warp walks its 16 rows' hit
taps alone with the sums in registers); the wider convs the staged core
(each tap's hit rows compacted per 128-row tile, gathered by cp.async,
summed into a shared tile). `mma_core` names the core a conv's shapes and
dtype take: f32, twice the bytes of W, leaves the warp core after 32 -> 32.
What bounds it on the H100: bytes (the gather table M*K*4, the output
M*Co*4, the table and W at their dtype's width) against 2*hits*Cin*Co
FLOPs at 989 TFLOP/s (bf16) or 495/3 (3xTF32): bf16 sits on the bytes
side on every path, f32 on the products' side on the denser frames (a
served frame, BEVMap's). Both routes run well above that bound: the wide
convs' staged tiles are bound by their stages' latency, and f32's by the
split and the three MMAs of each fragment too.

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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero: PTX cvt.rna.tf32.f32 on the int32 view (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32: hi = tf32(x), lo = tf32(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def gather_conv_3xtf32(feats: torch.Tensor, gather: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """The f32 route's arithmetic written out in torch: gather_conv_plain
    with each operand split into TF32 hi and lo parts and the three
    products hi*hi + hi*lo + lo*hi (each exact in f32) summed in f32, the
    lo*lo term dropped, as csrc/gather_mma.cuh's 3xTF32 MMAs do. The tests
    hold it against an f64 product; no path calls it."""
    V, C = feats.shape
    M, K = gather.shape
    idx = torch.where((gather >= 0) & (gather < V), gather, V).long()
    a_hi, a_lo = split_tf32(torch.cat([feats, feats.new_zeros((1, C))])[idx].reshape(M, K * C))
    w_hi, w_lo = split_tf32(weight.reshape(K * C, -1))
    return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi


MMA_CORES = ("warp", "staged")


def mma_core(K: int, Cin: int, Co: int, dtype: torch.dtype) -> str:
    """The tensor-core core (MMA_CORES) that a conv of these shapes and
    this dtype (f32 or bf16) takes on the card, in any of the three conv
    kernels: gather_mma.cuh's own choice (`core_of`; W's bytes decide)."""
    from .build import library

    fn = library("gather_conv").gather_mma_core
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return MMA_CORES[fn(K, Cin, Co, int(dtype == torch.float32))]


def _bind(lib: ctypes.CDLL):
    fn = lib.gather_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launch_fn():
    from .build import library

    return _bind(library("gather_conv"))


def build_conv(lib: ctypes.CDLL):
    """gather_conv(feats, gather, weight) on another build of
    csrc/gather_conv.cu (build.build_variant's: a design variant, or a
    parent checkout's csrc), for the probes that time it beside this one:
    no argument checks and no launch count; a failed launch raises."""
    fn = _bind(lib)

    def conv(feats, gather, weight):
        (V, Cin), (M, K), Co = feats.shape, gather.shape, weight.shape[2]
        out = torch.empty((M, Co), dtype=torch.float32, device=feats.device)
        err = fn(_ptr(feats), _ptr(gather), _ptr(weight), _ptr(out), V, M, K, Cin, Co,
                 int(feats.dtype == torch.bfloat16),
                 ctypes.c_void_p(torch.cuda.current_stream(feats.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"gather_conv launch failed: CUDA error {err}")
        return out
    return conv


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
