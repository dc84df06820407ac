"""keyed_conv: the port of the TPU kernel `_fused_conv_kernel`
(shasta_tpu/ops/pallas/window_conv.py:719, launched by `_fused_conv_call`
:778, wrapped by `fused_conv_apply` :876, index from `build_fused_index`
:803).

    keyed_conv(sorted_keys (V,), perm (V,), queries (M, K) int32,
               feats (V, Cin), weight (K, Cin, Co)) -> (M, Co) f32

For each (row, tap) the neighbour is feats[perm[pos]] with pos the left
binary-search position of the query in sorted_keys, when the key there
equals the query: the first occurrence of a duplicate key wins, the
semantics of fused_conv_apply's exact XLA path (window_conv.py:901-921).
A query < 0 (-2) or SENTINEL is a miss. K is 27 or 3 (the extra conv).

The CUDA kernel (csrc/window_conv.cu) searches the L2-resident key table
inside the kernel, then gathers rows and sums their products in f32.
Both dtypes run the tensor-core cores of csrc/gather_mma.cuh: bf16 (the
planned step's trunk) on mma.sync m16n8k16, f32 (the parity route) as
three TF32 passes on m16n8k8, f32-accurate. res2, down3 and res3 take the
staged core, whose tile resolver searches once per 64 rows and dx triple
(csrc/sorted_search.cuh, 128 keys staged in shared memory) and on its own
only for a tap whose query is not c - 1 + d of its triple's centre c, so
any queries are exact; the extra conv (K=3) the warp core in bf16, one
search per query, and the staged core in f32 (its W, 209 KB in f32, does
not fit the warp core). What bounds it on the H100:
2*hits*Cin*Co FLOPs (Cin*Co >= 4096 on the main path) against the
queries (M*K*4 bytes), the key table and the output (M*Co*4); below ~7
hits per row, as on the bench frame, the bytes bound it. The V x Cin
table (at most 25k x 64 x 2 bytes) fits in the 50 MB L2.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import refuse_autograd
from .block_conv import _ptr, check_conv_args
from .lookup import SENTINEL, sorted_lookup_plain


def keyed_rows(sorted_keys: torch.Tensor, perm: torch.Tensor,
               queries: torch.Tensor) -> torch.Tensor:
    """(M, K) int64 input rows of the queries, V for a miss: sorted_lookup's
    plain version, with a query < 0 as a miss too."""
    q = torch.where(queries < 0, SENTINEL, queries)
    return sorted_lookup_plain(sorted_keys, perm, q).long()


def keyed_conv_plain(sorted_keys, perm, queries, feats, weight) -> torch.Tensor:
    """torch.searchsorted, then pad a zero row, gather, one f32 matmul."""
    V, C = feats.shape
    M, K = queries.shape
    idx = keyed_rows(sorted_keys, perm, queries)
    padded = torch.cat([feats, feats.new_zeros((1, C))]).float()
    return padded[idx].reshape(M, K * C) @ weight.float().reshape(K * C, -1)


@functools.cache
def _launch_fn():
    from .build import library

    fn = library("window_conv").keyed_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def keyed_conv(sorted_keys: torch.Tensor, perm: torch.Tensor,
               queries: torch.Tensor, feats: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    refuse_autograd("keyed_conv", feats, weight)
    if queries.dim() != 2:
        raise ValueError("queries must be (M, K)")
    V = feats.shape[0]
    if sorted_keys.shape != (V,) or perm.shape != (V,):
        raise ValueError("sorted_keys and perm must be (V,) for V feature rows")
    M, K = queries.shape
    check_conv_args(feats, weight, (sorted_keys, perm, queries), K)
    if not feats.is_cuda:
        return keyed_conv_plain(sorted_keys, perm, queries, feats, weight)
    Cin, Co = weight.shape[1], weight.shape[2]
    out = torch.empty((M, Co), dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = _launch_fn()(_ptr(sorted_keys), _ptr(perm), _ptr(queries),
                       _ptr(feats), _ptr(weight), _ptr(out), V, M, K, Cin, Co,
                       int(feats.dtype == torch.bfloat16),
                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"keyed_conv launch failed: CUDA error {err}")
    keyed_conv.launches += 1
    return out


keyed_conv.launches = 0
