"""sorted_lookup: the port of the TPU kernel `_lookup_kernel`
(shasta_tpu/ops/pallas/window_conv.py:170, launched by `_lookup_call`
:283, wrapped by `windowed_lookup` :342 and `windowed_lookup_triple` :431).

    sorted_lookup(sorted_keys (V,) int32, perm (V,) int32 | None,
                  queries (M, G) int32, mode) -> int32

Each query resolves to perm[searchsorted_left(sorted_keys, q)] when the key
there equals q, and to V on a miss or a SENTINEL query: the first
occurrence of a duplicate key wins (`_xla_lookup`, window_conv.py:382-390).
Modes:
- "plain": (M, G) results;
- "triple": each query is the centre c of a unit-spaced dx triplet; the
  result is (M, 3G), the lookups of c-1, c, c+1 in (g, dx) raster order.
  A SENTINEL centre misses on all three; the caller's in-range mask kills
  a ±1 probe that wrapped into a neighbouring row (window_conv.py:458-465);
- "identity": perm is None and the result is the table position itself
  (the strided compaction over a cumsum table, ops/sparse.py:410-425).

The CUDA kernel (csrc/lookup.cu) gives each warp 64 consecutive rows of
one query column: a 32-ary warp search finds the lower bound of their
smallest probe, the 128 keys from there are staged in shared memory, and
each lane finishes its searches there when the largest probe's bound lies
among them (else in the L2-resident table between the two bounds); triple
mode searches once per centre, for c-1, and advances to c and c+1. What
bounds it on the H100: bytes, the queries read, the results written and
the table read once.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import refuse_autograd

SENTINEL = 2**31 - 1
MODES = ("plain", "triple", "identity")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def triple_queries(centers: torch.Tensor) -> torch.Tensor:
    """(M, G) centres -> (M, 3G) probes c-1, c, c+1 in (g, dx) order; a
    SENTINEL centre, or a probe outside int32, becomes SENTINEL."""
    c = centers.long()
    q = torch.stack([c - 1, c, c + 1], dim=-1)
    bad = (c == SENTINEL)[..., None] | (q >= SENTINEL) | (q < -2**31)
    return torch.where(bad, SENTINEL, q).to(torch.int32).reshape(c.shape[0], -1)


def sorted_lookup_plain(sorted_keys: torch.Tensor, perm: torch.Tensor | None,
                        queries: torch.Tensor, mode: str = "plain") -> torch.Tensor:
    """torch.searchsorted, then a gather and an equality test."""
    q = triple_queries(queries) if mode == "triple" else queries
    V = sorted_keys.shape[0]
    flat = q.reshape(-1).contiguous()
    pos = torch.searchsorted(sorted_keys.contiguous(), flat, side="left")
    pos = pos.clamp(max=V - 1)
    found = (sorted_keys[pos] == flat) & (flat != SENTINEL)
    val = pos if perm is None else perm[pos].long()
    return torch.where(found, val, V).to(torch.int32).reshape(q.shape)


@functools.cache
def _launch_fn():
    from .build import library

    fn = library("lookup").sorted_lookup_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(sorted_keys, perm, queries, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if (perm is None) != (mode == "identity"):
        raise ValueError("perm is None exactly in identity mode")
    if sorted_keys.dim() != 1 or queries.dim() != 2 or sorted_keys.shape[0] < 1:
        raise ValueError("sorted_keys must be (V,) with V >= 1 and queries (M, G)")
    if perm is not None and perm.shape != sorted_keys.shape:
        raise ValueError("perm must be (V,) like sorted_keys")
    for t in (sorted_keys, queries) + (() if perm is None else (perm,)):
        if t.dtype != torch.int32:
            raise TypeError(f"lookup tensors must be int32, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError("all inputs must lie on one device")
        if queries.is_cuda and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if not (queries.is_cuda or queries.device.type == "cpu"):
        raise ValueError(f"unsupported device {queries.device}")


def sorted_lookup(sorted_keys: torch.Tensor, perm: torch.Tensor | None,
                  queries: torch.Tensor, mode: str = "plain") -> torch.Tensor:
    refuse_autograd("sorted_lookup", sorted_keys, perm, queries)
    _check(sorted_keys, perm, queries, mode)
    if not queries.is_cuda:
        return sorted_lookup_plain(sorted_keys, perm, queries, mode)
    M, G = queries.shape
    D = 3 if mode == "triple" else 1
    out = torch.empty((M, D * G), dtype=torch.int32, device=queries.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = _launch_fn()(_ptr(sorted_keys), _ptr(perm), _ptr(queries), _ptr(out),
                       sorted_keys.shape[0], M, G, int(D == 3),
                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sorted_lookup launch failed: CUDA error {err}")
    sorted_lookup.launches += 1
    return out


sorted_lookup.launches = 0
