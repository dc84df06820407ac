"""The plain versions of the port's two scene-batched kernels against the
JAX package (CPU): `sorted_lookup` against `windowed_lookup` /
`windowed_lookup_triple` (Pallas, interpret mode) and `_xla_lookup`,
exactly; `gather_conv` against `_gathered_matmul` (XLA) and
`windowed_gather_matmul` (Pallas, interpret mode) at f32 atol 1e-4 (both
sides sum f32 products in another order, tests/test_block_conv.py:52).
Inputs are made with numpy from a seed and fed to both sides.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.ops import sparse as sp
from shasta_tpu.ops.pallas.window_conv import (SENTINEL, _xla_lookup, windowed_gather_matmul,
                                               windowed_lookup, windowed_lookup_triple)

from shasta_tpu_torch.ops.kernels.gather_conv import gather_conv, gather_conv_plain
from shasta_tpu_torch.ops.kernels.lookup import sorted_lookup, sorted_lookup_plain


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lookup_table(rng, V=512, tail=40):
    """Ascending keys with a duplicate filler tail, a non-identity perm
    (the inputs of tests/test_pallas_sparse.py:254-275)."""
    keys = np.sort(rng.choice(5000, size=V - tail, replace=False)).astype(np.int32)
    keys = np.sort(np.concatenate([keys, np.full(tail, 4999, np.int32)]))
    return keys, rng.permutation(V).astype(np.int32)


def _monotone_queries(rng, keys, n=300, K=9, nval=472):
    """Per-column ascending queries near real keys, SENTINELs, an edge key."""
    qs = []
    for _ in range(K):
        q = np.sort(keys[rng.integers(0, nval, n)].astype(np.int64)
                    + rng.integers(-2, 3, n)).astype(np.int32)
        q[rng.random(n) < 0.05] = SENTINEL
        qs.append(q)
    q = np.stack(qs, 1)
    q[0, 0] = 0
    q[1, 1] = keys[0]
    return q


def test_plain_lookup_matches_windowed_and_xla_lookup(rng):
    keys, perm = _lookup_table(rng)
    q = _monotone_queries(rng, keys)
    got = sorted_lookup(_t(keys), _t(perm), _t(q), "plain").numpy()
    args = (jnp.asarray(keys), jnp.asarray(perm), jnp.asarray(q))
    np.testing.assert_array_equal(got, np.asarray(_xla_lookup(*args)))
    np.testing.assert_array_equal(got, np.asarray(windowed_lookup(*args)))
    assert (got == keys.shape[0]).any() and (got < keys.shape[0]).any()


def test_plain_lookup_first_duplicate_wins_in_plain_and_triple_mode(rng):
    """Queried duplicate keys resolve to the first occurrence
    (tests/test_pallas_sparse.py:343-369), in plain and in triple mode."""
    V = 640
    base = np.sort(rng.choice(30000, size=V - 60, replace=False))
    dups = rng.choice(base, size=60, replace=False)
    keys = np.sort(np.concatenate([base, dups])).astype(np.int32)
    perm = rng.permutation(V).astype(np.int32)
    q = np.stack([np.sort(np.concatenate([dups, keys[rng.integers(0, V, 240)]]))
                  for _ in range(3)], 1).astype(np.int32)
    args = (jnp.asarray(keys), jnp.asarray(perm), jnp.asarray(q))
    got = sorted_lookup(_t(keys), _t(perm), _t(q), "plain").numpy()
    np.testing.assert_array_equal(got, np.asarray(windowed_lookup(*args)))
    got3 = sorted_lookup(_t(keys), _t(perm), _t(q), "triple").numpy()
    assert got3.shape == (q.shape[0], 9)
    np.testing.assert_array_equal(got3, np.asarray(windowed_lookup_triple(*args)))


def test_plain_lookup_triple_mode_matches_windowed_triple(rng):
    """Centres with SENTINELs and with neighbours on both sides; a SENTINEL
    centre misses on all three probes."""
    keys, perm = _lookup_table(rng)
    q = _monotone_queries(rng, keys, K=3)
    args = (jnp.asarray(keys), jnp.asarray(perm), jnp.asarray(q))
    got = sorted_lookup(_t(keys), _t(perm), _t(q), "triple").numpy()
    np.testing.assert_array_equal(got, np.asarray(windowed_lookup_triple(*args)))
    real = q != SENTINEL
    q3 = np.stack([np.where(real, q - 1, SENTINEL), q, np.where(real, q + 1, SENTINEL)],
                  axis=-1).reshape(q.shape[0], -1)
    np.testing.assert_array_equal(got, np.asarray(_xla_lookup(args[0], args[1],
                                                              jnp.asarray(q3))))
    assert (got.reshape(-1, 3)[~real.reshape(-1)] == keys.shape[0]).all()


def test_plain_lookup_identity_mode_matches_compaction_lookup(rng):
    """The strided compaction: slot j is the first position where
    cumsum(head) == j + 1 (ops/sparse.py:410-425)."""
    s = np.sort(rng.integers(0, 400, size=1500)).astype(np.int32)
    s[-100:] = SENTINEL
    head = (s != np.concatenate([[-1], s[:-1]])) & (s != SENTINEL)
    ch = np.cumsum(head).astype(np.int32)
    slots = np.arange(1, 600, dtype=np.int32)[:, None]  # beyond the uniques too
    got = sorted_lookup(_t(ch), None, _t(slots), "identity").numpy()
    want = windowed_lookup(jnp.asarray(ch), jnp.arange(ch.shape[0], dtype=jnp.int32),
                           jnp.asarray(slots), identity_perm=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    n = int(head.sum())
    np.testing.assert_array_equal(s[got[:n, 0]], s[head])
    assert (got[n:] == ch.shape[0]).all()


def test_lookup_wrapper_checks_its_arguments(rng):
    keys, perm = _lookup_table(rng, V=64, tail=4)
    q = _t(keys[:10, None].copy())
    np.testing.assert_array_equal(sorted_lookup(_t(keys), _t(perm), q).numpy(),
                                  sorted_lookup_plain(_t(keys), _t(perm), q).numpy())
    with pytest.raises(ValueError):
        sorted_lookup(_t(keys), None, q, "plain")
    with pytest.raises(ValueError):
        sorted_lookup(_t(keys), _t(perm), q, "identity")
    with pytest.raises(ValueError):
        sorted_lookup(_t(keys), _t(perm), q, "nearest")
    with pytest.raises(TypeError):
        sorted_lookup(_t(keys).long(), _t(perm), q)
    with pytest.raises(ValueError):
        sorted_lookup(_t(keys), _t(perm), q[:, 0])


def _gather_table(rng, V, M, K, miss=0.15):
    """Per-column ascending rows (the windowed kernel's contract), misses
    = V, and one all-miss tile of 128 rows."""
    g = np.sort(rng.integers(0, V, size=(M, K)), axis=0)
    g[rng.random((M, K)) < miss] = V
    g[128:256] = V
    return g.astype(np.int32)


@pytest.mark.parametrize("C,Co,K", [(16, 32, 27), (64, 64, 27), (128, 128, 3)])
def test_gather_conv_plain_matches_xla_and_windowed_conv(rng, C, Co, K):
    V, M = 700, 384
    feats = rng.normal(size=(V, C)).astype(np.float32)
    w = (rng.normal(size=(K, C, Co)) / np.sqrt(K * C)).astype(np.float32)
    g = _gather_table(rng, V, M, K)
    got = gather_conv(_t(feats), _t(g), _t(w)).numpy()
    assert np.abs(got).max() > 0 and np.abs(got[128:256]).max() == 0
    xla = np.asarray(sp._gathered_matmul(jnp.asarray(feats), jnp.asarray(g),
                                         jnp.asarray(w), None, use_pallas=False))
    np.testing.assert_allclose(got, xla, atol=1e-4)
    win = np.asarray(windowed_gather_matmul(jnp.asarray(feats), jnp.asarray(g),
                                            jnp.asarray(w)))
    np.testing.assert_allclose(got, win, atol=1e-4)


def test_gather_conv_negative_rows_are_misses(rng):
    """-1 (the zero pad row of the XLA gather) and any row < 0 add nothing."""
    V, M, C, K = 90, 40, 16, 27
    feats = rng.normal(size=(V, C)).astype(np.float32)
    w = rng.normal(size=(K, C, 16)).astype(np.float32)
    g = rng.integers(-1, V + 1, size=(M, K)).astype(np.int32)
    got = gather_conv(_t(feats), _t(g), _t(w)).numpy()
    xla = np.asarray(sp._gathered_matmul(jnp.asarray(feats), jnp.asarray(g),
                                         jnp.asarray(w), None, use_pallas=False))
    np.testing.assert_allclose(got, xla, atol=1e-4)
    g2 = np.where(g < 0, -7, g).astype(np.int32)
    np.testing.assert_array_equal(gather_conv(_t(feats), _t(g2), _t(w)).numpy(), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_conv_wrapper_on_cpu_equals_plain_and_checks_arguments(rng, dtype):
    V, M, K, C = 50, 20, 27, 16
    feats = _t(rng.normal(size=(V, C)).astype(np.float32)).to(dtype)
    w = _t(rng.normal(size=(K, C, 32)).astype(np.float32)).to(dtype)
    g = _t(rng.integers(-1, V + 3, size=(M, K)).astype(np.int32))
    out = gather_conv(feats, g, w)
    assert out.dtype == torch.float32 and out.shape == (M, 32)
    torch.testing.assert_close(out, gather_conv_plain(feats, g, w))
    with pytest.raises(TypeError):
        gather_conv(feats, g.long(), w)
    with pytest.raises(ValueError):
        gather_conv(feats, g[:, :3], w)
