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


INT_MIN, INT_MAX = -2**31, 2**31 - 1


def _shortcut_case(rng, case):
    """(keys, perm, centres (M, 3)) aimed at one shortcut of csrc/lookup.cu:
    a duplicate run that starts at c-1 or at c (the triple's first search
    lands on a run and c, c+1 advance over it), a frame's filler run right
    after its last cell (c+1 of that cell is the filler key, ~V/lanes long),
    or probes at the int32 edges (c-1 or c+1 outside int32, or SENTINEL)."""
    if case == "int32_edges":
        keys = np.array([INT_MIN, INT_MIN, INT_MIN + 1, -5, 0, 7, INT_MAX - 2, INT_MAX - 1,
                         INT_MAX - 1, INT_MAX], np.int64)
        cent = np.array([INT_MIN, INT_MIN + 1, INT_MIN + 2, -4, 1, 6, INT_MAX - 3,
                         INT_MAX - 2, INT_MAX - 1, INT_MAX], np.int64)
    elif case == "filler_after_last_cell":
        cells, lanes = 5000, 3  # frame b owns keys b*(cells+1) .. b*(cells+1)+cells
        parts = []
        for b in range(lanes):
            real = np.sort(rng.choice(cells - 1, size=300, replace=False))
            parts += [b * (cells + 1) + real, [b * (cells + 1) + cells - 1],  # the last cell
                      np.full(200, b * (cells + 1) + cells)]  # the filler run
        keys = np.sort(np.concatenate(parts))
        last = np.arange(lanes) * (cells + 1) + cells - 1
        cent = np.concatenate([np.repeat(last, 20), keys[rng.integers(0, keys.size, 240)]])
    else:
        x = 1000
        base = rng.choice(np.setdiff1d(np.arange(3000), [x - 1, x, x + 1]), size=400,
                          replace=False)
        keys = np.sort(np.concatenate([base, np.full(60, x)]))
        near = [x + 1, x + 2] if case == "dup_at_c_minus_1" else [x, x - 1]
        cent = np.concatenate([np.repeat(near, 40), keys[rng.integers(0, keys.size, 160)]
                               + rng.integers(-1, 2, 160)])
    cent = np.stack([np.sort(rng.permutation(cent)) for _ in range(3)], 1)
    return (keys.astype(np.int32), rng.permutation(keys.size).astype(np.int32),
            cent.astype(np.int32))


def _triple_probes(c):
    """(M, 3G) probes c-1, c, c+1 in (g, dx) order as the JAX XLA path builds
    them, computed in int64: a SENTINEL centre or a probe outside int32
    becomes SENTINEL."""
    c = c.astype(np.int64)
    q = np.stack([c - 1, c, c + 1], axis=-1)
    bad = (c == SENTINEL)[..., None] | (q >= SENTINEL) | (q < INT_MIN)
    return np.where(bad, SENTINEL, q).astype(np.int32).reshape(c.shape[0], -1)


@pytest.mark.parametrize("order", ["ascending", "shuffled"])
@pytest.mark.parametrize("case", ["dup_at_c_minus_1", "dup_at_c", "filler_after_last_cell",
                                  "int32_edges"])
def test_plain_lookup_on_the_kernels_shortcuts_matches_xla_lookup(rng, case, order):
    """All three modes on the inputs the kernel's shortcuts target, in key
    order (the kernel finds a task's probes among the keys it staged) and
    shuffled (it searches the global table), against `_xla_lookup`; the
    ascending triple also against `windowed_lookup_triple` away from the
    int32 edges."""
    keys, perm, cent = _shortcut_case(rng, case)
    if order == "shuffled":
        cent = cent[rng.permutation(cent.shape[0])]
    V, jk, jp = keys.shape[0], jnp.asarray(keys), jnp.asarray(perm)
    got = sorted_lookup(_t(keys), _t(perm), _t(cent), "triple").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_xla_lookup(jk, jp, jnp.asarray(_triple_probes(cent)))))
    if order == "ascending" and case != "int32_edges":
        np.testing.assert_array_equal(
            got, np.asarray(windowed_lookup_triple(jk, jp, jnp.asarray(cent))))
    got1 = sorted_lookup(_t(keys), _t(perm), _t(cent), "plain").numpy()
    np.testing.assert_array_equal(got1, np.asarray(_xla_lookup(jk, jp, jnp.asarray(cent))))
    got_id = sorted_lookup(_t(keys), None, _t(cent), "identity").numpy()
    np.testing.assert_array_equal(got_id, np.asarray(_xla_lookup(
        jk, jnp.arange(V, dtype=jnp.int32), jnp.asarray(cent))))
    # the run's first occurrence answers every probe of it
    first = {int(k): int(np.searchsorted(keys, k)) for k in np.unique(keys)}
    for probe, r in zip(_triple_probes(cent).reshape(-1), got.reshape(-1)):
        want = first.get(int(probe), V) if probe != SENTINEL else V
        assert r == (perm[want] if want < V else V)


def _conv_table(rng, pattern, V, M, K):
    """(M, K) gather rows with the hit pattern of a sparse stage: only the
    centre tap hits (stage 0 of a synthetic frame), about 3 hits per row,
    or every tap; misses are V or -1; rows 128-255 all miss (a 128-row and
    two 64-row tiles with no hit)."""
    g = rng.integers(0, V, size=(M, K))
    if pattern == "centre_only":
        keep = np.zeros((M, K), bool)
        keep[:, K // 2] = True
    elif pattern == "three_per_row":
        keep = rng.random((M, K)) < 3.0 / K
    else:
        keep = np.ones((M, K), bool)
    g = np.where(keep, g, np.where(rng.random((M, K)) < 0.5, V, -1))
    g[128:256] = V
    return g.astype(np.int32)


@pytest.mark.parametrize("C,Co,K", [(5, 16, 27), (128, 128, 3)])
@pytest.mark.parametrize("pattern", ["centre_only", "three_per_row", "all_taps"])
def test_gather_conv_plain_on_sparse_hit_tables_matches_xla(rng, pattern, C, Co, K):
    """The hit patterns the tensor-core kernel compacts, M = 333 (not a
    multiple of its 64- or 128-row tiles), against `_gathered_matmul` (XLA)
    at f32 atol 1e-4."""
    V, M = 500, 333
    feats = rng.normal(size=(V, C)).astype(np.float32)
    w = (rng.normal(size=(K, C, Co)) / np.sqrt(K * C)).astype(np.float32)
    g = _conv_table(rng, pattern, V, M, K)
    got = gather_conv(_t(feats), _t(g), _t(w)).numpy()
    assert np.abs(got[128:256]).max() == 0 and np.abs(got[256:]).max() > 0
    xla = np.asarray(sp._gathered_matmul(jnp.asarray(feats), jnp.asarray(np.where(g < 0, V, g)),
                                         jnp.asarray(w), None, use_pallas=False))
    np.testing.assert_allclose(got, xla, atol=1e-4)
