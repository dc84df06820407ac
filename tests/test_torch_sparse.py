"""Port's host planner, sparse index builders and the two sparse-conv
kernels' plain versions against the JAX package (CPU).

The JAX side runs its Pallas kernels in interpret mode (pos_conv_apply,
fused_conv_apply) and its exact XLA gather path; inputs are made with
numpy from a seed and fed to both. Per-conv tolerance 1e-4
(tests/test_block_conv.py:52): both sides sum f32 products in another
order.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu import plans as hp
from shasta_tpu.ops import sparse as sp
from shasta_tpu.ops.pallas.block_conv import PosIndex, pos_conv_apply
from shasta_tpu.ops.pallas.block_conv import BLOCK_TILE, GB, block_geometry
from shasta_tpu.ops.pallas.window_conv import collect_coverage_flags

from shasta_tpu_torch import plans as tp
from shasta_tpu_torch.ops import sparse as tsp
from shasta_tpu_torch.ops.kernels.block_conv import rulebook_conv, rulebook_conv_plain
from shasta_tpu_torch.ops.kernels.window_conv import (keyed_conv, keyed_conv_plain,
                                                        keyed_rows)

DOWN = ((3, 3, 3), (2, 2, 2), (1, 1, 1))


def _make_sorted(rng, n, V, C, shape):
    """n unique key-sorted voxels in a V-row table (padding at the tail)."""
    Z, Y, X = shape
    cells = np.sort(rng.choice(Z * Y * X, size=n, replace=False))
    coords = np.zeros((V, 4), np.int32)
    coords[:n, 1], coords[:n, 2], coords[:n, 3] = (
        cells // (Y * X), (cells // X) % Y, cells % X)
    valid = np.arange(V) < n
    feats = rng.normal(size=(V, C)).astype(np.float32) * valid[:, None]
    return coords, valid, feats


def _jst(coords, valid, feats, shape):
    return sp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                           jnp.asarray(valid), shape, 1)


def _tst(coords, valid, feats, shape):
    return tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                            torch.from_numpy(valid), shape, 1)


def _decode_poswords(gp, nwin, V, C):
    """(M, 3G) physical rows (-1 = miss) decoded from the JAX planner's
    PosWords + window bases (ops/pallas/block_conv.py:22-47)."""
    _, H, _, _, _ = block_geometry(V, C)
    pos = gp.pos.astype(np.int64)
    Mp, G = pos.shape
    tile = BLOCK_TILE
    t = np.arange(Mp) // tile
    wsel = (pos >> hp.B_WSEL) & 1
    base = gp.bases.reshape(-1, G, nwin)[t[:, None], np.arange(G)[None], wsel]
    j0 = base.astype(np.int64) * GB * H + (pos & ((1 << hp.REL_BITS) - 1))
    pm1, p0 = (pos >> hp.B_PRES_M1) & 1, (pos >> hp.B_PRES_0) & 1
    rows = np.stack([j0, j0 + pm1, j0 + pm1 + p0], axis=-1)  # (Mp, G, 3)
    ok = np.stack([(pos >> (hp.B_VALID_M1 + d)) & 1 for d in range(3)], axis=-1)
    return np.where(ok > 0, rows, -1).reshape(Mp, 3 * G)


@pytest.mark.parametrize("geom", [DOWN, ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
                                  ((3, 1, 1), (2, 1, 1), (0, 0, 0))])
def test_strided_output_keys_match_jax(rng, geom):
    shape = (9, 30, 30)
    coords, valid, _ = _make_sorted(rng, 700, 768, 1, shape)
    want, wshape = hp.strided_output_keys(coords, valid, *geom, 400, shape, 1,
                                          native=False)
    got, gshape = tp.strided_output_keys(coords, valid, *geom, 400, shape, 1)
    np.testing.assert_array_equal(got, want)
    assert gshape == wshape
    np.testing.assert_array_equal(tp.decode_out_coords(got, gshape, 1)[0],
                                  hp.decode_out_coords(want, wshape, 1)[0])


@pytest.mark.parametrize("C", [16, 32])
def test_subm_rulebook_matches_poswords_and_xla_index(rng, C):
    shape = (8, 40, 40)
    coords, valid, feats = _make_sorted(rng, 700, 1024, C, shape)
    keys = hp.encode_keys_np(coords, valid, shape, 1)
    qc, rm, rp = hp._subm_centers(coords, valid, shape, 1)
    gp = hp._group_plan(keys, qc, rm, rp, C=C, nwin=1, native=False)
    assert gp.ok
    rb = tp.rulebook(tp.encode_keys_np(coords, valid, shape, 1),
                     tp.subm_query_keys(coords, valid, shape, 1))
    V = coords.shape[0]
    np.testing.assert_array_equal(rb, _decode_poswords(gp, 1, V, C)[:V])
    st = _jst(coords, valid, feats, shape)
    xla = np.asarray(sp.build_subm_index(st, table=sp.key_table(st)).gather)
    np.testing.assert_array_equal(rb, np.where(xla == V, -1, xla))


def test_strided_rulebook_matches_nwin2_poswords_and_xla_plan(rng):
    shape = (8, 48, 48)
    coords, valid, feats = _make_sorted(rng, 600, 1024, 16, shape)
    keys = hp.encode_keys_np(coords, valid, shape, 1)
    out_keys, out_shape = hp.strided_output_keys(coords, valid, *DOWN, 512,
                                                 shape, 1, native=False)
    c1, v1 = hp.decode_out_coords(out_keys, out_shape, 1)
    qc, rm, rp = hp._strided_centers(c1, v1, *DOWN, shape, 1)
    gp = hp._group_plan(keys, qc, rm, rp, C=16, nwin=2, native=False)
    assert gp.ok
    rb = tp.rulebook(tp.encode_keys_np(coords, valid, shape, 1),
                     tp.strided_query_keys(c1, v1, *DOWN, shape))
    np.testing.assert_array_equal(rb, _decode_poswords(gp, 2, 1024, 16)[:512])
    st = _jst(coords, valid, feats, shape)
    plan = sp.build_strided_plan(st, *DOWN, 512, table=sp.key_table(st))
    xla = np.asarray(plan.gather)
    np.testing.assert_array_equal(rb, np.where(xla == 1024, -1, xla))


def test_device_query_builders_match_jax(rng):
    shape = (7, 20, 20)
    coords, valid, feats = _make_sorted(rng, 300, 384, 4, shape)
    st = _tst(coords, valid, feats, shape)
    keys = tsp.encode_keys(st.coords, st.valid, shape, 1).numpy()
    np.testing.assert_array_equal(
        keys, np.asarray(sp.encode_keys(jnp.asarray(coords), jnp.asarray(valid), shape, 1)))
    # subm queries resolve to the XLA neighbour index
    skeys, perm = tsp.key_table(st)
    rows = keyed_rows(skeys, perm, tsp.subm_queries(st)).numpy()
    jst = _jst(coords, valid, feats, shape)
    np.testing.assert_array_equal(rows, np.asarray(sp.build_subm_index(jst).gather))
    # strided decode + queries resolve to the XLA strided plan
    out_keys, _ = tp.strided_output_keys(coords, valid, *DOWN, 256, shape, 1)
    oc, ov, oshape = tsp.decode_strided_keys(torch.from_numpy(out_keys.astype(np.int32)),
                                             shape, *DOWN, 1)
    plan = sp.build_strided_plan(jst, *DOWN, 256)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(plan.coords))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(plan.valid))
    q = tsp.strided_queries(oc, ov, shape, *DOWN)
    np.testing.assert_array_equal(keyed_rows(skeys, perm, q).numpy(),
                                  np.asarray(plan.gather))


@pytest.mark.parametrize("C", [5, 16, 32])
def test_rulebook_conv_plain_matches_pos_conv(rng, C):
    shape = (8, 40, 40)
    coords, valid, feats = _make_sorted(rng, 700, 1024, C, shape)
    keys = hp.encode_keys_np(coords, valid, shape, 1)
    qc, rm, rp = hp._subm_centers(coords, valid, shape, 1)
    gp = hp._group_plan(keys, qc, rm, rp, C=C, nwin=1, native=False)
    w = (rng.normal(size=(27, C, 16)) * 0.2).astype(np.float32)
    want = np.asarray(pos_conv_apply(jnp.asarray(feats),
                                     PosIndex(jnp.asarray(gp.pos), jnp.asarray(gp.bases)),
                                     jnp.asarray(w), m_out=1024, interpret=True))
    rb = tp.rulebook(keys, tp.subm_query_keys(coords, valid, shape, 1))
    got = rulebook_conv(torch.from_numpy(feats), torch.from_numpy(rb),
                        torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


def test_rulebook_conv_plain_matches_strided_pos_conv_nwin2(rng):
    shape = (8, 48, 48)
    coords, valid, feats = _make_sorted(rng, 600, 1024, 16, shape)
    keys = hp.encode_keys_np(coords, valid, shape, 1)
    out_keys, out_shape = hp.strided_output_keys(coords, valid, *DOWN, 512,
                                                 shape, 1, native=False)
    c1, v1 = hp.decode_out_coords(out_keys, out_shape, 1)
    qc, rm, rp = hp._strided_centers(c1, v1, *DOWN, shape, 1)
    gp = hp._group_plan(keys, qc, rm, rp, C=16, nwin=2, native=False)
    w = (rng.normal(size=(27, 16, 32)) * 0.2).astype(np.float32)
    want = np.asarray(pos_conv_apply(jnp.asarray(feats),
                                     PosIndex(jnp.asarray(gp.pos), jnp.asarray(gp.bases)),
                                     jnp.asarray(w), m_out=512, interpret=True))
    rb = tp.rulebook(keys, tp.strided_query_keys(c1, v1, *DOWN, shape))
    got = rulebook_conv(torch.from_numpy(feats), torch.from_numpy(rb),
                        torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got[v1], want[v1], atol=1e-4)


@pytest.mark.parametrize("C", [64, 128])
def test_keyed_conv_plain_matches_fused_subm_conv(rng, C):
    """D=3 (27 taps as 9 dx-triples) on the JAX side."""
    shape = (6, 12, 12)
    coords, valid, feats = _make_sorted(rng, 60, 64, C, shape)
    jst = _jst(coords, valid, feats, shape)
    w = (rng.normal(size=(27, C, 64)) * 0.05).astype(np.float32)
    fidx = sp.build_subm_index_fused(jst, sp.key_table(jst))
    with collect_coverage_flags() as cf:
        want = np.asarray(sp.subm_conv_apply(jst, fidx, jnp.asarray(w)).feats)
    assert bool(cf.all_ok())
    st = _tst(coords, valid, feats, shape)
    skeys, perm = tsp.key_table(st)
    got = keyed_conv(skeys, perm, tsp.subm_queries(st), st.feats,
                     torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.mark.parametrize("C", [64, 128])
def test_keyed_conv_plain_matches_fused_extra_conv(rng, C):
    """D=1: the extra conv's (3,1,1) kernel, K=3."""
    shape = (7, 10, 10)
    geom = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
    coords, valid, feats = _make_sorted(rng, 60, 96, C, shape)
    jst = _jst(coords, valid, feats, shape)
    w = (rng.normal(size=(3, C, 128)) * 0.05).astype(np.float32)
    knobs = (256, 384, 1)
    plan = sp.build_strided_plan(jst, *geom, 64, table=sp.key_table(jst),
                                 use_pallas=True, fused=True, knobs=knobs)
    with collect_coverage_flags() as cf:
        want = sp.strided_conv_apply(jst, plan, jnp.asarray(w), use_pallas=True,
                                     knobs=knobs)
    assert bool(cf.all_ok())
    st = _tst(coords, valid, feats, shape)
    skeys, perm = tsp.key_table(st)
    out_keys, _ = tp.strided_output_keys(coords, valid, *geom, 64, shape, 1)
    oc, ov, _ = tsp.decode_strided_keys(torch.from_numpy(out_keys.astype(np.int32)),
                                        shape, *geom, 1)
    q = tsp.strided_queries(oc, ov, shape, *geom)
    got = keyed_conv(skeys, perm, q, st.feats, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(oc.numpy(), np.asarray(want.coords))
    np.testing.assert_allclose(got * ov.numpy()[:, None], np.asarray(want.feats),
                               atol=1e-4)


def test_keyed_conv_first_duplicate_wins_any_row_order(rng):
    """Duplicate keys and a shuffled table: the first physical occurrence
    of a key is gathered, exactly like fused_conv_apply's XLA path."""
    V, M, C = 40, 12, 4
    keys = rng.integers(0, 30, size=V).astype(np.int32)
    feats = rng.normal(size=(V, C)).astype(np.float32)
    q = rng.integers(-2, 32, size=(M, 3)).astype(np.int32)
    w = rng.normal(size=(3, C, 16)).astype(np.float32)
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    got = keyed_conv(torch.from_numpy(keys[perm]), torch.from_numpy(perm),
                     torch.from_numpy(q), torch.from_numpy(feats),
                     torch.from_numpy(w)).numpy()
    first = {}
    for i, k in enumerate(keys):
        first.setdefault(int(k), i)
    want = np.zeros((M, 16), np.float32)
    for m in range(M):
        for k in range(3):
            row = first.get(int(q[m, k]))
            if row is not None:
                want[m] += feats[row] @ w[k]
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_cpu_equal_plain_and_check_arguments(rng, dtype):
    V, M, K, C = 50, 20, 27, 16
    feats = torch.from_numpy(rng.normal(size=(V, C)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(K, C, 32)).astype(np.float32)).to(dtype)
    nbr = torch.from_numpy(rng.integers(-1, V + 3, size=(M, K)).astype(np.int32))
    out = rulebook_conv(feats, nbr, w)
    assert out.dtype == torch.float32 and out.shape == (M, 32)
    torch.testing.assert_close(out, rulebook_conv_plain(feats, nbr, w))
    skeys = torch.arange(V, dtype=torch.int32) * 2
    perm = torch.arange(V, dtype=torch.int32)
    torch.testing.assert_close(keyed_conv(skeys, perm, nbr, feats, w),
                               keyed_conv_plain(skeys, perm, nbr, feats, w))
    with pytest.raises(TypeError):
        rulebook_conv(feats, nbr.long(), w)
    with pytest.raises(TypeError):
        rulebook_conv(feats.float() if dtype == torch.bfloat16 else feats.bfloat16(), nbr, w)
    with pytest.raises(ValueError):
        rulebook_conv(feats, nbr[:, :3], w)
