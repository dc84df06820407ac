"""The B=1 keyed path's queries and keyed_conv's strided case against the
JAX package (CPU).

keyed_conv's tensor-core launch resolves each dx group of 3 taps by one
search for its centre (csrc/window_conv.cu); it is exact for any queries,
but fast only where the queries have the triple shape checked here. The
JAX side of the conv runs its fused Pallas path in interpret mode; inputs
are made with numpy from a seed. Per-conv tolerance 1e-4
(tests/test_block_conv.py:52).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.ops import sparse as sp
from shasta_tpu.ops.pallas.window_conv import collect_coverage_flags

from shasta_tpu_torch import plans as tp
from shasta_tpu_torch.ops import sparse as tsp
from shasta_tpu_torch.ops.kernels.lookup import SENTINEL
from shasta_tpu_torch.ops.kernels.window_conv import keyed_conv

from test_torch_sparse import DOWN, _jst, _make_sorted, _tst

DOWN3 = ((3, 3, 3), (2, 2, 2), (0, 1, 1))


@pytest.mark.parametrize("geom", [None, DOWN, DOWN3], ids=["subm", "down", "down3"])
def test_keyed_queries_come_in_dx_triples(rng, geom):
    """Every dx group of the port's subm_queries / strided_queries is a
    live centre c with sides in {c-1, SENTINEL} and {c+1, SENTINEL}, or
    three SENTINELs; both kinds of side, and dead groups, occur."""
    shape = (9, 30, 31)  # odd X: a strided row's dx = +1 tap can leave the grid
    coords, valid, feats = _make_sorted(rng, 1500, 1600, 4, shape)
    st = _tst(coords, valid, feats, shape)
    if geom is None:
        q = tsp.subm_queries(st)
    else:
        out_keys, _ = tp.strided_output_keys(coords, valid, *geom, 700, shape, 1)
        oc, ov, _ = tsp.decode_strided_keys(torch.from_numpy(out_keys.astype(np.int32)),
                                            shape, *geom, 1)
        q = tsp.strided_queries(oc, ov, shape, *geom)
    g = q.long().reshape(q.shape[0], 9, 3)
    c, live = g[..., 1], g[..., 1] != SENTINEL
    for d, side in ((0, c - 1), (2, c + 1)):
        on_grid = g[..., d] == side
        assert bool((on_grid | (g[..., d] == SENTINEL))[live].all())
        assert bool(on_grid[live].any()) and bool((~on_grid)[live].any())
    assert bool((g[~live] == SENTINEL).all()) and bool((~live).any())


@pytest.mark.parametrize("C", [64, 128])
def test_keyed_conv_plain_matches_fused_strided_conv_down3(rng, C):
    """down3's geometry (z unpadded), D=3 on the JAX side."""
    shape = (7, 12, 12)
    coords, valid, feats = _make_sorted(rng, 150, 192, C, shape)
    jst = _jst(coords, valid, feats, shape)
    w = (rng.normal(size=(27, C, 128)) * 0.05).astype(np.float32)
    knobs = (256, 384, 1)
    plan = sp.build_strided_plan(jst, *DOWN3, 64, table=sp.key_table(jst),
                                 use_pallas=True, fused=True, knobs=knobs)
    with collect_coverage_flags() as cf:
        want = sp.strided_conv_apply(jst, plan, jnp.asarray(w), use_pallas=True,
                                     knobs=knobs)
    assert bool(cf.all_ok())
    st = _tst(coords, valid, feats, shape)
    skeys, perm = tsp.key_table(st)
    out_keys, _ = tp.strided_output_keys(coords, valid, *DOWN3, 64, shape, 1)
    oc, ov, _ = tsp.decode_strided_keys(torch.from_numpy(out_keys.astype(np.int32)),
                                        shape, *DOWN3, 1)
    q = tsp.strided_queries(oc, ov, shape, *DOWN3)
    got = keyed_conv(skeys, perm, q, st.feats, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(oc.numpy(), np.asarray(want.coords))
    assert ov.numpy().any()
    np.testing.assert_allclose(got * ov.numpy()[:, None], np.asarray(want.feats),
                               atol=1e-4)
