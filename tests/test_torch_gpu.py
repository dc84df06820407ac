"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip elsewhere; the file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from shasta_tpu_torch import resolve_device


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """Both CUDA kernels against their plain versions on the card, f32
    (TF32 off) at 1e-4 and bf16 at 2e-2 (python3 chip_smoke.py runs the
    same comparison at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.block_conv import rulebook_conv, rulebook_conv_plain
    from shasta_tpu_torch.ops.kernels.window_conv import keyed_conv, keyed_conv_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    V, M = 3000, 2000
    for cin, co, K in ((5, 16, 27), (16, 32, 27), (64, 128, 27), (128, 128, 3)):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            f = torch.randn(V, cin, generator=g).to(dev, dt)
            w = (torch.randn(K, cin, co, generator=g) * 0.1).to(dev, dt)
            nbr = torch.randint(-1, V, (M, K), generator=g, dtype=torch.int32).to(dev)
            torch.testing.assert_close(rulebook_conv(f, nbr, w),
                                       rulebook_conv_plain(f, nbr, w), atol=tol, rtol=tol)
            keys = torch.sort(torch.randint(0, 4 * V, (V,), generator=g,
                                            dtype=torch.int32))[0].to(dev)
            perm = torch.randperm(V, generator=g).to(torch.int32).to(dev)
            q = torch.randint(-2, 4 * V, (M, K), generator=g, dtype=torch.int32).to(dev)
            torch.testing.assert_close(keyed_conv(keys, perm, q, f, w),
                                       keyed_conv_plain(keys, perm, q, f, w),
                                       atol=tol, rtol=tol)


def _voxels(g, shape, n, V):
    """n distinct cells of `shape`, key-sorted, in a V-row B=1 tensor whose
    tail rows are padding (the filler key's run), on the CPU."""
    from shasta_tpu_torch.ops import sparse as sp

    Z, Y, X = shape
    cells = torch.sort(torch.randperm(Z * Y * X, generator=g)[:n])[0]
    coords = torch.zeros((V, 4), dtype=torch.int32)
    coords[:n, 1], coords[:n, 2], coords[:n, 3] = cells // (Y * X), (cells // X) % Y, cells % X
    return sp.SparseTensor(None, coords, torch.arange(V) < n, shape, 1)


@pytest.mark.gpu
def test_b1_conv_kernels_on_their_cores_on_the_card():
    """keyed_conv and rulebook_conv against their plain versions on the
    card, f32 (TF32 off) at 1e-4 and bf16 at 2e-2; a second bf16 run gives
    the same bits. keyed_conv's queries are the B=1 step's: subm_queries and
    strided_queries (DOWN, down3's (0,1,1) padding, the extra conv's K=3)
    of key-sorted voxels with a filler run at the tail, in key order (the
    staged core's triple path) and shuffled, over a table with duplicate
    keys whose physical rows are shuffled; M is not a multiple of 128, and
    the widths reach both tensor-core cores.
    rulebook_conv takes the sparse hit patterns of gather_conv's test,
    with one all-miss tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops import sparse as sp
    from shasta_tpu_torch.ops.kernels.block_conv import rulebook_conv, rulebook_conv_plain
    from shasta_tpu_torch.ops.kernels.gather_conv import MMA_CORES, mma_core
    from shasta_tpu_torch.ops.kernels.window_conv import keyed_conv, keyed_conv_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def check(kern, plain, idx, cin, co, K, V, tag):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            f = torch.randn(V, cin, generator=g).to(dev, dt)
            w = (torch.randn(K, cin, co, generator=g) * 0.1).to(dev, dt)
            got = kern(*idx, f, w)
            torch.testing.assert_close(got, plain(*idx, f, w), atol=tol, rtol=tol)
            if dt == torch.bfloat16:
                assert torch.equal(kern(*idx, f, w), got), tag
        return got

    cores = set()
    shape, n, V = (16, 72, 72), 18000, 18500
    st = _voxels(g, shape, n, V)
    phys = torch.randperm(V, generator=g)  # physical row j holds sorted row phys[j]
    coords, at = st.coords[phys].clone(), torch.argsort(phys)
    coords[at[100:140]] = st.coords[:40]  # 40 keys on two physical rows each
    table = [t.to(dev) for t in sp.key_table(st._replace(coords=coords, valid=st.valid[phys]))]
    cases = [("subm", sp.subm_queries(st), ((64, 64), (64, 128), (128, 128), (16, 32)))]
    for geom in (((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
                 ((3, 1, 1), (2, 1, 1), (0, 0, 0))):
        plan = sp.build_strided_plan(st, *geom, 4999, sp.key_table(st))
        q = sp.strided_queries(plan.coords, plan.valid, shape, *geom)
        cases.append((f"strided {geom}", q, ((64, 128), (128, 128))))
    for tag, q, widths in cases:
        M, K = q.shape
        assert M % 128
        for order, qq in (("key order", q), ("shuffled", q[torch.randperm(M, generator=g)])):
            for cin, co in widths:
                cores.add(mma_core(K, cin, co))
                check(keyed_conv, keyed_conv_plain, (*table, qq.to(dev)), cin, co, K, V,
                      (tag, order, cin, co))
    assert cores == set(MMA_CORES), cores

    V, M = 3000, 1999
    for cin, co in ((5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 128)):
        for pattern in ("centre_only", "three_per_row", "all_taps"):
            nbr = torch.randint(0, V, (M, 27), generator=g, dtype=torch.int32)
            if pattern == "centre_only":
                keep = torch.zeros((M, 27), dtype=torch.bool)
                keep[:, 13] = True
            else:
                keep = torch.rand((M, 27), generator=g) < (3.0 / 27 if pattern ==
                                                          "three_per_row" else 2.0)
            miss = torch.where(torch.rand((M, 27), generator=g) < 0.5, V, -1).to(torch.int32)
            nbr = torch.where(keep, nbr, miss)
            nbr[256:512] = -1  # one warp-core block and two staged tiles with no hit
            got = check(lambda i, f, w: rulebook_conv(f, i, w),
                        lambda i, f, w: rulebook_conv_plain(f, i, w),
                        (nbr.to(dev),), cin, co, 27, V, (cin, co, pattern))
            assert got[256:512].abs().max() == 0


@pytest.mark.gpu
def test_scene_batched_kernels_match_plain_versions_on_the_card():
    """sorted_lookup in its three modes (exact) and gather_conv, f32 (TF32
    off) at 1e-4 and bf16 at 2e-2, against their plain versions on the
    card (chip_smoke.py phase 3b runs them at the 4-lane step's shapes).
    Lookups: queries in key order (a warp finds its probes among the keys
    it staged in shared memory) and shuffled (it searches the global
    table), over a table with a filler run and the int32 edges. Convs: the sparse hit patterns the
    tensor-core kernel compacts, M not a multiple of its tile; a second
    bf16 run gives the same bits (no atomics in the sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.gather_conv import gather_conv, gather_conv_plain
    from shasta_tpu_torch.ops.kernels.lookup import sorted_lookup, sorted_lookup_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    V, M = 3000, 2000
    keys = torch.sort(torch.randint(0, 2 * V, (V,), generator=g, dtype=torch.int32))[0]
    keys[-200:] = 2 * V  # a run of equal filler keys
    keys[:2] = torch.tensor([-2**31, -2**31 + 1], dtype=torch.int32)
    keys[-3:] = torch.tensor([2**31 - 2, 2**31 - 1, 2**31 - 1], dtype=torch.int32)
    perm = torch.randperm(V, generator=g).to(torch.int32)
    q = torch.randint(-2, 2 * V + 2, (M, 9), generator=g, dtype=torch.int32)
    q[::7] = 2**31 - 1
    q[1::97] = 2 * V - 1  # c + 1 is the filler key
    q[3, :3] = torch.tensor([-2**31, -2**31 + 1, 2**31 - 2], dtype=torch.int32)
    ascending = torch.sort(q, dim=0)[0]
    for order, qq in (("ascending", ascending), ("shuffled", q)):
        for mode, p in (("plain", perm), ("triple", perm), ("identity", None)):
            args = (keys, p, qq, mode)
            want = sorted_lookup_plain(*args)
            got = sorted_lookup(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
            assert torch.equal(got.cpu(), want), (order, mode)
    M = 1999
    for cin, co, K in ((5, 16, 27), (16, 32, 27), (64, 128, 27), (128, 128, 27),
                       (128, 128, 3)):
        for pattern in ("centre_only", "three_per_row", "all_taps"):
            rows = torch.randint(0, V, (M, K), generator=g, dtype=torch.int32)
            if pattern == "centre_only":
                keep = torch.zeros((M, K), dtype=torch.bool)
                keep[:, K // 2] = True
            else:
                keep = torch.rand((M, K), generator=g) < (3.0 / K if pattern ==
                                                         "three_per_row" else 2.0)
            miss = torch.where(torch.rand((M, K), generator=g) < 0.5, V, -1).to(torch.int32)
            rows = torch.where(keep, rows, miss)
            rows[128:256] = V  # one 128-row tile and two 64-row tiles with no hit
            rows = rows.to(dev)
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                f = torch.randn(V, cin, generator=g).to(dev, dt)
                w = (torch.randn(K, cin, co, generator=g) * 0.1).to(dev, dt)
                got = gather_conv(f, rows, w)
                torch.testing.assert_close(got, gather_conv_plain(f, rows, w), atol=tol,
                                           rtol=tol)
                assert got[128:256].abs().max() == 0
                if dt == torch.bfloat16:
                    assert torch.equal(gather_conv(f, rows, w), got), (cin, co, K, pattern)


@pytest.mark.gpu
def test_block_extract_matches_its_plain_version_on_the_card():
    """block_extract in all five variants against its plain version on the
    card, f32 (TF32 off) at atol/rtol 1e-5, with a second run giving the same
    bits: both probe geometries at V=8192 on rows that hit, the dup recipe's
    overlapping windows, and what the kernel's tiling could break: tiles of
    32, 64 and 256 rows (blocks take 64 rows, 128 for ohonly), NBWL 48 (not
    a multiple of 32), C = 5 and 32, H = 1 and 4, bases below 0 and at or
    above NBr, and a tile where no row hits (chip_smoke.py phase 8 runs the
    probe's full shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.block_extract import (VARIANTS, block_extract,
                                                            block_extract_plain)
    from shasta_tpu_torch.probe_block_conv import probe_inputs

    dev = resolve_device("cuda")
    for C, H, NBWL, tile, recipe in ((16, 4, 128, 128, "hit"), (32, 2, 256, 128, "hit"),
                                     (16, 4, 128, 128, "dup"), (5, 1, 48, 32, "hit"),
                                     (32, 1, 48, 64, "hit"), (16, 4, 128, 256, "dup"),
                                     (32, 2, 256, 256, "hit"), (5, 4, 128, 64, "hit")):
        a = probe_inputs(8192, C, H, NBWL, tile, 0, recipe)
        NBr = a["sg1"].shape[0]
        a["bases"][0, ::2] = -3
        a["bases"][-1] = NBr + 2
        a["bases"][-2, 1::2] = NBr
        a["q"][tile:2 * tile] = -2**31 + 5  # tile 1: no window holds these rows
        args = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        for variant in VARIANTS:
            kw = dict(H=H, C=C, tile=tile, variant=variant)
            tag = (C, H, NBWL, tile, recipe, variant)
            want = block_extract_plain(**args, **kw)
            # overlapping windows sum two blocks' keys: eq, so noselect and
            # full, are then zero
            assert recipe == "dup" or want.abs().sum() > 0, tag
            got = block_extract(**args, **kw)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=str(tag))
            assert torch.equal(block_extract(**args, **kw), got), tag
            assert got[tile:2 * tile].abs().max() == 0, tag
