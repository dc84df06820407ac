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
    card, f32 (TF32 off) at atol/rtol 1e-5, on inputs whose rows hit (both
    probe geometries at V=8192) and whose windows overlap (chip_smoke.py
    phase 8 runs the probe's full shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.block_extract import (VARIANTS, block_extract,
                                                            block_extract_plain)
    from shasta_tpu_torch.probe_block_conv import probe_inputs

    dev = resolve_device("cuda")
    for (C, H, NBWL), recipe in (((16, 4, 128), "hit"), ((32, 2, 256), "hit"),
                                 ((16, 4, 128), "dup")):
        args = {k: torch.from_numpy(v).to(dev)
                for k, v in probe_inputs(8192, C, H, NBWL, 128, 0, recipe).items()}
        for variant in VARIANTS:
            kw = dict(H=H, C=C, tile=128, variant=variant)
            want = block_extract_plain(**args, **kw)
            # overlapping windows sum two blocks' keys: eq, so noselect and
            # full, are then zero
            assert recipe == "dup" or want.abs().sum() > 0, variant
            torch.testing.assert_close(block_extract(**args, **kw), want, atol=1e-5,
                                       rtol=1e-5)
