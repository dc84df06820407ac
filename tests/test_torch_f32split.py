"""The f32 route's arithmetic, written out in torch (`gather_conv_3xtf32`):
each operand split into TF32 hi and lo parts, hi*hi + hi*lo + lo*hi summed
in f32, as csrc/gather_mma.cuh's 3xTF32 MMAs do on the card. On the CPU,
at down3's and res3's widths and the hits per row of a served frame, it
stays within 1e-5 x max(1, |out|) of the f64 product, and within 1e-4 of
the JAX package's f32 gather-matmul (`_gathered_matmul`, XLA); one TF32
pass alone does not. Inputs are made with numpy from a seed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shasta_tpu.ops import sparse as sp

from shasta_tpu_torch.ops.kernels.gather_conv import gather_conv_3xtf32, round_tf32, split_tf32

# hits per row of 27 taps of a served split frame (configs/nusc/car.py,
# chip_smoke.py phase 15): down3's strided conv and res3's submanifold convs
SERVED_HITS = {"down3": 4.970, "res3": 9.716}


def test_round_tf32_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1.0
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0, -0.0, 2.0 ** -126], dtype=torch.float32)
    want = [one, one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, -0.0, 2.0 ** -126]
    assert round_tf32(x).tolist() == [float(v) for v in want]

    v = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi, lo = split_tf32(v)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((v - hi).abs() <= 2.0 ** -11 * v.abs()).all())
    assert bool(((v.double() - hi.double() - lo.double()).abs()
                 <= 2.0 ** -22 * v.double().abs()).all())


def _case(rng, cin, co, hits, V=3000, M=768, K=27):
    feats = rng.normal(size=(V, cin)).astype(np.float32)
    w = (rng.normal(size=(K, cin, co)) / np.sqrt(K * cin)).astype(np.float32)
    g = rng.integers(0, V, size=(M, K)).astype(np.int32)
    g[rng.random((M, K)) >= hits / K] = V  # a miss
    return feats, g, w


@pytest.mark.parametrize("conv,cin,co", [("down3", 64, 128), ("res3", 128, 128)])
def test_3xtf32_product_is_f32_accurate_at_the_served_frames_hits(rng, conv, cin, co):
    feats, g, w = _case(rng, cin, co, SERVED_HITS[conv])
    f, gg, ww = torch.from_numpy(feats), torch.from_numpy(g), torch.from_numpy(w)
    got = gather_conv_3xtf32(f, gg, ww)
    # the f64 product (the plain version's gather, its matmul in f64)
    idx = torch.where(gg < f.shape[0], gg, f.shape[0]).long()
    padded = torch.cat([f.double(), f.new_zeros((1, cin)).double()])
    exact = padded[idx].reshape(len(g), -1) @ ww.double().reshape(-1, co)
    scale = max(1.0, float(exact.abs().max()))
    err = float((got.double() - exact).abs().max())
    assert err <= 1e-5 * scale, (conv, err, scale)

    # one TF32 pass (hi*hi alone) misses the bound: the lo parts carry it
    a_hi = round_tf32(padded.float()[idx].reshape(len(g), -1))
    one_pass = a_hi @ round_tf32(ww.reshape(-1, co))
    assert float((one_pass.double() - exact).abs().max()) > 1e-5 * scale

    xla = np.asarray(sp._gathered_matmul(jnp.asarray(feats), jnp.asarray(g), jnp.asarray(w),
                                         None, use_pallas=False))
    np.testing.assert_allclose(got.numpy(), xla, atol=1e-4)
