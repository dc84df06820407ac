"""The FLOP and byte counts against hand counts at small shapes."""
import torch

from trackbench.count import work


def test_subm_hits_by_hand():
    # two voxels side by side in x: each sees itself and the other
    coords = torch.tensor([[1, 1, 1], [1, 1, 2]])
    convs = work.trunk_convs(coords, torch.tensor([True, True]), (5, 8, 8))
    c0 = convs[0]
    assert (c0["name"], c0["hits"], c0["m_in"], c0["cin"], c0["cout"]) == ("conv_input", 4, 2, 5, 16)
    assert work.conv_flops(c0) == 2 * 4 * 5 * 16
    assert work.conv_bytes(c0) == 4 * (2 * 5 + 2 * 16 + 27 * 5 * 16)
    assert len(convs) == 21
    # conv2 (stride 2, pad 1): x = 1 and 2 reach outputs 0/1 and 1; z, y = 1 reach 0 and 1
    c2 = next(c for c in convs if c["name"] == "conv2")
    assert c2["m_out"] == 2 * 2 * 2  # out z {0,1} x y {0,1} x x {0,1} (x=2 -> 1 only)
    assert c2["hits"] == 12  # voxel x=1 -> 8 outputs, voxel x=2 -> 4


def test_neck_and_least_time():
    # one 3x3 conv 256 -> 128 at 180 x 180 by hand
    assert work.neck_flops(180, 180) > 2 * 180 * 180 * 9 * 256 * 128
    f = work.neck_flops(2, 2, c_in=1, shared=1)
    hand = (2 * 4 * 9 * (128 + 5 * 128 * 128) + 2 * 4 * 128 * 256
            + 2 * 1 * 9 * (128 * 256 + 5 * 256 * 256) + 2 * 4 * 256 * 256 + 2 * 4 * 9 * 512)
    assert f == hand
    c = dict(hits=10**6, cin=64, cout=64, m_in=1000, m_out=1000, taps=27)
    assert work.conv_least_s(c) == 2 * 10**6 * 64 * 64 / work.F32_FLOPS_PER_S


def test_head_flops_by_hand():
    n, T = 10, 12
    f = work.head_flops(n)
    aug = 4 * 2 * (n * 320 * (n * 320 // 64) + (n * 320 // 64) * 320)
    aug += 4 * 2 * (n * 7 * (n * 7 // 32) + (n * 7 // 32) * 7)
    assert f > aug
    aff = 2 * T * (T * 128 + 128 * 64 + 64 * 32 + 32 * 64 + 64 * 128 + 128 * T)
    assert f > aug + aff
