"""Operations and bytes of the pillar trunk a frame (CenterPoint-PP under
ShaSTA's shared conv), from the configuration's model keys, with
work.py's peaks:

- the pillar reader: each PFN layer's products over the kept pillars'
  slots (kept x P rows), 2 * rows * in * units FLOPs a layer;
- the neck's convs, each one launch of the program's neck kernel: a 3x3
  conv (or a deblock's 1x1 or k x k stride-k conv) is 2 * M * K * N FLOPs
  over its M output pixels, K = taps x Cin, N = Cout; a stride-s
  transposed conv is one tap per output pixel, 2 * (M_in s^2) * Cin *
  Cout; bytes: the input map and the output map once and the weights,
  in f32.
"""
from __future__ import annotations

from . import work


def reader_flops(kept: int, points: int, m: dict) -> float:
    """The PFN layers' products over the kept pillars' `points` slots each
    (the point pipeline's max_points_in_voxel; det3d's halved units on
    every layer but the last)."""
    rows = kept * points
    filters = list(m["pfn_filters"])
    c_in, f = m["num_input_features"] + 5, 0.0
    for i, n in enumerate(filters):
        units = n if i + 1 == len(filters) else n // 2
        f += 2.0 * rows * c_in * units
        c_in = 2 * units
    return f


def neck_convs(m: dict) -> list[dict]:
    """The neck's convs in launch order (each block's convs, then its
    deblock; the shared conv last): name, output pixels m_out, input
    pixels m_in, cin, cout, taps, and the FLOPs."""
    H, W = m["grid_shape"][1:]
    cin = m["neck_input_features"]
    out = []

    def conv(name, h_in, w_in, ci, co, k, s, pad):
        h, w = (h_in + 2 * pad - k) // s + 1, (w_in + 2 * pad - k) // s + 1
        out.append(dict(name=name, m_in=h_in * w_in, m_out=h * w, cin=ci, cout=co, taps=k * k,
                        flops=2.0 * h * w * k * k * ci * co))
        return h, w

    for i, (n, s, c) in enumerate(zip(m["layer_nums"], m["ds_layer_strides"],
                                      m["ds_num_filters"])):
        H, W = conv(f"block{i}.conv0", H, W, cin, c, 3, s, 1)
        for j in range(n):
            conv(f"block{i}.conv{j + 1}", H, W, c, c, 3, 1, 1)
        cin = c
        us, u = m["us_layer_strides"][i], m["us_num_filters"][i]
        if us > 1:
            k = int(round(us))
            out.append(dict(name=f"deblock{i}", m_in=H * W, m_out=H * W * k * k, cin=c, cout=u,
                            taps=k * k, flops=2.0 * H * W * k * k * c * u))
            Ho, Wo = H * k, W * k
        else:
            k = int(round(1 / us))
            Ho, Wo = conv(f"deblock{i}", H, W, c, u, k, k, 0)
    conv("shared", Ho, Wo, sum(m["us_num_filters"]), m["share_conv_channel"], 3, 1, 1)
    return out


def conv_bytes(c: dict) -> float:
    return 4.0 * (c["m_in"] * c["cin"] + c["m_out"] * c["cout"] + c["taps"] * c["cin"] * c["cout"])


def conv_least_s(c: dict) -> float:
    """One conv's least time on the card: its products at the f32 peak or
    its bytes at HBM's rate, whichever is longer."""
    return max(c["flops"] / work.F32_FLOPS_PER_S, conv_bytes(c) / work.HBM_BYTES_PER_S)


def dense_flops(m: dict) -> float:
    """The neck's and shared conv's FLOPs a frame."""
    return sum(c["flops"] for c in neck_convs(m))
