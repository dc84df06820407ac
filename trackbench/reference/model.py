"""The plain reference of the ShaSTA step, in float32 PyTorch with TF32 off,
written from the model's equations over a flat dict of weights under
det3d's names (the names the port's state_dict uses):

- the voxel-mean VFE, then the sparse 3D trunk (SpMiddleResNetFHD) one
  frame at a time: each conv gathers its taps' input rows by key
  (searchsorted over the sorted keys of the active set) and sums their
  products tap by tap; a strided conv's output set is every output site
  that a tap of an active input reaches (spconv's rule), uncapped; BN in
  eval mode, ReLU, residual blocks; then the dense BEV map;
- the RPN neck and the shared conv as direct convolutions (patches times
  the weight matrix);
- the five box points, bilinear sampling of the BEV map;
- the affinity head (augmented rows and columns, pairwise MLPs over
  concatenated pairs), the decision rules and the scan tracker, frozen
  copies of the port's plain versions.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# weights: names, shapes, and how each is drawn
# ---------------------------------------------------------------------------

def _bn(spec, p, c):
    spec[p + ".weight"] = ((c,), "bn_weight")
    spec[p + ".bias"] = ((c,), "bias")
    spec[p + ".running_mean"] = ((c,), "bias")
    spec[p + ".running_var"] = ((c,), "var")
    spec[p + ".num_batches_tracked"] = ((), "count")


def _lin(spec, p, i, o):
    spec[p + ".weight"] = ((o, i), "weight")
    spec[p + ".bias"] = ((o,), "bias")


def head_spec(max_obj: int, num_feats: int = 3, num_point: int = 5, C: int = 64) -> OrderedDict:
    spec: OrderedDict = OrderedDict()
    Fd = num_point * C
    for name, width, div in (("aug_shape", Fd, 64), ("aug_dets", 7, 32)):
        for i in range(4):
            _lin(spec, f"{name}.{i}.0", max_obj * width, max_obj * width // div)
            _lin(spec, f"{name}.{i}.2", max_obj * width // div, width)
    for name, d_in, dims in (("fuse_shape", 2 * Fd, [Fd // 8, Fd // 16, Fd // 32, 1]),
                             ("fuse_det", 2 * num_feats, [32, 8, 1]),
                             ("res_coeff", 2 * (Fd + num_feats),
                              [32 + Fd // 8, 8 + Fd // 32, 3]),
                             ("aff", max_obj + 2, [128, 64, 32, 64, 128, max_obj + 2])):
        for j, o in enumerate(dims):
            _lin(spec, f"{name}.{2 * j}", d_in, o)
            d_in = o
    return spec


def trunk_spec(nin: int = 5, C: int = 64) -> OrderedDict:
    spec: OrderedDict = OrderedDict()

    def subm(p, ci, co, k=(3, 3, 3), bias=True):
        spec[p + ".weight"] = ((*k, ci, co), "weight")
        if bias:
            spec[p + ".bias"] = ((co,), "bias")

    def block(p, c):
        for j in (1, 2):
            subm(f"{p}.conv{j}", c, c)
            _bn(spec, f"{p}.bn{j}", c)

    b = "backbone"
    subm(f"{b}.conv_input.0", nin, 16, bias=False)
    _bn(spec, f"{b}.conv_input.1", 16)
    block(f"{b}.conv1.0", 16)
    block(f"{b}.conv1.1", 16)
    for name, ci, co, k, nb in (("conv2", 16, 32, (3, 3, 3), 2), ("conv3", 32, 64, (3, 3, 3), 2),
                                ("conv4", 64, 128, (3, 3, 3), 2),
                                ("extra_conv", 128, 128, (3, 1, 1), 0)):
        subm(f"{b}.{name}.0", ci, co, k, bias=False)
        _bn(spec, f"{b}.{name}.1", co)
        for j in range(nb):
            block(f"{b}.{name}.{3 + j}", co)
    for i, (ci, c) in enumerate(((256, 128), (128, 256))):
        spec[f"neck.blocks.{i}.1.weight"] = ((c, ci, 3, 3), "weight")
        _bn(spec, f"neck.blocks.{i}.2", c)
        for j in range(5):
            spec[f"neck.blocks.{i}.{4 + 3 * j}.weight"] = ((c, c, 3, 3), "weight")
            _bn(spec, f"neck.blocks.{i}.{5 + 3 * j}", c)
    spec["neck.deblocks.0.0.weight"] = ((256, 128, 1, 1), "weight")
    _bn(spec, "neck.deblocks.0.1", 256)
    spec["neck.deblocks.1.0.weight"] = ((256, 256, 2, 2), "deconv")
    _bn(spec, "neck.deblocks.1.1", 256)
    spec["shared_conv.0.weight"] = ((C, 512, 3, 3), "weight")
    spec["shared_conv.0.bias"] = ((C,), "bias")
    _bn(spec, "shared_conv.1", C)
    return spec


def _fan_in(name: str, shape) -> int:
    if name.startswith("backbone."):  # (kz, ky, kx, in, out)
        return int(np.prod(shape[:-1]))
    return int(np.prod(shape[1:]))  # Linear (out, in), Conv2d (out, in, kh, kw)


def make_weights(spec: OrderedDict, seed: int, device) -> dict:
    """Seeded weights on `device` in three draws: weights ~ N(0, 1/fan_in)
    (a stride-2 deconv's fan-in is its input channels), BN scales ~ N(1,
    0.1), biases and running means ~ N(0, 0.1), running variances ~ U(0.5,
    2); num_batches_tracked 0."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    sizes = [math.prod(s) for s, k in spec.values() if k != "count"]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uni = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind) in spec.items():
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uni[at:at + n].view(shape)
        at += n
        if kind == "weight":
            out[name] = z * _fan_in(name, shape) ** -0.5
        elif kind == "deconv":
            out[name] = z * shape[0] ** -0.5
        elif kind == "bn_weight":
            out[name] = 1.0 + 0.1 * z
        elif kind == "bias":
            out[name] = 0.1 * z
        else:  # var
            out[name] = 0.5 + 1.5 * u
    return out


# ---------------------------------------------------------------------------
# the sparse trunk, one frame
# ---------------------------------------------------------------------------

def _taps(kernel, centered: bool) -> list[tuple]:
    return [(a - (kernel[0] // 2 if centered else 0), b - (kernel[1] // 2 if centered else 0),
             c - (kernel[2] // 2 if centered else 0))
            for a in range(kernel[0]) for b in range(kernel[1]) for c in range(kernel[2])]


class _Set:
    """An active set: coords (M, 3) int64 [z, y, x] in a grid, its sorted keys."""

    def __init__(self, coords: torch.Tensor, shape):
        self.coords, self.shape = coords, tuple(shape)
        self.keys = self.key(coords)
        self.sorted, self.perm = torch.sort(self.keys)

    def key(self, c):
        Z, Y, X = self.shape
        return (c[..., 0] * Y + c[..., 1]) * X + c[..., 2]

    def find(self, c: torch.Tensor) -> torch.Tensor:
        """Rows of the sites c (..., 3), -1 where not active or off the grid."""
        dims = torch.tensor(self.shape, device=c.device)
        ok = ((c >= 0) & (c < dims)).all(-1)
        k = torch.where(ok, self.key(c), -1)
        pos = torch.searchsorted(self.sorted, k).clamp(max=self.sorted.numel() - 1)
        hit = ok & (self.sorted[pos] == k)
        return torch.where(hit, self.perm[pos], -1)


def _conv(feats, in_set: _Set, out_coords, w, bias, stride=None, pad=None):
    """sum over taps k of w[k] . feats[input row at o*s + k - p] (subm: s 1,
    centred taps), (M, Co)."""
    kz, ky, kx, ci, co = w.shape
    wk = w.reshape(kz * ky * kx, ci, co)
    centered = stride is None
    out = feats.new_zeros((out_coords.shape[0], co))
    for k, off in enumerate(_taps((kz, ky, kx), centered)):
        off = torch.tensor(off, device=feats.device)
        src = out_coords + off if centered else (
            out_coords * torch.tensor(stride, device=feats.device) + off
            - torch.tensor(pad, device=feats.device))
        rows = in_set.find(src)
        m = rows >= 0
        out[m] += feats[rows[m]] @ wk[k]
    return out if bias is None else out + bias


def _bn1d(x, sd, p, eps=1e-3):
    return ((x - sd[p + ".running_mean"]) * torch.rsqrt(sd[p + ".running_var"] + eps)
            * sd[p + ".weight"] + sd[p + ".bias"])


def _strided_sites(s: _Set, kernel, stride, pad) -> tuple[torch.Tensor, tuple]:
    out_shape = tuple((n + 2 * p - k) // st + 1
                      for n, k, st, p in zip(s.shape, kernel, stride, pad))
    dev = s.coords.device
    st_t, p_t, dims = (torch.tensor(v, device=dev) for v in (stride, pad, out_shape))
    cand = []
    for off in _taps(kernel, False):
        num = s.coords + p_t - torch.tensor(off, device=dev)
        ok = ((num % st_t) == 0).all(-1)
        o = torch.div(num, st_t, rounding_mode="floor")
        ok &= ((o >= 0) & (o < dims)).all(-1)
        cand.append(o[ok])
    c = torch.cat(cand)
    Z, Y, X = out_shape
    keys = torch.unique((c[:, 0] * Y + c[:, 1]) * X + c[:, 2])
    sites = torch.stack([keys // (Y * X), (keys // X) % Y, keys % X], 1)
    return sites, out_shape


def _block(x, s, sd, p):
    f = _conv(x, s, s.coords, sd[p + ".conv1.weight"], sd[p + ".conv1.bias"])
    f = torch.relu(_bn1d(f, sd, p + ".bn1"))
    f = _conv(f, s, s.coords, sd[p + ".conv2.weight"], sd[p + ".conv2.bias"])
    return torch.relu(_bn1d(f, sd, p + ".bn2") + x)


def sparse_trunk(sd: dict, voxels, num_points, coords, valid, grid_shape,
                 nin: int = 5) -> tuple[torch.Tensor, list]:
    """One frame's voxel arrays (V, P, 5), (V,), (V, 3) zyx, (V,) -> the
    dense map (1, C*D, H, W) (channel c*D + d) and the set sizes per stage."""
    valid = valid.bool()
    f = voxels[valid][:, :, :nin].sum(1) / num_points[valid].clamp(min=1).float()[:, None]
    s = _Set(coords[valid].long(), grid_shape)
    b = "backbone"
    x = _conv(f, s, s.coords, sd[f"{b}.conv_input.0.weight"], None)
    x = torch.relu(_bn1d(x, sd, f"{b}.conv_input.1"))
    for j in (0, 1):
        x = _block(x, s, sd, f"{b}.conv1.{j}")
    sizes = [s.coords.shape[0]]
    for name, k, st, p, nb in (("conv2", (3, 3, 3), (2, 2, 2), (1, 1, 1), 2),
                               ("conv3", (3, 3, 3), (2, 2, 2), (1, 1, 1), 2),
                               ("conv4", (3, 3, 3), (2, 2, 2), (0, 1, 1), 2),
                               ("extra_conv", (3, 1, 1), (2, 1, 1), (0, 0, 0), 0)):
        sites, out_shape = _strided_sites(s, k, st, p)
        x = _conv(x, s, sites, sd[f"{b}.{name}.0.weight"], None, st, p)
        x = torch.relu(_bn1d(x, sd, f"{b}.{name}.1"))
        s = _Set(sites, out_shape)
        sizes.append(sites.shape[0])
        for j in range(nb):
            x = _block(x, s, sd, f"{b}.{name}.{3 + j}")
    D, H, W = s.shape
    dense = x.new_zeros((D, H, W, x.shape[1]))
    dense[s.coords[:, 0], s.coords[:, 1], s.coords[:, 2]] = x
    return dense.permute(3, 0, 1, 2).reshape(1, -1, H, W), sizes


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """A direct 2D convolution, (1, Ci, H, W) by (Co, Ci, k, k): the input's
    patches (unfold) times the weight matrix."""
    k = w.shape[-1]
    H = (x.shape[2] + 2 * pad - k) // stride + 1
    W = (x.shape[3] + 2 * pad - k) // stride + 1
    cols = F.unfold(x, k, padding=pad, stride=stride)[0]  # (Ci*k*k, H*W)
    return (w.reshape(w.shape[0], -1) @ cols).reshape(1, w.shape[0], H, W)


def deconv2x2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A stride-2 2x2 transposed convolution, (1, Ci, H, W) by (Ci, Co, 2,
    2): each input pixel spreads to its 2x2 output block."""
    _, ci, H, W = x.shape
    y = torch.einsum("ihw,ioab->ohawb", x[0], w)
    return y.reshape(1, w.shape[1], 2 * H, 2 * W)


def _bn2d(x, sd, p, eps):
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"], sd[p + ".weight"],
                        sd[p + ".bias"], False, 0.0, eps)


def neck(sd: dict, x: torch.Tensor) -> torch.Tensor:
    """RPN (two blocks of a strided conv and five convs, each deblocked to
    the first block's size) and the shared conv -> (1, H, W, 64)."""
    ups = []
    for i, stride in enumerate((1, 2)):
        p = f"neck.blocks.{i}"
        x = torch.relu(_bn2d(conv2d(x, sd[p + ".1.weight"], stride, 1), sd, p + ".2", 1e-3))
        for j in range(5):
            x = torch.relu(_bn2d(conv2d(x, sd[f"{p}.{4 + 3 * j}.weight"], 1, 1), sd,
                                 f"{p}.{5 + 3 * j}", 1e-3))
        d = f"neck.deblocks.{i}"
        up = conv2d(x, sd[d + ".0.weight"]) if i == 0 else deconv2x2(x, sd[d + ".0.weight"])
        ups.append(torch.relu(_bn2d(up, sd, d + ".1", 1e-3)))
    x = torch.cat(ups, 1)
    x = conv2d(x, sd["shared_conv.0.weight"], 1, 1) + sd["shared_conv.0.bias"][:, None, None]
    return torch.relu(_bn2d(x, sd, "shared_conv.1", 1e-5)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# box points and sampling (copies of the port's core/boxes.py, bilinear.py)
# ---------------------------------------------------------------------------

def box_points_5(b7: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 5, 3): centre, then the midpoints of the front, back,
    left and right sides at the box's height."""
    norm = torch.tensor(((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5)),
                        device=b7.device, dtype=b7.dtype)
    corners = b7[:, None, 3:5] * norm
    c, s = torch.cos(b7[:, 6])[:, None], torch.sin(b7[:, 6])[:, None]
    x, y = corners[..., 0], corners[..., 1]
    corners = torch.stack([x * c + y * s, -x * s + y * c], -1) + b7[:, None, :2]
    mids = torch.stack([(corners[:, 0] + corners[:, 1]) / 2, (corners[:, 2] + corners[:, 3]) / 2,
                        (corners[:, 0] + corners[:, 3]) / 2, (corners[:, 1] + corners[:, 2]) / 2],
                       1)
    mids = torch.cat([mids, b7[:, None, 2:3].expand(-1, 4, 1)], -1)
    return torch.cat([b7[:, None, :3], mids], 1)


def sample(bev: torch.Tensor, pts: torch.Tensor, pc_start, voxel_size, stride) -> torch.Tensor:
    """bev (H, W, C) at world points (N, P, 3) -> (N, P*C); indices clamp to
    the border, weights from the unclamped neighbours."""
    H, W = bev.shape[:2]
    x = (pts[..., 0] - pc_start[0]) / voxel_size[0] / stride
    y = (pts[..., 1] - pc_start[1]) / voxel_size[1] / stride
    x0, y0 = torch.floor(x).int(), torch.floor(y).int()
    x1, y1 = x0 + 1, y0 + 1
    xc0, xc1 = x0.clamp(0, W - 1).long(), x1.clamp(0, W - 1).long()
    yc0, yc1 = y0.clamp(0, H - 1).long(), y1.clamp(0, H - 1).long()
    out = (bev[yc0, xc0] * ((x1 - x) * (y1 - y))[..., None]
           + bev[yc1, xc0] * ((x1 - x) * (y - y0))[..., None]
           + bev[yc0, xc1] * ((x - x0) * (y1 - y))[..., None]
           + bev[yc1, xc1] * ((x - x0) * (y - y0))[..., None])
    return out.reshape(out.shape[0], -1)


# ---------------------------------------------------------------------------
# the affinity head, one class, one pair of frames
# ---------------------------------------------------------------------------

def _mlp(sd, p, x, n):
    for j in range(n):
        x = x @ sd[f"{p}.{2 * j}.weight"].T + sd[f"{p}.{2 * j}.bias"]
        if j + 1 < n:
            x = torch.relu(x)
    return x


def affinity(sd: dict, prev_b7, curr_b7, curr_vel, curr_dt, prev_feat, curr_feat,
             num_feats: int = 3):
    """(N, 7), (N, 7), (N, 2), (N, 1), (N, F), (N, F) -> matched1 (N, N+2)
    row softmax, matched2 (N+2, N) column softmax."""
    N = prev_feat.shape[0]
    cf, pf = curr_feat.reshape(-1), prev_feat.reshape(-1)
    geo = [_mlp(sd, f"aug_shape.{i}", v, 2).abs()[None] for i, v in
           enumerate((cf, cf, pf, pf))]
    feat_d = torch.cat([curr_feat, geo[2], geo[3]])
    feat_t = torch.cat([prev_feat, geo[0], geo[1]])

    def abs_dims(b):
        return torch.cat([b[..., :3], b[..., 3:6].abs(), b[..., 6:]], -1)[None]

    cb, pb = curr_b7.reshape(-1), prev_b7.reshape(-1)
    aug = [abs_dims(_mlp(sd, f"aug_dets.{i}", v, 2)) for i, v in enumerate((cb, cb, pb, pb))]
    curr_bp = torch.cat([curr_b7[:, :2] - curr_vel * curr_dt, curr_b7[:, 2:]], -1)
    boxes_t = torch.cat([prev_b7, aug[0], aug[1]])
    boxes_d = torch.cat([curr_bp, aug[2], aug[3]])
    nf = num_feats
    dist = ((boxes_t[:, None, :nf] - boxes_d[None, :, :nf]) ** 2).sum(-1)
    dist = dist / torch.sqrt((dist ** 2).sum(0, keepdim=True)).clamp(min=1e-12)
    eps = 1e-10
    dim = (torch.log(boxes_t[:, None, 3:6] + eps) - torch.log(boxes_d[None, :, 3:6] + eps)
           ).abs().sum(-1)
    rot = torch.sqrt((torch.cos(boxes_t[:, None, 6]) - torch.cos(boxes_d[None, :, 6])) ** 2
                     + (torch.sin(boxes_t[:, None, 6]) - torch.sin(boxes_d[None, :, 6])) ** 2)
    hand = dist + dim + rot
    T, D = feat_t.shape[0], feat_d.shape[0]

    def pairs(a, b):
        return torch.cat([a[:, None].expand(T, D, a.shape[-1]),
                          b[None].expand(T, D, b.shape[-1])], -1)

    shape_r = _mlp(sd, "fuse_shape", pairs(feat_t, feat_d), 4)[..., 0]
    fused = _mlp(sd, "fuse_det", pairs(boxes_t[:, :nf], boxes_d[:, :nf]), 3)[..., 0]
    coeff = _mlp(sd, "res_coeff", pairs(torch.cat([feat_t, boxes_t[:, :nf]], -1),
                                        torch.cat([feat_d, boxes_d[:, :nf]], -1)), 3)
    residual = coeff[..., 0] * fused + coeff[..., 1] * hand + coeff[..., 2] * shape_r
    matched = _mlp(sd, "aff", residual, 6)
    return torch.softmax(matched[:-2], 1), torch.softmax(matched[:, :-2], 0)
