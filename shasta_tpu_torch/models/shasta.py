"""ShaSTA model: the port of shasta_tpu/models/shasta.py (ShastaConfig,
bev_maps and the two-frame forward, bev_single, frame_features,
affinity_step).

Inputs are fixed-shape: detections padded to max_obj rows of 11 features
[x, y, z, w, l, h, yaw, vx, vy, dt, score], voxels padded to a static
capacity with a validity mask. The module is built in eval mode with
every parameter frozen, as serving runs it; training (train/loop.py) turns
on the grads and BN modes it needs.

Two trunks, by `ShastaConfig.reader`:
- "voxelnet" (the default, ShaSTA's configs): voxel means, the sparse 3D
  trunk (`backbone`), the RPN neck and the shared conv;
- "pillars" (CenterPoint-PP, configs/nusc/pp/car.py): det3d's
  PillarFeatureNet (`reader`) over the frame's pillars, scattered onto
  grid_shape's (ny, nx) canvas, then the neck (three blocks at published
  widths) and the shared conv. Serving only: train/loop.py refuses it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.bilinear import sample_bev_features
from ..core.boxes import box_points_5
from ..device import resolve_device
from ..ops import sparse as sp
from ..utils import profiler
from ..utils.profiler import annotate
from .affinity import AffinityNet
from .backbone import SparseBackbone
from .pillars import PillarFeatureNet, point_pillars_scatter
from .rpn import RPN, SharedConv
from .vfe import voxel_mean_vfe


@dataclasses.dataclass(frozen=True)
class ShastaConfig:
    """Static model hyper-shape (configs/nusc/car.py:26-70)."""

    max_obj: int = 90
    num_feats: int = 3
    num_point: int = 5
    share_conv_channel: int = 64
    num_input_features: int = 5
    pc_start: tuple = (-54.0, -54.0)
    voxel_size: tuple = (0.075, 0.075)
    out_stride: int = 8
    # sparse grid (Z, Y, X) incl. the +1 z pad row (scn.py:181)
    grid_shape: tuple = (41, 1440, 1440)
    # voxel capacity caps per strided stage
    cap_conv2: int = 60000
    cap_conv3: int = 30000
    cap_conv4: int = 15000
    cap_extra: int = 15000
    # set: the trunk's BN statistics are summed over the process group in
    # train mode (the JAX psum axis; any name means the default group)
    bn_axis_name: str | None = None
    dtype: torch.dtype | None = None  # torch.bfloat16 trunk, None = f32
    # the trunk's reader: "voxelnet" (the sparse 3D trunk) or "pillars"
    # (CenterPoint-PP: det3d's PillarFeatureNet onto a canvas of
    # grid_shape's (ny, nx) cells of voxel_size, pc_start its corner), and
    # the pillar net's published filters
    reader: str = "voxelnet"
    pfn_filters: tuple = (64, 64)
    # the RPN neck, in det3d's names (necks/rpn.py), and its input width
    layer_nums: tuple = (5, 5)
    ds_layer_strides: tuple = (1, 2)
    ds_num_filters: tuple = (128, 256)
    us_layer_strides: tuple = (1, 2)
    us_num_filters: tuple = (256, 256)
    neck_input_features: int = 256

    def __post_init__(self):
        if self.reader not in ("voxelnet", "pillars"):
            raise ValueError(f"reader {self.reader!r}: 'voxelnet' or 'pillars'")


class ShastaModel(AffinityNet):
    """The BEV trunk plus the affinity head. As in det3d's Shasta, the
    head's modules sit at the top level (aug_shape.*, fuse_shape.*, aff.*,
    ...) beside backbone.*, neck.* and shared_conv.*, so a reference
    state_dict loads as is. Calling the model runs the two-frame forward
    (the JAX __call__); `head` runs the affinity head alone."""

    head = AffinityNet.forward

    def __init__(self, cfg: ShastaConfig = ShastaConfig(), device=None):
        super().__init__(cfg.max_obj, cfg.num_feats, cfg.num_point,
                         cfg.share_conv_channel)
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.reader == "pillars":
            self.reader = PillarFeatureNet(cfg.pfn_filters, cfg.num_input_features,
                                           cfg.voxel_size, cfg.pc_start, device=self.device,
                                           det3d=True, dtype=cfg.dtype)
        else:
            self.backbone = SparseBackbone(
                cfg.num_input_features, dtype=cfg.dtype,
                caps=(cfg.cap_conv2, cfg.cap_conv3, cfg.cap_conv4, cfg.cap_extra),
                bn_sync=cfg.bn_axis_name is not None)
        self.neck = RPN(cfg.layer_nums, cfg.ds_layer_strides, cfg.ds_num_filters,
                        cfg.us_layer_strides, cfg.us_num_filters, cfg.neck_input_features,
                        dtype=cfg.dtype)
        self.shared_conv = SharedConv(sum(cfg.us_num_filters), cfg.share_conv_channel,
                                      dtype=cfg.dtype)
        self.to(self.device).eval()
        self.requires_grad_(False)

    @property
    def trunk_names(self) -> tuple[str, str, str]:
        """The attribute names of the trunk's three modules: the pillar
        reader or the sparse backbone, the neck, the shared conv."""
        return ("reader" if self.cfg.reader == "pillars" else "backbone", "neck", "shared_conv")

    def pair_tensor(self, batch: dict) -> sp.SparseTensor:
        """The curr and the prev frame of B frame pairs as ONE sparse batch
        of 2B (curr samples 0..B-1, prev samples B..2B-1). batch: voxels (B,
        V, P, 5), num_points (B, V), coordinates (B, V, 3) [z, y, x],
        voxels_valid (B, V) and their prev_* mirrors, tensors on the model's
        device."""
        cfg = self.cfg
        B = batch["voxels"].shape[0]
        parts = [_voxel_rows(cfg, *(batch[p + k] for k in
                                    ("voxels", "num_points", "coordinates", "voxels_valid")),
                             b_off=i * B) for i, p in enumerate(("", "prev_"))]
        return sp.SparseTensor(*(torch.cat(t) for t in zip(*parts)), tuple(cfg.grid_shape),
                               2 * B)

    def bev_maps(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Shared-conv BEV maps (B, H, W, 64) of the curr and the prev frame
        of B frame pairs, through the trunk once (`pair_tensor`), every
        index built on the device."""
        B = batch["voxels"].shape[0]
        if self.cfg.reader == "pillars":  # the curr and prev frames as one batch of 2B
            frames = {k: torch.cat([batch[k], batch["prev_" + k]]) for k in VOXEL_KEYS}
            bev = trunk_bev(self.cfg, self.reader, self.neck, self.shared_conv, frames)
        else:
            bev = _trunk_from_sparse(self.backbone, self.neck, self.shared_conv,
                                     self.pair_tensor(batch), None)
        return bev[:B], bev[B:]

    def forward(self, batch: dict):
        """The two-frame forward (the JAX ShastaModel.__call__): both BEV
        maps from `bev_maps`, then `pair_head` -> (matched1 (B, N, N+2),
        matched2 (B, N+2, N)). batch: the `bev_maps` arrays plus det_boxes
        and prev_det_boxes (B, N, 11), numpy arrays or tensors."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        return self.pair_head(*self.bev_maps(batch), batch)

    def pair_head(self, bev: torch.Tensor, prev_bev: torch.Tensor, batch: dict):
        """Each frame's boxes sampled on its own BEV map (B, H, W, 64), then
        the affinity head -> (matched1, matched2)."""
        c = self.cfg
        prev_boxes = batch["prev_det_boxes"][:, :, :7]
        curr_boxes = batch["det_boxes"][:, :, :7]
        curr_feat = sample_bev_features(bev, box_points_5(curr_boxes), c.pc_start,
                                        c.voxel_size, c.out_stride)
        prev_feat = sample_bev_features(prev_bev, box_points_5(prev_boxes), c.pc_start,
                                        c.voxel_size, c.out_stride)
        return self.head(prev_boxes, curr_boxes, batch["det_boxes"][:, :, 7:9],
                         batch["det_boxes"][:, :, 9:10], prev_feat.float(),
                         curr_feat.float())

    def bev_single(self, frame: dict) -> torch.Tensor:
        """Shared-conv BEV map (B, H, W, 64) of `trunk_bev`."""
        return trunk_bev(self.cfg, *(getattr(self, n) for n in self.trunk_names), frame)

    def frame_features(self, frame: dict) -> torch.Tensor:
        """Trunk + BEV descriptor sampling for ONE frame of each of B
        scenes -> (B, N, 320) f32."""
        c = self.cfg
        bev = self.bev_single(frame)
        pts = box_points_5(frame["det_boxes"][:, :, :7])
        return sample_bev_features(bev, pts, c.pc_start, c.voxel_size, c.out_stride)

    def affinity_step(self, prev_boxes11, curr_boxes11, prev_feat, curr_feat):
        """Affinity matrices from boxes + (possibly carried) descriptors."""
        return self.head(
            prev_boxes11[:, :, :7], curr_boxes11[:, :, :7],
            curr_boxes11[:, :, 7:9], curr_boxes11[:, :, 9:10],
            prev_feat.float(), curr_feat.float())


VOXEL_KEYS = ("voxels", "num_points", "coordinates", "voxels_valid")


def _voxel_rows(cfg: ShastaConfig, voxels, num_points, coordinates, valid, b_off: int = 0):
    """VFE features (B*V, C), coords (B*V, 4) [b_off + b, z, y, x] and the
    validity (B*V,) of B frames' voxel arrays: row b*V + v is frame b's."""
    B, V = voxels.shape[:2]
    feats = voxel_mean_vfe(voxels.reshape(B * V, *voxels.shape[2:]),
                           num_points.reshape(B * V), cfg.num_input_features)
    bidx = (torch.arange(B, dtype=torch.int32, device=feats.device) + b_off
            ).repeat_interleave(V)
    coords = torch.cat([bidx[:, None], coordinates.reshape(B * V, 3).to(torch.int32)], dim=1)
    return feats, coords, valid.reshape(B * V)


def _trunk_from_sparse(backbone: SparseBackbone, neck: RPN, shared_conv: SharedConv,
                       st: sp.SparseTensor, plans: dict | None) -> torch.Tensor:
    with annotate("step.sparse_trunk"):
        bev = backbone(st, plans)
    with annotate("step.neck"):
        bev = shared_conv(neck(bev))
    return bev.permute(0, 2, 3, 1)


def trunk_bev(cfg: ShastaConfig, first: torch.nn.Module, neck: RPN,
              shared_conv: SharedConv, frame: dict) -> torch.Tensor:
    """Shared-conv BEV map (B, H, W, 64), channels last, for ONE frame of
    each of B scenes, through the trunk's three modules (a ShastaModel's,
    or the one trunk the multi-class step shares): `first` is the sparse
    backbone, or the pillar reader where cfg.reader is "pillars". frame:
    voxels (B, V, P, 5), num_points (B, V), coordinates (B, V, 3) [z, y,
    x], voxels_valid (B, V), all tensors on the trunk's device; for the
    sparse backbone optionally, at B=1, the plan_* arrays of
    shasta_tpu_torch/plans.py (without them every index is built on the
    device). Row b*V + v carries batch index b."""
    if cfg.reader == "pillars":
        with annotate("step.pillars"):
            canvas = pillar_canvas(cfg, first, frame)
        with annotate("step.neck"):
            bev = shared_conv(neck(canvas.permute(0, 3, 1, 2)))
        return bev.permute(0, 2, 3, 1)
    return _trunk_from_sparse(first, neck, shared_conv, *frame_sparse(cfg, frame))


def pillar_canvas(cfg: ShastaConfig, reader: PillarFeatureNet, frame: dict) -> torch.Tensor:
    """The pillar reader over every one of the frame's V pillar slots (B,
    V, P, 5), scattered onto the canvas of cfg.grid_shape's (ny, nx): (B,
    ny, nx, C), channels last; the invalid rows are dropped. While a
    profiler records it counts, per lane, `pillars.kept` (the valid
    pillars), `pillars.slots` (V) and `pillars.points` (the points in
    valid pillars)."""
    B, V, P = frame["voxels"].shape[:3]
    voxels = frame["voxels"].reshape(B * V, P, -1)[..., :cfg.num_input_features]
    num = frame["num_points"].reshape(B * V)
    zyx = frame["coordinates"].reshape(B * V, 3).to(torch.int32)
    valid = frame["voxels_valid"].reshape(B * V).bool()
    feats = reader(voxels, num, zyx)
    bidx = torch.arange(B, dtype=torch.int32, device=feats.device).repeat_interleave(V)
    canvas = point_pillars_scatter(feats, torch.cat([bidx[:, None], zyx], 1), valid, B,
                                   *cfg.grid_shape[1:])
    if profiler.recording():
        lanes = valid.reshape(B, V)
        profiler.count("pillars.kept", lanes.sum(1))
        profiler.count("pillars.slots", [V] * B)
        profiler.count("pillars.points", (num.reshape(B, V) * lanes).sum(1))
    return canvas


def frame_sparse(cfg: ShastaConfig, frame: dict) -> tuple[sp.SparseTensor, dict | None]:
    """The sparse tensor of `trunk_bev`'s frame dict (row b*V + v carries
    batch index b) and its host plans (the plan_* arrays without their
    prefix, B=1 only), or None."""
    B = frame["voxels"].shape[0]
    plans = {k[5:]: v for k, v in frame.items() if k.startswith("plan_")}
    assert B == 1 or not plans, "host plans serve the B=1 step"
    st = sp.SparseTensor(*_voxel_rows(cfg, frame["voxels"], frame["num_points"],
                                      frame["coordinates"], frame["voxels_valid"]),
                         tuple(cfg.grid_shape), B)
    return st, plans or None
