"""ShaSTA model: the port of shasta_tpu/models/shasta.py (ShastaConfig,
bev_maps and the two-frame forward, bev_single, frame_features,
affinity_step).

Inputs are fixed-shape: detections padded to max_obj rows of 11 features
[x, y, z, w, l, h, yaw, vx, vy, dt, score], voxels padded to a static
capacity with a validity mask. The module is built in eval mode with
every parameter frozen, as serving runs it; training (train/loop.py) turns
on the grads and BN modes it needs.

Four trunks, by `ShastaConfig.reader`:
- "voxelnet" (the default, ShaSTA's configs): voxel means, the sparse 3D
  trunk (`backbone`), the RPN neck and the shared conv;
- "dynamic" (CenterPoint-MVP, configs/nusc/mvp/car.py): det3d's
  DynamicVoxelEncoder (virtual route) over each lane's raw point rows
  (`cloud`, padded, with the mask `cloud_valid`), voxelized on the
  device into `max_voxels` slots, 21 features a voxel, then the
  sparse trunk, the neck and the shared conv as "voxelnet". Serving
  only: train/loop.py refuses it;
- "pillars" (CenterPoint-PP, configs/nusc/pp/car.py): det3d's
  PillarFeatureNet (`reader`) over the frame's pillars, scattered onto
  grid_shape's (ny, nx) canvas, then the neck (three blocks at published
  widths) and the shared conv. Serving only: train/loop.py refuses it;
- "dsvt" (DSVT-P, configs/nusc/dsvt/car.py): OpenPCDet's DynamicPillarVFE
  over each lane's raw point rows (`cloud`, 5 channels, and
  `cloud_valid`) into `max_pillars` slots, DSVT's rotated-set window
  attention (`dsvt`, models/dsvt.py), the pillars scattered onto the
  canvas, OpenPCDet's residual neck (`ResNeck`) and TransFusion-L's plain
  shared conv. Serving only: train/loop.py refuses it.
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
from .dsvt import DSVT
from .dynamic_voxel import dynamic_voxelize_virtual
from .pillars import PillarFeatureNet, point_pillars_scatter
from .rpn import RPN, ResNeck, SharedConv
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
    # the dynamic reader (det3d's DynamicVoxelEncoder, virtual route: MVP's
    # 16-channel rows, 21 features a voxel): the points' z range, cut into
    # grid_shape's Z - 1 voxels (x and y are the grid's: pc_start,
    # voxel_size, grid_shape), and the voxel slots a lane
    z_range: tuple = (-5.0, 3.0)
    max_voxels: int = 160000
    # the DSVT reader (DSVT-P: a dynamic pillar net, pfn_filters wide, over
    # each lane's 5-channel rows into max_pillars slots; one DSVT stage of
    # dsvt_blocks blocks at dsvt_d_model, dsvt_heads heads and an FFN of
    # dsvt_ffn, sets of dsvt_set_size in windows of dsvt_window cells
    # shifted by 0 and dsvt_shift); its neck is ResNeck (the RPN's keys),
    # its shared conv TransFusion-L's plain 3x3 conv
    max_pillars: int = 26000
    dsvt_d_model: int = 128
    dsvt_heads: int = 8
    dsvt_ffn: int = 256
    dsvt_blocks: int = 4
    dsvt_set_size: int = 90
    dsvt_window: int = 30
    dsvt_shift: int = 15

    def __post_init__(self):
        if self.reader not in ("voxelnet", "pillars", "dynamic", "dsvt"):
            raise ValueError(f"reader {self.reader!r}: 'voxelnet', 'pillars', 'dynamic' "
                             "or 'dsvt'")
        if self.reader == "dynamic" and self.num_input_features != 21:
            raise ValueError("the dynamic reader gives 21 features a voxel, "
                             f"not num_input_features {self.num_input_features}")
        if self.reader == "dsvt":
            self._check_dsvt()

    def _check_dsvt(self):
        """Refuses widths and a grid the DSVT reader cannot give."""
        d = self.dsvt_d_model
        for ok, why in (
                (self.num_input_features == 5, f"takes 5 point channels, not "
                                               f"num_input_features {self.num_input_features}"),
                (self.grid_shape[0] == 1, f"is a pillar grid: grid_shape {self.grid_shape}"),
                (self.pfn_filters[-1] == d and all(f % 2 == 0 for f in self.pfn_filters),
                 f"gives pfn_filters[-1] = dsvt_d_model ({d}), even widths: {self.pfn_filters}"),
                (d % self.dsvt_heads == 0, f"splits dsvt_d_model {d} into {self.dsvt_heads} heads"),
                (self.neck_input_features == d, f"feeds the neck dsvt_d_model {d} channels, "
                                                f"not {self.neck_input_features}"),
                (self.out_stride * self.us_layer_strides[0] == self.ds_layer_strides[0],
                 f"maps the canvas to the neck's first level, not to out_stride "
                 f"{self.out_stride}")):
            if not ok:
                raise ValueError(f"the dsvt reader {why}")


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
        elif cfg.reader == "dsvt":
            self.dsvt = DSVT(cfg.pfn_filters, cfg.num_input_features, cfg.dsvt_d_model,
                             cfg.dsvt_heads, cfg.dsvt_ffn, cfg.dsvt_blocks, cfg.dsvt_set_size,
                             cfg.dsvt_window, cfg.dsvt_shift, cfg.grid_shape[1:], cfg.pc_start,
                             cfg.voxel_size, cfg.z_range, cfg.max_pillars, dtype=cfg.dtype)
        else:
            self.backbone = SparseBackbone(
                cfg.num_input_features, dtype=cfg.dtype,
                caps=(cfg.cap_conv2, cfg.cap_conv3, cfg.cap_conv4, cfg.cap_extra),
                bn_sync=cfg.bn_axis_name is not None)
        neck = ResNeck if cfg.reader == "dsvt" else RPN
        self.neck = neck(cfg.layer_nums, cfg.ds_layer_strides, cfg.ds_num_filters,
                         cfg.us_layer_strides, cfg.us_num_filters, cfg.neck_input_features,
                         dtype=cfg.dtype)
        self.shared_conv = SharedConv(sum(cfg.us_num_filters), cfg.share_conv_channel,
                                      dtype=cfg.dtype, plain=cfg.reader == "dsvt")
        self.to(self.device).eval()
        self.requires_grad_(False)

    @property
    def trunk_names(self) -> tuple[str, str, str]:
        """The attribute names of the trunk's three modules: the pillar
        reader, the DSVT reader and stage, or the sparse backbone (which
        the dynamic reader feeds); the neck; the shared conv."""
        first = {"pillars": "reader", "dsvt": "dsvt"}.get(self.cfg.reader, "backbone")
        return (first, "neck", "shared_conv")

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
        keys = CLOUD_KEYS if self.cfg.reader in ("dynamic", "dsvt") else VOXEL_KEYS
        B = batch[keys[0]].shape[0]
        if self.cfg.reader != "voxelnet":  # the curr and prev frames as one batch of 2B
            frames = {k: torch.cat([batch[k], batch["prev_" + k]]) for k in keys}
            bev = self.bev_single(frames)
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
# a frame of raw point rows, the dynamic and DSVT readers' input: (B, N, C)
# rows padded to a fixed N, and their (B, N) mask
CLOUD_KEYS = ("cloud", "cloud_valid")


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
    device). Row b*V + v carries batch index b. The dynamic and DSVT
    readers read cloud (B, N, C) and cloud_valid (B, N) instead
    (`dynamic_sparse`, `dsvt_canvas`)."""
    if cfg.reader == "pillars":
        canvas = pillar_canvas(cfg, first, frame)
    elif cfg.reader == "dsvt":
        canvas = dsvt_canvas(cfg, first, frame)
    else:
        return _trunk_from_sparse(first, neck, shared_conv, *frame_sparse(cfg, frame))
    with annotate("step.neck"):
        bev = shared_conv(neck(canvas.permute(0, 3, 1, 2)))
    return bev.permute(0, 2, 3, 1)


def pillar_canvas(cfg: ShastaConfig, reader: PillarFeatureNet, frame: dict) -> torch.Tensor:
    """The pillar reader over every one of the frame's V pillar slots (B,
    V, P, 5), scattered onto the canvas of cfg.grid_shape's (ny, nx): (B,
    ny, nx, C), channels last, in span step.pillars; the invalid rows are
    dropped. While a profiler records it counts, per lane, `pillars.kept`
    (the valid pillars), `pillars.slots` (V) and `pillars.points` (the
    points in valid pillars)."""
    with annotate("step.pillars"):
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
    prefix, B=1 only), or None. The dynamic reader voxelizes the frame's
    clouds in span step.dynamic_voxel, with no plans."""
    if cfg.reader == "dynamic":
        with annotate("step.dynamic_voxel"):
            return dynamic_sparse(cfg, frame["cloud"], frame["cloud_valid"]), None
    B = frame["voxels"].shape[0]
    plans = {k[5:]: v for k, v in frame.items() if k.startswith("plan_")}
    assert B == 1 or not plans, "host plans serve the B=1 step"
    st = sp.SparseTensor(*_voxel_rows(cfg, frame["voxels"], frame["num_points"],
                                      frame["coordinates"], frame["voxels_valid"]),
                         tuple(cfg.grid_shape), B)
    return st, plans or None


def dynamic_sparse(cfg: ShastaConfig, cloud: torch.Tensor, cloud_valid: torch.Tensor
                   ) -> sp.SparseTensor:
    """The sparse tensor of B lanes' point rows cloud (B, N, 16), mask
    cloud_valid (B, N): each lane voxelized on its own into cfg.max_voxels
    slots by `dynamic_voxelize_virtual` over the grid's x and y and
    cfg.z_range in the grid's Z - 1 voxels (Z holds det3d's pad row), row
    b*max_voxels + v carrying lane b. While a profiler
    records it counts, per lane, `dynvox.points` (valid rows),
    `dynvox.virtual` (valid rows of type 0 or -1: painted or virtual),
    `dynvox.voxels` (valid voxels), `dynvox.slots` (max_voxels) and
    `dynvox.dropped` (voxels past the capacity)."""
    B, V = cloud.shape[0], cfg.max_voxels
    (Z, Y, X), (vx, vy), (x0, y0), (z0, z1) = (cfg.grid_shape, cfg.voxel_size, cfg.pc_start,
                                                cfg.z_range)
    pc_range = (x0, y0, z0, x0 + X * vx, y0 + Y * vy, z1)
    size = (vx, vy, (z1 - z0) / (Z - 1))
    valid = cloud_valid.bool()
    rec = profiler.recording()
    lanes = [dynamic_voxelize_virtual(cloud[b], valid[b], pc_range, size, V, demand=rec)
             for b in range(B)]
    feats, zyx, vvalid = (torch.cat([lane[i] for lane in lanes]) for i in range(3))
    bidx = torch.arange(B, dtype=torch.int32, device=feats.device).repeat_interleave(V)
    st = sp.SparseTensor(feats, torch.cat([bidx[:, None], zyx], 1), vvalid,
                         tuple(cfg.grid_shape), B)
    if rec:
        kept = vvalid.reshape(B, V).sum(1)
        profiler.count("dynvox.points", valid.sum(1))
        profiler.count("dynvox.virtual", (valid & (cloud[..., -2] != 1)).sum(1))
        profiler.count("dynvox.voxels", kept)
        profiler.count("dynvox.slots", [V] * B)
        profiler.count("dynvox.dropped", torch.stack([lane[3] for lane in lanes]) - kept)
    return st


def dsvt_canvas(cfg: ShastaConfig, dsvt: DSVT, frame: dict) -> torch.Tensor:
    """DSVT-P's canvas (B, ny, nx, C), channels last, of B lanes' rows
    cloud (B, N, 5) and mask cloud_valid (B, N): each lane's pillars read
    into cfg.max_pillars slots and, after the DSVT stage, scattered onto
    the canvas (span step.dyn_pillars, twice a call); the partitions and
    the blocks over every lane's pillars at once (span step.dsvt, the
    partitions in dsvt.partition). While a profiler records it counts, per
    lane, `dynpillar.points` (valid rows on the grid), `.pillars` (the
    valid pillars), `.slots` (max_pillars) and `.dropped` (pillars past
    the capacity), and per partition (four a call) `dsvt.pillars`,
    `dsvt.sets` and `dsvt.slots` (the sets' slots, repeats included)."""
    cloud, valid = frame["cloud"], frame["cloud_valid"].bool()
    B, V = cloud.shape[0], cfg.max_pillars
    with annotate("step.dyn_pillars"):
        lanes = [dsvt.pillars(cloud[b], valid[b]) for b in range(B)]
        feats, yx, pvalid = (torch.cat([lane[i] for lane in lanes]) for i in range(3))
    with annotate("step.dsvt"):
        with annotate("dsvt.partition"):
            parts = dsvt.partitions(yx, pvalid, B)
        feats = dsvt.encode(feats, parts)
    with annotate("step.dyn_pillars"):
        bidx = torch.arange(B, device=feats.device).repeat_interleave(V)
        coords = torch.stack([bidx, torch.zeros_like(bidx), yx[:, 0], yx[:, 1]], 1)
        canvas = point_pillars_scatter(feats, coords, pvalid, B, *cfg.grid_shape[1:])
    if profiler.recording():
        kept = pvalid.reshape(B, V).sum(1)
        profiler.count("dynpillar.points", torch.stack([lane[3] for lane in lanes]))
        profiler.count("dynpillar.pillars", kept)
        profiler.count("dynpillar.slots", [V] * B)
        profiler.count("dynpillar.dropped", torch.stack([lane[4] for lane in lanes]) - kept)
        for part in parts:
            for _ in range(2):
                profiler.count("dsvt.pillars", kept)
                profiler.count("dsvt.sets", part.sets)
                profiler.count("dsvt.slots", part.sets * cfg.dsvt_set_size)
    return canvas
