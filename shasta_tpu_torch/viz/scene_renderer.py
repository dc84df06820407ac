"""Devkit-free nuScenes scene renderer: LiDAR-on-map BEV + camera boxes;
the port of shasta_tpu/viz/scene_renderer.py (numpy, matplotlib and Pillow
on the host; the two libraries are imported where a render needs them).

Behavioral reference: nusc_visualize/visualize.py:23-60 and the forked
devkit renderer nusc_visualize/temp_nusc.py (render_sample_data /
render_ego_centric_map): per key frame of a scene it renders
  (a) the multi-sweep LiDAR cloud in flat ego coordinates, distance-colored,
      underlaid with the rasterized semantic map patch around the ego pose,
      with tracked boxes (per-class colors, track-id labels) and optional
      green GT boxes of the rendered class;
  (b) a camera image with the tracked 3D boxes projected through the camera
      intrinsics (wireframe with front-face cross).

The reference needs the full nuscenes devkit (it forks NuScenes itself to
feed `tracks` into render_sample_data); here everything reads the raw
v1.0-* table JSONs through preprocessing.nusc_db.NuscDB plus the binary
blobs (lidar .bin, camera image, map mask png), so it runs in this image.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..core.boxes import quaternion_yaw
from ..core.transforms import quat_inverse, quat_to_rotmat
from ..preprocessing.nusc_db import NuscDB

# per tracking-class RGB (same palette role as the devkit's colormap)
CLASS_COLORS = {
    "car": (1.0, 0.62, 0.0),
    "truck": (0.9, 0.4, 0.1),
    "bus": (0.85, 0.2, 0.2),
    "trailer": (0.7, 0.5, 0.2),
    "pedestrian": (0.0, 0.2, 0.9),
    "motorcycle": (0.8, 0.1, 0.8),
    "bicycle": (0.1, 0.7, 0.7),
}
GT_COLOR = (0.0, 0.69, 0.0)

# devkit Box corner convention: l along box-x, w along box-y, h along box-z;
# nuScenes size field is [w, l, h].
_CORNER_SIGNS = np.array(
    [[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
     [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]],
    np.float64,
)


def box_corners_3d(center, size_wlh, rot_q) -> np.ndarray:
    """(8, 3) global/frame corners; rows 0-3 top face, 4-7 bottom face."""
    w, l, h = size_wlh
    local = _CORNER_SIGNS * np.array([l / 2.0, w / 2.0, h / 2.0])
    return local @ quat_to_rotmat(np.asarray(rot_q, np.float64)).T + np.asarray(center)


def _flat_ego_transform(pose: dict):
    """world -> yaw-only ('flat vehicle') ego frame (temp_nusc.py:1320-1331)."""
    yaw = quaternion_yaw(np.asarray(pose["rotation"], np.float64))
    c, s = np.cos(-yaw), np.sin(-yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    trans = np.asarray(pose["translation"], np.float64)
    return lambda pts: (np.asarray(pts, np.float64) - trans) @ rot.T


def _draw_wire_box(ax, corners2d, color, linewidth=1.2, label=None):
    """Wireframe of an 8-corner box projected to 2D (devkit Box.render
    semantics: two faces + 4 pillars + front-center line)."""
    for face in (corners2d[:4], corners2d[4:]):
        ax.plot(
            np.append(face[:, 0], face[0, 0]),
            np.append(face[:, 1], face[0, 1]),
            color=color, linewidth=linewidth,
        )
    for i in range(4):
        ax.plot(
            [corners2d[i, 0], corners2d[i + 4, 0]],
            [corners2d[i, 1], corners2d[i + 4, 1]],
            color=color, linewidth=linewidth,
        )
    # front-face center direction mark
    cf = corners2d[[0, 1, 4, 5]].mean(axis=0)
    cc = corners2d.mean(axis=0)
    ax.plot([cc[0], cf[0]], [cc[1], cf[1]], color=color, linewidth=linewidth)
    if label is not None:
        ax.text(cc[0], cc[1], str(label), color=color, fontsize=7)


def load_tracks(tracking_result_path: str) -> dict[str, list[dict]]:
    """tracking_result.json -> {sample_token: [track dicts]}."""
    import json

    with open(tracking_result_path) as f:
        data = json.load(f)
    return data["results"] if "results" in data else data


@dataclass
class SceneRenderer:
    db: NuscDB
    figsize: tuple = (9, 9)
    _map_cache: dict = field(default_factory=dict)

    # ---------------- raw-data access ------------------------------------

    def _sample_data_for_channel(self, sample: dict, channel: str) -> dict | None:
        for sd in self.db.table("sample_data"):
            if (
                sd["sample_token"] == sample["token"]
                and sd.get("is_key_frame")
                and channel in sd.get("filename", "")
            ):
                return sd
        return None

    def _load_lidar_sweeps(self, sample: dict, nsweeps: int) -> np.ndarray:
        """Aggregate up to nsweeps clouds into the key frame's FLAT ego
        frame (LidarPointCloud.from_file_multisweep + the flat-coordinates
        viewpoint of temp_nusc.py:1305-1331). Returns (P, 3)."""
        ref_sd = self.db.sample_lidar_data(sample)
        ref_pose = self.db.get("ego_pose", ref_sd["ego_pose_token"])
        to_flat = _flat_ego_transform(ref_pose)

        out = []
        sd = ref_sd
        for _ in range(nsweeps):
            path = os.path.join(self.db.dataroot, sd["filename"])
            if os.path.exists(path):
                pts = np.fromfile(path, np.float32).reshape(-1, 5)[:, :3]
                cs = self.db.get("calibrated_sensor", sd["calibrated_sensor_token"])
                pose = self.db.get("ego_pose", sd["ego_pose_token"])
                # sensor -> ego(sweep) -> global
                pts = pts @ quat_to_rotmat(np.asarray(cs["rotation"])).T + cs["translation"]
                pts = pts @ quat_to_rotmat(np.asarray(pose["rotation"])).T + pose["translation"]
                out.append(to_flat(pts))
            prev = sd.get("prev", "")
            if not prev:
                break
            sd = self.db.get("sample_data", prev)
        return np.concatenate(out, axis=0) if out else np.zeros((0, 3))

    def _map_patch(self, sample: dict, axes_limit: float):
        """Ego-centered, yaw-aligned crop of the rasterized map mask
        (render_ego_centric_map, temp_nusc.py:1163-1219). Returns the
        (H, W) uint8 patch or None when map tables/blobs are absent."""
        try:
            scene = self.db.get("scene", sample["scene_token"])
            log = self.db.get("log", scene["log_token"])
            map_rec = next(
                m for m in self.db.table("map")
                if log["token"] in m.get("log_tokens", [])
            )
        except Exception:
            return None
        path = os.path.join(self.db.dataroot, map_rec["filename"])
        if not os.path.exists(path):
            return None
        if path not in self._map_cache:
            from PIL import Image

            Image.MAX_IMAGE_PIXELS = None
            self._map_cache[path] = np.asarray(Image.open(path).convert("L"))
        mask = self._map_cache[path]
        res = float(map_rec.get("resolution", 0.1))

        sd = self.db.sample_lidar_data(sample)
        pose = self.db.get("ego_pose", sd["ego_pose_token"])
        x, y = pose["translation"][:2]
        # map pixel origin is bottom-left: row = H - y/res (devkit MapMask)
        px, py = int(x / res), int(mask.shape[0] - y / res)
        lim = int(axes_limit / res)
        pad = int(lim * np.sqrt(2)) + 1
        y0, y1 = max(py - pad, 0), min(py + pad, mask.shape[0])
        x0, x1 = max(px - pad, 0), min(px + pad, mask.shape[1])
        crop = np.zeros((2 * pad, 2 * pad), mask.dtype)
        crop[(y0 - py + pad):(y1 - py + pad), (x0 - px + pad):(x1 - px + pad)] = mask[y0:y1, x0:x1]

        from PIL import Image

        yaw = quaternion_yaw(np.asarray(pose["rotation"], np.float64))
        rotated = np.asarray(
            Image.fromarray(crop).rotate(-np.degrees(yaw), resample=Image.NEAREST)
        )
        c = rotated.shape[0] // 2
        patch = rotated[c - lim : c + lim, c - lim : c + lim]
        # white background, gray semantic prior (temp_nusc.py:1213-1215)
        out = np.full_like(patch, 255)
        out[patch > 0] = 125
        return out

    # ---------------- renderers ------------------------------------------

    def render_lidar_bev(
        self,
        sample_token: str,
        tracks: list[dict],
        out_path: str,
        nsweeps: int = 10,
        axes_limit: float = 40.0,
        underlay_map: bool = True,
        gt_class: str | None = "car",
        with_ids: bool = True,
    ) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sample = self.db.get("sample", sample_token)
        sd = self.db.sample_lidar_data(sample)
        pose = self.db.get("ego_pose", sd["ego_pose_token"])
        to_flat = _flat_ego_transform(pose)

        fig, ax = plt.subplots(1, 1, figsize=self.figsize)
        if underlay_map:
            patch = self._map_patch(sample, axes_limit)
            if patch is not None:
                ax.imshow(
                    patch, cmap="gray", vmin=0, vmax=255,
                    extent=[-axes_limit, axes_limit, -axes_limit, axes_limit],
                    origin="upper",
                )

        pts = self._load_lidar_sweeps(sample, nsweeps)
        if len(pts):
            dists = np.linalg.norm(pts[:, :2], axis=1)
            colors = np.minimum(1.0, dists / axes_limit / np.sqrt(2))
            ax.scatter(pts[:, 0], pts[:, 1], c=colors, s=0.2)
        ax.plot(0, 0, "x", color="red")

        for t in tracks:
            corners = to_flat(box_corners_3d(t["translation"], t["size"], t["rotation"]))
            color = CLASS_COLORS.get(t.get("tracking_name", "car"), (1.0, 0.0, 0.0))
            _draw_wire_box(
                ax, corners[:, :2], color,
                label=t.get("tracking_id") if with_ids else None,
            )
        if gt_class:
            for a in self.db.annotations_for_sample(sample_token):
                name = self.db.category_name(a["instance_token"])
                if gt_class not in name:
                    continue
                corners = to_flat(box_corners_3d(a["translation"], a["size"], a["rotation"]))
                _draw_wire_box(ax, corners[:, :2], GT_COLOR)

        ax.set_xlim(-axes_limit, axes_limit)
        ax.set_ylim(-axes_limit, axes_limit)
        ax.set_aspect("equal")
        ax.axis("off")
        ax.set_title("LIDAR_TOP (tracks)")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return out_path

    def render_camera(
        self,
        sample_token: str,
        tracks: list[dict],
        out_path: str,
        channel: str = "CAM_FRONT",
        with_ids: bool = True,
    ) -> str | None:
        """Project tracked 3D boxes into a camera image
        (temp_nusc.py:1446-1533). Returns None if the channel is absent."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sample = self.db.get("sample", sample_token)
        sd = self._sample_data_for_channel(sample, channel)
        if sd is None:
            return None
        img_path = os.path.join(self.db.dataroot, sd["filename"])
        if not os.path.exists(img_path):
            return None
        from PIL import Image

        img = np.asarray(Image.open(img_path))
        H, W = img.shape[:2]
        cs = self.db.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = self.db.get("ego_pose", sd["ego_pose_token"])
        K = np.asarray(cs["camera_intrinsic"], np.float64)
        ego_r_inv = quat_inverse(np.asarray(pose["rotation"], np.float64))
        cam_r_inv = quat_inverse(np.asarray(cs["rotation"], np.float64))

        fig, ax = plt.subplots(1, 1, figsize=(9, 9 * H / max(W, 1)))
        ax.imshow(img)
        for t in tracks:
            corners = box_corners_3d(t["translation"], t["size"], t["rotation"])
            # global -> ego -> camera frame
            corners = (corners - np.asarray(pose["translation"])) @ quat_to_rotmat(ego_r_inv).T
            corners = (corners - np.asarray(cs["translation"])) @ quat_to_rotmat(cam_r_inv).T
            z = corners[:, 2]
            if np.any(z < 0.1):  # box_in_image(vis_level=ANY-ish): all corners ahead
                continue
            uv = (corners @ K.T)
            uv = uv[:, :2] / uv[:, 2:3]
            inside = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
            if not inside.any():
                continue
            color = CLASS_COLORS.get(t.get("tracking_name", "car"), (1.0, 0.0, 0.0))
            _draw_wire_box(
                ax, uv, color, label=t.get("tracking_id") if with_ids else None
            )
        ax.set_xlim(0, W)
        ax.set_ylim(H, 0)
        ax.axis("off")
        ax.set_title(f"{channel} (tracks)")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return out_path


def render_scene(
    db: NuscDB,
    scene_name: str,
    tracking_result_path: str,
    save_path: str,
    render_class: str | None = "car",
    channels: tuple = ("LIDAR_TOP", "CAM_FRONT"),
    nsweeps: int = 10,
    underlay_map: bool = True,
) -> list[str]:
    """visualize.py main() equivalent: render every key frame of a scene.

    Outputs {save_path}/{channel_dir}/{scene}/{timestamp}.png, mirroring the
    reference's lidar/ + front-camera/ layout. Returns written paths."""
    scene = next(s for s in db.table("scene") if s["name"] == scene_name)
    tracks_by_token = load_tracks(tracking_result_path)
    r = SceneRenderer(db)
    written = []
    for sample in db.scene_samples(scene):
        tok = sample["token"]
        tracks = tracks_by_token.get(tok, [])
        if render_class:
            tracks = [t for t in tracks if t.get("tracking_name") == render_class]
        ts = sample["timestamp"]
        for channel in channels:
            sub = "lidar" if channel == "LIDAR_TOP" else channel.lower().replace("cam_", "") + "-camera"
            out = os.path.join(save_path, sub, scene_name, f"{ts}.png")
            if channel == "LIDAR_TOP":
                written.append(r.render_lidar_bev(
                    tok, tracks, out, nsweeps=nsweeps, underlay_map=underlay_map,
                    gt_class=render_class,
                ))
            else:
                p = r.render_camera(tok, tracks, out, channel=channel)
                if p:
                    written.append(p)
    return written
