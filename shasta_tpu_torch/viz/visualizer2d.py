"""BEV visualization: point clouds, boxes, tracks; the port of
shasta_tpu/viz/visualizer2d.py (matplotlib on the host, imported when a
renderer is made, so importing this module needs no matplotlib).

Behavioral reference: mot_3d/visualization/visualizer2d.py (matplotlib BEV
box/pc renderer) and nusc_visualize/visualize.py:23 (scene rendering with
per-track coloring). Boxes are mot arrays [x, y, z, o, l, w, h, (s)].
"""
from __future__ import annotations

import numpy as np

from ..mot.bbox import MotBBox


class Visualizer2D:
    COLOR_MAP = {
        "gray": (0.6, 0.6, 0.6),
        "black": (0, 0, 0),
        "red": (0.875, 0.28, 0.3),
        "green": (0.35, 0.7, 0.4),
        "blue": (0.3, 0.45, 0.9),
        "orange": (0.95, 0.6, 0.2),
    }

    def __init__(self, name: str = "", figsize=(8, 8)):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig = plt.figure(figsize=figsize)
        self.ax = self.fig.add_subplot(111)
        self.ax.set_aspect("equal")
        self.ax.set_title(name)

    def handler_pc(self, pc: np.ndarray, color: str = "gray", s: float = 0.2):
        c = self.COLOR_MAP.get(color, color)
        self.ax.scatter(pc[:, 0], pc[:, 1], color=[c], marker="o", s=s)

    def handler_box(self, box: np.ndarray, message: str = "", color: str = "red",
                    linestyle: str = "solid"):
        corners = MotBBox.bev_corners(np.asarray(box))
        corners = np.concatenate([corners, corners[:1]])
        c = self.COLOR_MAP.get(color, color)
        self.ax.plot(corners[:, 0], corners[:, 1], color=c, linestyle=linestyle)
        if message:
            self.ax.text(corners[0, 0] - 1, corners[0, 1] - 1, message, color=c)

    def handler_tracks(self, track_history: dict[int, list[np.ndarray]]):
        """track id -> list of boxes over time; draws trajectories."""
        import matplotlib

        cmap = matplotlib.colormaps["tab20"]
        for tid, boxes in track_history.items():
            c = cmap(tid % 20)
            centers = np.stack([np.asarray(b)[:2] for b in boxes])
            self.ax.plot(centers[:, 0], centers[:, 1], color=c, linewidth=1)
            self.handler_box(boxes[-1], message=str(tid), color=c)

    def save(self, path: str):
        self.fig.savefig(path, dpi=120, bbox_inches="tight")

    def close(self):
        self.plt.close(self.fig)


def render_scene_tracks(results: dict, out_path: str, max_frames: int | None = None):
    """Render a tracking_result.json's trajectories into one BEV figure."""
    from ..core.boxes import quaternion_yaw

    history: dict[str, list[np.ndarray]] = {}
    for fi, (token, annos) in enumerate(sorted(results.items())):
        if max_frames is not None and fi >= max_frames:
            break
        for a in annos:
            b = np.zeros(8)
            b[:3] = a["translation"]
            b[3] = quaternion_yaw(np.asarray(a["rotation"]))
            b[4] = a["size"][1]
            b[5] = a["size"][0]
            b[6] = a["size"][2]
            b[7] = a.get("tracking_score", 0.0)
            history.setdefault(a["tracking_id"], []).append(b)
    viz = Visualizer2D(name="tracks")
    viz.handler_tracks({int(k) if str(k).isdigit() else i: v
                        for i, (k, v) in enumerate(history.items())})
    viz.save(out_path)
    viz.close()
    return out_path
