"""The plain reference against the port on the CPU at a small size: each
cell's run, end to end through the harness, reads within its limits; and
the reference's trunk and neck against the port's layer by layer."""
import json

import pytest
import torch

from trackbench import harness, run
from trackbench.gen.scenes import stream_scenes
from trackbench.reference import model as rm
from trackbench.tests.small import load, small

CELLS = {"car.eval8": ("shasta-car", "eval8"), "car.stream": ("shasta-car", "stream"),
         "nusc7.stream": ("shasta-nusc7", "stream")}


def e2e_of(cell):
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_within_limits_on_cpu(cell):
    cfg, mix = small(*CELLS[cell])
    out = run.run_cell(cfg, mix, 2**31 + 17, 1.0, False, "cpu", e2e_of(cell), [])
    limits = load("limits", cell)
    assert set(out["compared"]) == set(limits)
    assert all(out["compared"][k] <= limits[k] for k in limits), out["compared"]
    assert out["frames"] >= 1


def test_reading_bit_for_bit(tmp_path):
    """The reference's reading of a split against the port's dataset."""
    import numpy as np
    from shasta_tpu_torch.data.nuscenes import NuScenesTrackDataset, PointPipelineConfig

    from trackbench.gen.scenes import write_split
    from trackbench.reference.points import SplitReader

    cfg, mix = small("shasta-car", "eval8")
    pp = cfg["point_pipeline"]
    split = write_split(str(tmp_path), 2**31 + 3, mix, pp, {"car": 10})
    ds = NuScenesTrackDataset(**split["kwargs"], det_type=["car"], max_objects=10,
                              pipeline=PointPipelineConfig(**{
                                  k: tuple(v) if isinstance(v, list) else v
                                  for k, v in dict(pp, shuffle_points=False).items()}))
    meta = ds.metadata()
    reader = SplitReader(split["kwargs"], pp, ["car"], 10)
    for i in range(len(meta)):
        got, want = ds.read_at(i, meta[i]["rng_state"]), reader.frame(i)
        for k in ("voxels", "coordinates", "num_points", "voxels_valid", "det_boxes",
                  "prev_det_boxes"):
            assert np.array_equal(got[k], want[k]), (i, k)
        assert got["cls_det_boxes"] == want["cls_det_boxes"]


def test_trunk_and_neck_layer_by_layer():
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.models.shasta import frame_sparse

    cfg, mix = small("shasta-car", "stream")
    frame = stream_scenes(5, mix, cfg["point_pipeline"], {"car": 10})[0][1]
    trunk, heads = harness.class_weights(cfg, 5, "cpu")
    m = ShastaModel(harness.model_config(ShastaConfig, cfg["model"], max_obj=10), device="cpu")
    m.load_state_dict({**trunk, **heads["car"]})
    arrays = {k: torch.as_tensor(frame[k][None])
              for k in ("voxels", "num_points", "coordinates", "voxels_valid")}
    with torch.no_grad():
        st, _ = frame_sparse(m.cfg, arrays)
        dense = m.backbone(st, None)
        want, sizes = rm.sparse_trunk(trunk, *(arrays[k][0] for k in (
            "voxels", "num_points", "coordinates", "voxels_valid")), cfg["model"]["grid_shape"])
        assert (dense - want).abs().max() <= 1e-5 * max(1.0, float(want.abs().max()))
        bev = m.shared_conv(m.neck(dense)).permute(0, 2, 3, 1)
        ref_bev = rm.neck(trunk, dense)
        assert (bev - ref_bev).abs().max() <= 1e-5 * max(1.0, float(ref_bev.abs().max()))
    assert sizes[0] == int(frame["voxels_valid"].sum())
