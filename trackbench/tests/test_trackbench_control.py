"""The control on the card at a small size: the program with its bf16
trunk reads `correct: false`, as configured (f32) `correct: true`. At the
cells' own size: `python3 -m trackbench.control` (§2 of PERF.md)."""
import pytest
import torch

from trackbench import run
from trackbench.tests.small import load, small
from trackbench.tests.test_trackbench_reference import CELLS, e2e_of


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bf16_trunk_fails_and_f32_holds(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    cfg, mix = small(*CELLS[cell])
    limits = load("limits", cell)
    for dtype, want in ((None, True), (torch.bfloat16, False)):
        out = run.run_cell(cfg, mix, 2**31 + 41, 2.0, False, "cuda", e2e_of(cell), [],
                           dtype=dtype)
        assert all(out["compared"][k] <= limits[k] for k in limits) == want, (dtype, out)
