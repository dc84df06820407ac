"""The port's block_extract (plain version, CPU, f32) against the TPU
kernel `_variant_kernel` of tools/probe_block_conv.py, run by Pallas in
interpret mode, at atol/rtol 1e-5 (both sum the same f32 terms in another
order).

The probe's `_call` takes no `interpret` argument, so the test builds its
own pl.pallas_call around the probe's kernel, with whole-array blocks for
every input but the row tile of q. Inputs come from the port's probe
(shasta_tpu_torch/probe_block_conv.py) at V=1024: rows that hit their key
blocks, windows that overlap (several ones in a row of oh), and the TPU
probe's own recipe, on which every variant returns zeros.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from shasta_tpu_torch.ops.kernels.block_extract import VARIANTS, block_extract
from shasta_tpu_torch.probe_block_conv import probe_inputs

_spec = importlib.util.spec_from_file_location(
    "probe_block_conv", Path(__file__).resolve().parents[1] / "tools" / "probe_block_conv.py")
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

# (V, C, H, NBWL, tile): the two probe geometries at a small V
GEOMS = {"s0": (1024, 16, 4, 128, 128), "s1": (1024, 32, 2, 256, 128)}


def _jax_variant(a: dict, H: int, C: int, tile: int, variant: str) -> np.ndarray:
    Mp, K = a["q"].shape

    def whole(x):
        return pl.BlockSpec(x.shape, lambda t, n=x.ndim: (0,) * n)

    order = ("q", "bases", "sg1", "sg2", "k2q", "f2", "w")
    return np.asarray(pl.pallas_call(
        functools.partial(probe._variant_kernel, H=H, C=C, variant=variant),
        grid=(Mp // tile,),
        in_specs=[pl.BlockSpec((tile, K), lambda t: (t, 0))]
        + [whole(a[k]) for k in order[1:]],
        out_specs=pl.BlockSpec((tile, C), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((Mp, C), jnp.float32),
        interpret=True,
    )(*(jnp.asarray(a[k]) for k in order)))


def _port(a: dict, H: int, C: int, tile: int, variant: str) -> np.ndarray:
    return block_extract(*(torch.from_numpy(a[k]) for k in
                           ("q", "bases", "sg1", "sg2", "k2q", "f2", "w")),
                         H=H, C=C, tile=tile, variant=variant).numpy()


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_extract_matches_the_tpu_kernel_on_rows_that_hit(geom, variant):
    V, C, H, NBWL, tile = GEOMS[geom]
    a = probe_inputs(V, C, H, NBWL, tile, seed=1, recipe="hit")
    want = _jax_variant(a, H, C, tile, variant)
    got = _port(a, H, C, tile, variant)
    # most rows read a block; each variant's output is mostly non-zero
    assert (want != 0).any(1).mean() > 0.3, (want != 0).any(1).mean()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_block_extract_matches_the_tpu_kernel_where_windows_overlap():
    """sg2 reaches into the next block: rows hit two windows, so afeat and
    akey sum two rows (and akey's quarters stop matching)."""
    V, C, H, NBWL, tile = GEOMS["s0"]
    a = probe_inputs(V, C, H, NBWL, tile, seed=2, recipe="dup")
    for variant in VARIANTS:
        want = _jax_variant(a, H, C, tile, variant)
        if variant == "ohonly":  # 9 groups: more than 9 hits means several ones
            assert want[:, 0].max() > 9
        np.testing.assert_allclose(_port(a, H, C, tile, variant), want, atol=1e-5,
                                   rtol=1e-5, err_msg=variant)


def test_block_extract_is_zero_on_the_tpu_probes_own_recipe():
    V, C, H, NBWL, tile = GEOMS["s1"]
    a = probe_inputs(V, C, H, NBWL, tile, seed=3, recipe="probe")
    for variant in VARIANTS:
        want = _jax_variant(a, H, C, tile, variant)
        got = _port(a, H, C, tile, variant)
        assert not want.any() and not got.any(), variant


@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_extract_matches_the_tpu_kernel_at_other_tiles(tile, variant):
    """Tiles of 64 and 256 rows (the kernel's blocks take 64 and 128 rows:
    a tile of 256 is two blocks sharing one guard window)."""
    V, C, H, NBWL, _ = GEOMS["s0"]
    a = probe_inputs(V, C, H, NBWL, tile, seed=4, recipe="hit")
    want = _jax_variant(a, H, C, tile, variant)
    assert variant == "noselect" or (want != 0).any(1).mean() > 0.3
    np.testing.assert_allclose(_port(a, H, C, tile, variant), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_block_extract_clamps_bases_at_or_above_nbr_as_the_tpu_kernel(variant):
    """bases at or above NBr: the TPU kernel's dynamic slices clamp their
    start, so the window is row NBr - 1 of the guards and of f2/k2q; so
    does the port."""
    V, C, H, NBWL, tile = GEOMS["s1"]
    a = probe_inputs(V, C, H, NBWL, tile, seed=5, recipe="hit")
    NBr, T = a["sg1"].shape[0], a["bases"].shape[0]
    a["bases"][0, ::2] = NBr
    a["bases"][T - 2, 1::2] = NBr + 1
    a["bases"][T - 1] = NBr + 7
    want = _jax_variant(a, H, C, tile, variant)
    # the last tile's clamped window still holds rows that hit
    assert variant == "noselect" or want[(T - 1) * tile:].any()
    np.testing.assert_allclose(_port(a, H, C, tile, variant), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("r", ["-1", "-2", "-NBr"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_extract_negative_base_disagrees_with_interpret_mode(variant, r):
    """A negative base, read as interpret mode reads it (the name is that of
    the fault this test pinned until the port followed interpret mode): each
    dynamic slice takes a negative start from the end, then clamps it so its
    window fits, the guard row (r + NBr) and the f2/k2q window (r*16 + NBP,
    clamped to NBP - NBWL) each on its own. So r = -1 and -2 read guard rows
    NBr - 1 and NBr - 2 with the last f2 window, and r = -NBr guard row 0 with
    the window from NBWL - 16. The first and the last tile take the base; the
    port equals interpret mode at 1e-5 in every tile."""
    V, C, H, NBWL, tile = GEOMS["s0"]
    a = probe_inputs(V, C, H, NBWL, tile, seed=6, recipe="hit")
    NBr, T = a["sg1"].shape[0], a["bases"].shape[0]
    a["bases"][[0, T - 1]] = {"-1": -1, "-2": -2, "-NBr": -NBr}[r]
    want = _jax_variant(a, H, C, tile, variant)
    # the base changes what interpret mode reads: against the base clamped
    # to [0, NBr) (the port's earlier reading), the first or last tile differs
    clamped = {k: x.copy() for k, x in a.items()}
    clamped["bases"] = np.clip(a["bases"], 0, NBr - 1)
    ends = np.r_[0:tile, (T - 1) * tile:T * tile]
    assert variant == "ohonly" and r == "-NBr" or \
        np.abs(_jax_variant(clamped, H, C, tile, variant)[ends] - want[ends]).max() > 1e-3
    np.testing.assert_allclose(_port(a, H, C, tile, variant), want, atol=1e-5, rtol=1e-5)
