"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip elsewhere; the file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from shasta_tpu_torch import resolve_device


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """Both CUDA kernels against their plain versions on the card, f32
    (TF32 off) at 1e-4 and bf16 at 2e-2 (python3 chip_smoke.py runs the
    same comparison at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.block_conv import rulebook_conv, rulebook_conv_plain
    from shasta_tpu_torch.ops.kernels.window_conv import keyed_conv, keyed_conv_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    V, M = 3000, 2000
    for cin, co, K in ((5, 16, 27), (16, 32, 27), (64, 128, 27), (128, 128, 3)):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            f = torch.randn(V, cin, generator=g).to(dev, dt)
            w = (torch.randn(K, cin, co, generator=g) * 0.1).to(dev, dt)
            nbr = torch.randint(-1, V, (M, K), generator=g, dtype=torch.int32).to(dev)
            torch.testing.assert_close(rulebook_conv(f, nbr, w),
                                       rulebook_conv_plain(f, nbr, w), atol=tol, rtol=tol)
            keys = torch.sort(torch.randint(0, 4 * V, (V,), generator=g,
                                            dtype=torch.int32))[0].to(dev)
            perm = torch.randperm(V, generator=g).to(torch.int32).to(dev)
            q = torch.randint(-2, 4 * V, (M, K), generator=g, dtype=torch.int32).to(dev)
            torch.testing.assert_close(keyed_conv(keys, perm, q, f, w),
                                       keyed_conv_plain(keys, perm, q, f, w),
                                       atol=tol, rtol=tol)


def _voxels(g, shape, n, V):
    """n distinct cells of `shape`, key-sorted, in a V-row B=1 tensor whose
    tail rows are padding (the filler key's run), on the CPU."""
    from shasta_tpu_torch.ops import sparse as sp

    Z, Y, X = shape
    cells = torch.sort(torch.randperm(Z * Y * X, generator=g)[:n])[0]
    coords = torch.zeros((V, 4), dtype=torch.int32)
    coords[:n, 1], coords[:n, 2], coords[:n, 3] = cells // (Y * X), (cells // X) % Y, cells % X
    return sp.SparseTensor(None, coords, torch.arange(V) < n, shape, 1)


@pytest.mark.gpu
def test_b1_conv_kernels_on_their_cores_on_the_card():
    """keyed_conv and rulebook_conv against their plain versions on the
    card, f32 (TF32 off) at 1e-4 and bf16 at 2e-2; a second bf16 run gives
    the same bits. keyed_conv's queries are the B=1 step's: subm_queries and
    strided_queries (DOWN, down3's (0,1,1) padding, the extra conv's K=3)
    of key-sorted voxels with a filler run at the tail, in key order (the
    staged core's triple path) and shuffled, over a table with duplicate
    keys whose physical rows are shuffled; M is not a multiple of 128, and
    the widths reach both tensor-core cores.
    rulebook_conv takes the sparse hit patterns of gather_conv's test,
    with one all-miss tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops import sparse as sp
    from shasta_tpu_torch.ops.kernels.block_conv import rulebook_conv, rulebook_conv_plain
    from shasta_tpu_torch.ops.kernels.gather_conv import MMA_CORES, mma_core
    from shasta_tpu_torch.ops.kernels.window_conv import keyed_conv, keyed_conv_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def check(kern, plain, idx, cin, co, K, V, tag):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            f = torch.randn(V, cin, generator=g).to(dev, dt)
            w = (torch.randn(K, cin, co, generator=g) * 0.1).to(dev, dt)
            got = kern(*idx, f, w)
            torch.testing.assert_close(got, plain(*idx, f, w), atol=tol, rtol=tol)
            if dt == torch.bfloat16:
                assert torch.equal(kern(*idx, f, w), got), tag
        return got

    cores = set()
    shape, n, V = (16, 72, 72), 18000, 18500
    st = _voxels(g, shape, n, V)
    phys = torch.randperm(V, generator=g)  # physical row j holds sorted row phys[j]
    coords, at = st.coords[phys].clone(), torch.argsort(phys)
    coords[at[100:140]] = st.coords[:40]  # 40 keys on two physical rows each
    table = [t.to(dev) for t in sp.key_table(st._replace(coords=coords, valid=st.valid[phys]))]
    cases = [("subm", sp.subm_queries(st), ((64, 64), (64, 128), (128, 128), (16, 32)))]
    for geom in (((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
                 ((3, 1, 1), (2, 1, 1), (0, 0, 0))):
        plan = sp.build_strided_plan(st, *geom, 4999, sp.key_table(st))
        q = sp.strided_queries(plan.coords, plan.valid, shape, *geom)
        cases.append((f"strided {geom}", q, ((64, 128), (128, 128))))
    for tag, q, widths in cases:
        M, K = q.shape
        assert M % 128
        for order, qq in (("key order", q), ("shuffled", q[torch.randperm(M, generator=g)])):
            for cin, co in widths:
                cores.add(mma_core(K, cin, co, torch.bfloat16))
                check(keyed_conv, keyed_conv_plain, (*table, qq.to(dev)), cin, co, K, V,
                      (tag, order, cin, co))
    assert cores == set(MMA_CORES), cores

    V, M = 3000, 1999
    for cin, co in ((5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 128)):
        for pattern in ("centre_only", "three_per_row", "all_taps"):
            nbr = torch.randint(0, V, (M, 27), generator=g, dtype=torch.int32)
            if pattern == "centre_only":
                keep = torch.zeros((M, 27), dtype=torch.bool)
                keep[:, 13] = True
            else:
                keep = torch.rand((M, 27), generator=g) < (3.0 / 27 if pattern ==
                                                          "three_per_row" else 2.0)
            miss = torch.where(torch.rand((M, 27), generator=g) < 0.5, V, -1).to(torch.int32)
            nbr = torch.where(keep, nbr, miss)
            nbr[256:512] = -1  # one warp-core block and two staged tiles with no hit
            got = check(lambda i, f, w: rulebook_conv(f, i, w),
                        lambda i, f, w: rulebook_conv_plain(f, i, w),
                        (nbr.to(dev),), cin, co, 27, V, (cin, co, pattern))
            assert got[256:512].abs().max() == 0


TRUNK_WIDTHS = ((5, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27),
                (64, 64, 27), (64, 128, 27), (128, 128, 27), (128, 128, 3))


@pytest.mark.gpu
def test_f32_route_of_the_three_convs_on_the_card():
    """The f32 route (3xTF32 on the tensor cores) of gather_conv,
    rulebook_conv and keyed_conv against their plain versions on the card
    (TF32 off) within 1e-4 x max(1, |out|), and a second f32 run giving the
    same bits, at every trunk width (both cores: f32 leaves the warp core
    after 32 -> 32), at 1 and 7 hits per row of 27 taps. Misses are rows >=
    V and < 0 (keyed_conv: -2, SENTINEL and keys the table lacks), rows
    256-511 miss every tap (a warp-core block, two staged tiles), M is not a
    multiple of either core's tile, and keyed_conv's perm is shuffled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.block_conv import rulebook_conv, rulebook_conv_plain
    from shasta_tpu_torch.ops.kernels.gather_conv import (MMA_CORES, gather_conv,
                                                          gather_conv_plain, mma_core)
    from shasta_tpu_torch.ops.kernels.lookup import SENTINEL
    from shasta_tpu_torch.ops.kernels.window_conv import keyed_conv, keyed_conv_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    V, M = 3000, 1999
    keys = 2 * torch.sort(torch.randperm(8 * V, generator=g)[:V])[0].to(torch.int32)  # even
    perm = torch.randperm(V, generator=g).to(torch.int32)  # sorted row i is feats[perm[i]]
    key_of_row = torch.empty(V, dtype=torch.int32)
    key_of_row[perm.long()] = keys
    table = (keys.to(dev), perm.to(dev))
    cores = set()
    for cin, co, K in TRUNK_WIDTHS:
        cores.add(mma_core(K, cin, co, torch.float32))
        for hits in (1.0, 7.0):
            rows = torch.randint(0, V, (M, K), generator=g, dtype=torch.int32)
            miss = torch.rand((M, K), generator=g) >= hits / 27
            miss[256:512] = True
            kind = torch.randint(0, 3, (M, K), generator=g)
            rows = torch.where(miss, torch.where(kind == 0, -1, V + kind), rows).to(torch.int32)
            q = torch.where(miss, torch.where(kind == 0, -2, torch.where(
                kind == 1, SENTINEL, 2 * torch.randint(0, 8 * V, (M, K), generator=g) + 1)),
                key_of_row[rows.clamp(0, V - 1).long()]).to(torch.int32)
            f = torch.randn(V, cin, generator=g).to(dev)
            w = (torch.randn(K, cin, co, generator=g) / (K * cin) ** 0.5).to(dev)
            rows, q = rows.to(dev), q.to(dev)
            for name, kern, plain in (
                    ("gather_conv", lambda: gather_conv(f, rows, w),
                     lambda: gather_conv_plain(f, rows, w)),
                    ("rulebook_conv", lambda: rulebook_conv(f, rows, w),
                     lambda: rulebook_conv_plain(f, rows, w)),
                    ("keyed_conv", lambda: keyed_conv(*table, q, f, w),
                     lambda: keyed_conv_plain(*table, q, f, w))):
                got, want = kern(), plain()
                tag = (name, cin, co, K, hits)
                err = float((got - want).abs().max())
                assert err <= 1e-4 * max(1.0, float(want.abs().max())), (tag, err)
                assert got[256:512].abs().max() == 0, tag
                assert torch.equal(kern(), got), tag
    assert cores == set(MMA_CORES), cores


@pytest.mark.gpu
def test_scene_batched_kernels_match_plain_versions_on_the_card():
    """sorted_lookup in its three modes (exact) and gather_conv, f32 (TF32
    off) at 1e-4 and bf16 at 2e-2, against their plain versions on the
    card (chip_smoke.py phase 3b runs them at the 4-lane step's shapes).
    Lookups: queries in key order (a warp finds its probes among the keys
    it staged in shared memory) and shuffled (it searches the global
    table), over a table with a filler run and the int32 edges. Convs: the sparse hit patterns the
    tensor-core kernel compacts, M not a multiple of its tile; a second
    bf16 run gives the same bits (no atomics in the sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.gather_conv import gather_conv, gather_conv_plain
    from shasta_tpu_torch.ops.kernels.lookup import sorted_lookup, sorted_lookup_plain

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    V, M = 3000, 2000
    keys = torch.sort(torch.randint(0, 2 * V, (V,), generator=g, dtype=torch.int32))[0]
    keys[-200:] = 2 * V  # a run of equal filler keys
    keys[:2] = torch.tensor([-2**31, -2**31 + 1], dtype=torch.int32)
    keys[-3:] = torch.tensor([2**31 - 2, 2**31 - 1, 2**31 - 1], dtype=torch.int32)
    perm = torch.randperm(V, generator=g).to(torch.int32)
    q = torch.randint(-2, 2 * V + 2, (M, 9), generator=g, dtype=torch.int32)
    q[::7] = 2**31 - 1
    q[1::97] = 2 * V - 1  # c + 1 is the filler key
    q[3, :3] = torch.tensor([-2**31, -2**31 + 1, 2**31 - 2], dtype=torch.int32)
    ascending = torch.sort(q, dim=0)[0]
    for order, qq in (("ascending", ascending), ("shuffled", q)):
        for mode, p in (("plain", perm), ("triple", perm), ("identity", None)):
            args = (keys, p, qq, mode)
            want = sorted_lookup_plain(*args)
            got = sorted_lookup(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
            assert torch.equal(got.cpu(), want), (order, mode)
    M = 1999
    for cin, co, K in ((5, 16, 27), (16, 32, 27), (64, 128, 27), (128, 128, 27),
                       (128, 128, 3)):
        for pattern in ("centre_only", "three_per_row", "all_taps"):
            rows = torch.randint(0, V, (M, K), generator=g, dtype=torch.int32)
            if pattern == "centre_only":
                keep = torch.zeros((M, K), dtype=torch.bool)
                keep[:, K // 2] = True
            else:
                keep = torch.rand((M, K), generator=g) < (3.0 / K if pattern ==
                                                         "three_per_row" else 2.0)
            miss = torch.where(torch.rand((M, K), generator=g) < 0.5, V, -1).to(torch.int32)
            rows = torch.where(keep, rows, miss)
            rows[128:256] = V  # one 128-row tile and two 64-row tiles with no hit
            rows = rows.to(dev)
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                f = torch.randn(V, cin, generator=g).to(dev, dt)
                w = (torch.randn(K, cin, co, generator=g) * 0.1).to(dev, dt)
                got = gather_conv(f, rows, w)
                torch.testing.assert_close(got, gather_conv_plain(f, rows, w), atol=tol,
                                           rtol=tol)
                assert got[128:256].abs().max() == 0
                if dt == torch.bfloat16:
                    assert torch.equal(gather_conv(f, rows, w), got), (cin, co, K, pattern)


@pytest.mark.gpu
def test_block_extract_matches_its_plain_version_on_the_card():
    """block_extract in all five variants against its plain version on the
    card, f32 (TF32 off) at atol/rtol 1e-5, with a second run giving the same
    bits: both probe geometries at V=8192 on rows that hit, the dup recipe's
    overlapping windows, and what the kernel's tiling could break: tiles of
    32, 64 and 256 rows (blocks take 64 rows, 128 for ohonly), NBWL 48 (not
    a multiple of 32), C = 5 and 32, H = 1 and 4, bases below 0 and at or
    above NBr, and a tile where no row hits (chip_smoke.py phase 8 runs the
    probe's full shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels.block_extract import (VARIANTS, block_extract,
                                                            block_extract_plain)
    from shasta_tpu_torch.probe_block_conv import probe_inputs

    dev = resolve_device("cuda")
    for C, H, NBWL, tile, recipe in ((16, 4, 128, 128, "hit"), (32, 2, 256, 128, "hit"),
                                     (16, 4, 128, 128, "dup"), (5, 1, 48, 32, "hit"),
                                     (32, 1, 48, 64, "hit"), (16, 4, 128, 256, "dup"),
                                     (32, 2, 256, 256, "hit"), (5, 4, 128, 64, "hit")):
        a = probe_inputs(8192, C, H, NBWL, tile, 0, recipe)
        NBr = a["sg1"].shape[0]
        a["bases"][0, ::2] = -3
        a["bases"][-1] = NBr + 2
        a["bases"][-2, 1::2] = NBr
        a["q"][tile:2 * tile] = -2**31 + 5  # tile 1: no window holds these rows
        args = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        for variant in VARIANTS:
            kw = dict(H=H, C=C, tile=tile, variant=variant)
            tag = (C, H, NBWL, tile, recipe, variant)
            want = block_extract_plain(**args, **kw)
            # overlapping windows sum two blocks' keys: eq, so noselect and
            # full, are then zero
            assert recipe == "dup" or want.abs().sum() > 0, tag
            got = block_extract(**args, **kw)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=str(tag))
            assert torch.equal(block_extract(**args, **kw), got), tag
            assert got[tile:2 * tile].abs().max() == 0, tag


@pytest.mark.gpu
def test_eval_step_8_lanes_cuda_equals_cpu():
    """Two 8-lane steps of the batched eval (EvalLanes, the step of
    `tools.eval`) on cuda equal the same steps on cpu at a small config:
    decision flags exact, fn_ref and ref at 1e-4. The second step scores
    each lane against its carried descriptors; lanes 6 and 7 idle on it
    (reset, no dets) as the eval loop's idle lanes do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.infer import FRAME_KEYS
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel
    from shasta_tpu_torch.tracker.runner import EvalLanes

    lanes = 8
    cfg = ShastaConfig(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
                       cap_conv2=8000, cap_conv3=4000, cap_conv4=2000, cap_extra=2000)
    steps = [{k: np.concatenate([make_batch(cfg, num_voxels_cap=2500, n_dets=7,
                                            seed=10 * lane + t)[k] for lane in range(lanes)])
              for k in FRAME_KEYS} for t in range(2)]
    resets = [[True] * lanes, [False] * 6 + [True] * 2]
    n_currs = [[7] * lanes, [7] * 6 + [0] * 2]
    rows = {}
    for d in ("cuda", "cpu"):
        model = ShastaModel(cfg, device=resolve_device(d))
        load_jax_variables(model, random_jax_variables(model, seed=1))
        sd = model.state_dict()  # a decisive head, so that decisions fire
        sd["aff.10.weight"] *= 10.0
        sd["aff.10.bias"][-2:] += 5.0
        model.load_state_dict(sd)
        step = EvalLanes(model, lanes)
        rows[d] = [step.step_chunk({k: v[None] for k, v in f.items()}, [r], [n]).array()[0]
                   for f, r, n in zip(steps, resets, n_currs)]
    for t, (got, want) in enumerate(zip(rows["cuda"], rows["cpu"])):
        assert got.shape == (lanes, 6, 10)
        flags = [0, 1, 3, 4]  # dead, fn, keep, newborn
        assert np.array_equal(got[:, flags], want[:, flags]), t
        np.testing.assert_allclose(got[:, [2, 5]], want[:, [2, 5]], atol=1e-4, rtol=0)
    assert rows["cpu"][1][:, [0, 1, 4]].any()  # some dead, fn or newborn flag fired


@pytest.mark.gpu
def test_kernel_wrappers_refuse_autograd_on_the_card():
    """On CUDA tensors that require grad, with grad mode on, each of the
    five wrappers raises before it launches (a ctypes launch would cut the
    graph); under no_grad the same call launches its kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.ops.kernels import block_conv, block_extract, gather_conv, lookup
    from shasta_tpu_torch.ops.kernels import window_conv

    dev = resolve_device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    V, M, K, C = 300, 200, 27, 16
    f = torch.randn(V, C, generator=g).to(dev).requires_grad_()
    w = (torch.randn(K, C, C, generator=g) * 0.1).to(dev).requires_grad_()
    idx = torch.randint(-1, V, (M, K), generator=g, dtype=torch.int32).to(dev)
    keys = torch.sort(torch.randint(0, 4 * V, (V,), generator=g, dtype=torch.int32))[0].to(dev)
    perm = torch.randperm(V, generator=g).to(torch.int32).to(dev)
    q = torch.randint(0, 4 * V, (M, K), generator=g, dtype=torch.int32).to(dev)
    calls = {block_conv.rulebook_conv: lambda: block_conv.rulebook_conv(f, idx, w),
             gather_conv.gather_conv: lambda: gather_conv.gather_conv(f, idx, w),
             window_conv.keyed_conv: lambda: window_conv.keyed_conv(keys, perm, q, f, w)}
    for kernel, call in calls.items():
        n = kernel.launches
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        assert kernel.launches == n
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        assert out.grad_fn is None and kernel.launches == n + 1
    with pytest.raises(RuntimeError, match="sorted_lookup has no backward"):
        lookup.sorted_lookup(keys, perm, q.float().requires_grad_(), "plain")
    with pytest.raises(RuntimeError, match="block_extract has no backward"):
        block_extract.block_extract(*[torch.zeros(1, device=dev)] * 5,
                                    torch.zeros(1, device=dev, requires_grad=True),
                                    torch.zeros(1, device=dev), H=1, C=1, tile=128,
                                    variant="full")


def _dp_rank(rank, world, port, device_type, out):
    """One rank of test_data_parallel_step_over_cards (module level: the
    spawned process imports it)."""
    import os

    from shasta_tpu_torch.parallel import dist as pdist
    from shasta_tpu_torch.train import loop

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = pdist.init_from_env(device_type)
    model, batch = _dp_setup(dev, world)
    tx = loop.make_optimizer(model, 1e-3, 1e-2)
    state = loop.create_train_state(model, tx)
    state, m = loop.make_train_step(model, tx)(state, {k: v[rank::world] for k, v in batch.items()})
    torch.save({"sd": {k: v.cpu() for k, v in model.state_dict().items()},
                "loss": float(m["loss"])}, os.path.join(out, f"rank{rank}.pt"))
    pdist.shutdown()


def _dp_setup(dev, world):
    """A small model (seeded random weights) and 2 frame pairs per rank."""
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.models import ShastaConfig, ShastaModel

    cfg = ShastaConfig(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
                       cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)
    model = ShastaModel(cfg, device=dev)
    load_jax_variables(model, random_jax_variables(model, seed=4))
    batch = make_batch(cfg, 2 * world, 2500, n_dets=7, with_gt=True, seed=8)
    for key in ("det_boxes", "prev_det_boxes"):
        batch[key][:, :, :2] = -3.0 + (batch[key][:, :, :2] + 50.0) / 100.0 * 5.4
    return model, batch


def run_data_parallel_step(device_type, world, tmp_path):
    """`world` processes (NCCL on cards, gloo on the CPU), each one train
    step on its 2 pairs with the frozen trunk's kernels: every rank ends
    with the same bits, and they equal one process that averages the
    ranks' losses and grads before the same update (params within 2*lr:
    only the all-reduce's order of summation differs)."""
    import socket

    import torch.multiprocessing as mp

    from shasta_tpu_torch.device import upload
    from shasta_tpu_torch.train import loop

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, world, port, device_type, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    assert not alive and [p.exitcode for p in procs] == [0] * world
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        assert all(torch.equal(v, ranks[0]["sd"][k]) for k, v in r["sd"].items())

    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    model, batch = _dp_setup(dev, world)
    tx = loop.make_optimizer(model, 1e-3, 1e-2)
    losses = []
    for r in range(world):  # grads accumulate over the shards
        shard = {k: upload(batch[k][r::world], dev) for k in loop.PAIR_KEYS}
        loss = loop.bidirectional_ce(*loop.pair_forward(model, shard), shard["gt"])
        loss.backward()
        losses.append(loss.item())
    for g in tx.grads():
        g /= world
    tx.step()
    assert abs(ranks[0]["loss"] - sum(losses) / world) <= 1e-5 * abs(ranks[0]["loss"])
    for k, v in model.state_dict().items():
        torch.testing.assert_close(ranks[0]["sd"][k], v.cpu(), atol=2e-3, rtol=0, msg=k)


@pytest.mark.gpu
def test_data_parallel_step_over_cards(tmp_path):
    """One train step data-parallel over every card of the machine (one
    process per card, NCCL), as torchrun runs tools.train; needs two
    cards or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    run_data_parallel_step("cuda", torch.cuda.device_count(), tmp_path)


@pytest.mark.gpu
def test_mot_distance_matrices_on_the_card(tmp_path):
    """association.compute_distance_matrix for iou and giou on the card
    equals the CPU result at 1e-5, on a frame of a small synthetic world
    (its detections against the previous frame's), and the oracle
    tracker's MOTModel gives the same tracks on both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    import numpy as np

    from shasta_tpu_torch.data.synthetic import build_synthetic_world
    from shasta_tpu_torch.mot import FrameData, MOTModel
    from shasta_tpu_torch.mot.association import compute_distance_matrix
    from shasta_tpu_torch.preprocessing.gt_shasta import mot_rows

    fx = build_synthetic_world(tmp_path, n_scenes=1, n_frames=6, n_objects=20, fp_per_frame=20)
    with open(fx["results"]) as f:
        results = json.load(f)["results"]
    frames = [mot_rows([d["translation"] + d["size"] + d["rotation"] + [d["detection_score"]]
                        for d in results[f"s0f{i}"]]) for i in range(6)]
    for kind in ("iou", "giou"):
        for prev, curr in zip(frames, frames[1:]):
            got = compute_distance_matrix(curr, prev, kind, device="cuda")
            want = compute_distance_matrix(curr, prev, kind, device="cpu")
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    tracks = {}
    for dev in ("cuda", "cpu"):
        model = MOTModel(device=dev)
        tracks[dev] = [[(tid, s) for _, tid, s, _ in model.frame_mot(
            FrameData(dets=d, det_types=["car"] * len(d), time_stamp=0.5 * i))]
            for i, d in enumerate(frames)]
    assert tracks["cuda"] == tracks["cpu"]


@pytest.mark.gpu
def test_waymo_tracking_on_the_card(tmp_path):
    """One synthetic Waymo segment through the port's extraction, then
    load_waymo_scene -> waymo_scene_to_mot_frames -> MOTModel on the card
    and on the CPU: per-frame track ids and eval_waymo_tracking's summaries
    exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shasta_tpu_torch.data.synthetic import build_synthetic_waymo
    from shasta_tpu_torch.data.waymo import (eval_waymo_tracking, load_waymo_scene,
                                             waymo_scene_to_mot_frames)
    from shasta_tpu_torch.mot import MOTModel
    from shasta_tpu_torch.tools import extract_waymo

    raw = build_synthetic_waymo(tmp_path / "raw", n_segments=1, n_frames=8, top_hw=(16, 256),
                                side_hw=(8, 64), n_objects=30, dets_per_frame=50)
    out = str(tmp_path / "mot")
    (seg,) = extract_waymo.main(["--data_folder", str(raw["records"]), "--output_folder", out,
                                 "--gt_bin", str(raw["gt_bin"]), "--det_bin", str(raw["det_bin"])])
    ids, summaries = {}, {}
    for dev in ("cuda", "cpu"):
        model = MOTModel(device=dev)
        frames = [[{"id": tid, "bbox": row, "type": typ} for row, tid, _, typ in
                   model.frame_mot(fd)]
                  for fd in waymo_scene_to_mot_frames(load_waymo_scene(out, seg))]
        ids[dev] = [[h["id"] for h in f] for f in frames]
        summaries[dev] = eval_waymo_tracking(out, {seg: frames})
    assert ids["cuda"] == ids["cpu"] and sum(map(len, ids["cpu"])) > 0
    assert summaries["cuda"] == summaries["cpu"]


ZOO_SMALL = dict(max_obj=10, grid_shape=(41, 80, 80), pc_start=(-3.0, -3.0),
                 cap_conv2=2000, cap_conv3=1000, cap_conv4=500, cap_extra=500)


@pytest.mark.gpu
def test_bevmap_kernels_match_its_plain_route_on_the_card():
    """BEVMap at a small config on the card (12 sorted_lookup + 21
    gather_conv launches, f32, TF32 off) against the same weights on the
    CPU, where the kernels' plain versions run: 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.data.synthetic import make_batch
    from shasta_tpu_torch.models import BEVMap, ShastaConfig
    from shasta_tpu_torch.ops.kernels.gather_conv import gather_conv
    from shasta_tpu_torch.ops.kernels.lookup import sorted_lookup

    cfg = ShastaConfig(**ZOO_SMALL)
    frame = {k: v for k, v in make_batch(cfg, num_voxels_cap=3000, n_dets=4, seed=1).items()
             if k in ("voxels", "num_points", "coordinates", "voxels_valid")}
    maps = {}
    for dev in ("cuda", "cpu"):
        bev = BEVMap(cfg, device=dev)
        load_jax_variables(bev, random_jax_variables(bev, seed=3))
        torch.cuda.synchronize()
        before = sorted_lookup.launches, gather_conv.launches
        with torch.no_grad():
            maps[dev] = bev(frame).cpu()
        launched = sorted_lookup.launches - before[0], gather_conv.launches - before[1]
        assert launched == ((12, 21) if dev == "cuda" else (0, 0)), (dev, launched)
    assert maps["cpu"].abs().max() > 0
    torch.testing.assert_close(maps["cuda"], maps["cpu"], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_zoo_modules_cuda_equal_cpu():
    """PillarFeatureNet + point_pillars_scatter (1e-5, the canvas exact),
    dynamic_voxelize and _virtual (coords and valid exact, means 1e-5, one
    overflowing cap), DeformConv2d modulated and not (1e-4) and
    deform_psroi_pooling with its gradients (1e-5, counts exact): the
    same weights and inputs on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from shasta_tpu_torch.convert import load_jax_variables, random_jax_variables
    from shasta_tpu_torch.models import dynamic_voxelize, dynamic_voxelize_virtual
    from shasta_tpu_torch.models.pillars import PillarFeatureNet, point_pillars_scatter
    from shasta_tpu_torch.ops.dcn import DeformConv2d, deform_psroi_pooling

    resolve_device("cuda")  # TF32 off
    rng = np.random.default_rng(0)
    V, P = 500, 12
    vox = rng.normal(size=(V, P, 5)).astype(np.float32) * 10
    npts = rng.integers(0, P + 1, V).astype(np.int32)
    cells = rng.choice(64 * 64, V, replace=False)
    coords = np.stack([np.zeros(V), np.zeros(V), cells // 64, cells % 64], 1).astype(np.int32)
    valid = rng.random(V) > 0.1
    pts = rng.uniform(-2.5, 2.5, (4000, 16)).astype(np.float32)
    pts[:, -2] = rng.choice([1.0, 0.0, -1.0], len(pts))
    x = rng.normal(size=(1, 20, 24, 8)).astype(np.float32)
    data = rng.normal(size=(2, 20, 24, 4 * 9)).astype(np.float32)
    rois = np.array([[0, 1.2, 2.7, 60.0, 50.0], [1, 0.0, 0.0, 28.0, 16.0],
                     [0, -90.0, -90.0, -70.0, -70.0], [1, 10.5, 12.5, 40.5, 30.5]], np.float32)
    trans = rng.normal(size=(4, 2, 3, 3)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        def t(a):
            return torch.from_numpy(a).to(dev)
        o = outs[dev] = {}
        pfn = PillarFeatureNet((32, 32), device=dev).eval()
        load_jax_variables(pfn, random_jax_variables(pfn, seed=1))
        with torch.no_grad():
            o["pfn"] = pfn(t(vox), t(npts), t(coords[:, 1:]))
            o["canvas"] = point_pillars_scatter(o["pfn"], t(coords), t(valid), 1, 64, 64)
        for fn, c in ((dynamic_voxelize, 5), (dynamic_voxelize_virtual, 16)):
            for cap in (2000, 40):
                o[(fn.__name__, cap)] = fn(t(np.ascontiguousarray(pts[:, :c])) if c == 5
                                           else t(pts), t(np.ones(len(pts), bool)),
                                           (-2.0, -2.0, -1.0, 2.0, 2.0, 1.0), (0.25, 0.25, 0.25),
                                           cap)
        for mod in (False, True):
            m = DeformConv2d(8, 6, modulated=mod, device=dev)
            load_jax_variables(m, random_jax_variables(m, seed=2))
            with torch.no_grad():
                o[("dcn", mod)] = m(t(x))
        for tr in (None, trans):
            td = t(data).requires_grad_()
            tt = None if tr is None else t(tr).requires_grad_()
            out, cnt = deform_psroi_pooling(td, t(rois), tt, spatial_scale=0.5, output_dim=4,
                                            group_size=3, pooled_size=3, sample_per_part=2,
                                            trans_std=0.0 if tr is None else 0.2)
            (out ** 2).sum().backward()
            o[("psroi", tr is None)] = (out, cnt, td.grad) + (() if tt is None else (tt.grad,))
    g, w = outs["cuda"], outs["cpu"]
    torch.testing.assert_close(g["pfn"].cpu(), w["pfn"], atol=1e-5, rtol=1e-5)
    assert torch.equal(g["canvas"].cpu(), point_pillars_scatter(
        g["pfn"].cpu(), torch.from_numpy(coords), torch.from_numpy(valid), 1, 64, 64))
    for key in g:
        if isinstance(key, tuple) and key[0].startswith("dynamic"):
            (gm, gc, gv), (wm, wc, wv) = g[key], w[key]
            assert torch.equal(gc.cpu(), wc) and torch.equal(gv.cpu(), wv), key
            torch.testing.assert_close(gm.cpu(), wm, atol=1e-5, rtol=1e-5)
        elif isinstance(key, tuple) and key[0] == "dcn":
            torch.testing.assert_close(g[key].cpu(), w[key], atol=1e-4, rtol=1e-4)
        elif isinstance(key, tuple) and key[0] == "psroi":
            assert torch.equal(g[key][1].cpu(), w[key][1])
            for a, b in zip(g[key][:1] + g[key][2:], w[key][:1] + w[key][2:]):
                torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)
    assert int(w[("dynamic_voxelize", 40)][2].sum()) == 40  # the small cap overflows
