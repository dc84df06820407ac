"""The neck's conv kernel route (models/rpn.py `kernel_route`,
ops/kernels/dense_conv.py): its plain version against the modules' `_run`,
the route's condition, and the kernel against its plain version on the card.

The file imports no JAX, so its card tests also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_neck_kernel.py
"""
import pytest
import torch
from torch import nn

from shasta_tpu_torch.models import rpn as rpn_mod
from shasta_tpu_torch.models.rpn import RPN, SharedConv, fusable
from shasta_tpu_torch.ops.kernels import dense_conv as dc

SMALL = dict(layer_nums=(5, 5), ds_num_filters=(32, 64), us_num_filters=(64, 64),
             num_input_features=32)


def randomize(module: nn.Module, seed: int) -> nn.Module:
    """Weights N(0, 1/fan_in); BN scales, shifts, means and variances drawn
    away from their defaults; eval mode."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) else m.weight.shape[0]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    return module.eval()


def small_neck(seed=0):
    return randomize(RPN(**SMALL), seed), randomize(SharedConv(128, 64), seed + 1)


def run_neck(neck, shared, x):
    """The modules' `_run` route, whatever the input."""
    ups = []
    for blk, de in zip(neck.blocks, neck.deblocks):
        x = rpn_mod._run(blk, x, neck.dtype)
        ups.append(rpn_mod._run(de, x, neck.dtype))
    return rpn_mod._run(shared, torch.cat(ups, dim=1), shared.dtype)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The kernel route taken on the CPU, where the wrapper runs its plain
    version: the route's packing, buffer and layout without a card."""
    monkeypatch.setattr(rpn_mod, "kernel_route", fusable)


@pytest.mark.parametrize("B,H,W", [(1, 10, 14), (2, 6, 18)])
def test_fused_plain_neck_equals_run(fused_on_cpu, B, H, W):
    """BN folded to scale and shift, the deconv as a GEMM with a 2x2 store,
    both deblocks in one buffer: the fused route equals `_run` at 1e-5 (the
    second block's grid is odd: 5 x 7, 3 x 9)."""
    neck, shared = small_neck()
    x = torch.randn(B, 32, H, W, generator=torch.Generator().manual_seed(B))
    with torch.no_grad():
        want = run_neck(neck, shared, x)
        maps = neck(x)
        got = shared(maps)
    assert maps.shape == (B, 128, H, W) and maps.permute(0, 2, 3, 1).is_contiguous()
    assert got.shape == (B, 64, H, W) and got.permute(0, 2, 3, 1).is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _conv_cases():
    """(name, conv, BN, pad): each kind of the neck's convs, ReLU after."""
    return [("block conv, stride 1", nn.Conv2d(32, 64, 3, padding=1, bias=False), 1e-3, 0),
            ("first conv, stride 2", nn.Conv2d(32, 64, 3, stride=2, bias=False), 1e-3, 1),
            ("1x1 deblock", nn.Conv2d(32, 64, 1, bias=False), 1e-3, 0),
            ("2x2 deconv", nn.ConvTranspose2d(32, 64, 2, stride=2, bias=False), 1e-3, 0),
            ("shared conv, bias", nn.Conv2d(32, 64, 3, padding=1, bias=True), 1e-5, 0)]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("B", [1, 2])
def test_each_fused_conv_plain_equals_module(case, B):
    """dense_conv on the CPU (its plain version) against pad, conv, BN and
    ReLU as modules, on odd H and W, into a wider buffer's channel range."""
    _, conv, eps, pad = _conv_cases()[case]
    seq = randomize(nn.Sequential(nn.ZeroPad2d(pad), conv,
                                  nn.BatchNorm2d(64, eps=eps), nn.ReLU()), case)
    x = torch.randn(B, 32, 7, 9, generator=torch.Generator().manual_seed(case))
    with torch.no_grad():
        want = seq(x).permute(0, 2, 3, 1)
        p = dc.pack(conv, seq[2], pad)
        got = dc.dense_conv(x.permute(0, 2, 3, 1).contiguous(), p)
        buf = torch.full((*want.shape[:3], 128), 7.0)
        dc.dense_conv(x.permute(0, 2, 3, 1).contiguous(), p, buf, 64)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(buf[..., 64:], want, atol=1e-5, rtol=1e-5)
    assert bool((buf[..., :64] == 7.0).all())


def test_route_selection(monkeypatch):
    """Grad recording, a BN in train mode and bf16 each take `_run`; f32
    inference takes the fused route, 15 convs a neck (12 + 2 deblocks +
    the shared conv), whether grad mode is off or nothing requires grad."""
    calls = {"run": 0, "fused": 0}
    run, plain = rpn_mod._run, dc.dense_conv_plain

    def counted_run(*a, **k):
        calls["run"] += 1
        return run(*a, **k)

    def counted_plain(*a, **k):
        calls["fused"] += 1
        return plain(*a, **k)
    monkeypatch.setattr(rpn_mod, "_run", counted_run)
    monkeypatch.setattr(dc, "dense_conv_plain", counted_plain)
    monkeypatch.setattr(rpn_mod, "kernel_route", fusable)
    neck, shared = small_neck()
    x = torch.randn(1, 32, 6, 6)

    def route(fn):
        calls.update(run=0, fused=0)
        fn()
        assert not (calls["run"] and calls["fused"])
        return "fused" if calls["fused"] else "run"

    def both():
        shared(neck(x))
    with torch.no_grad():
        assert route(both) == "fused" and calls["fused"] == 15
    neck.requires_grad_(False)
    shared.requires_grad_(False)
    assert route(both) == "fused"  # grad mode on, nothing requires grad
    assert not fusable(shared, x.requires_grad_(True))
    x.requires_grad_(False)
    shared.requires_grad_(True)  # the trainable shared conv of a train step
    with torch.no_grad():
        maps = neck(x)  # the frozen trunk's maps, an NCHW view of NHWC storage
    assert route(lambda: shared(maps)) == "run" and calls["run"] == 1
    with torch.no_grad():
        neck.blocks[1][2].train()  # one BN in train mode (bn_train)
        assert route(lambda: neck(x)) == "run"
        neck.eval()
        bf = RPN(**SMALL, dtype=torch.bfloat16).eval()
        assert route(lambda: bf(x)) == "run"
        assert not fusable(neck, x.to(torch.bfloat16))
        assert route(lambda: neck(x)) == "fused"


def test_packs_follow_the_weights(fused_on_cpu):
    """The packed weights are made again after an in-place update of a BN
    statistic or a weight, and after load_state_dict."""
    neck, shared = small_neck()
    x = torch.randn(1, 32, 6, 10)
    with torch.no_grad():
        shared(neck(x))
        neck.blocks[0][5].running_var.mul_(2.0)
        shared[0].weight.mul_(-1.0)
        torch.testing.assert_close(shared(neck(x)), run_neck(neck, shared, x),
                                   atol=1e-5, rtol=1e-5)
        other, other_shared = small_neck(seed=5)
        neck.load_state_dict(other.state_dict())
        torch.testing.assert_close(shared(neck(x)), run_neck(other, shared, x),
                                   atol=1e-5, rtol=1e-5)


def test_wrapper_checks():
    """Shapes, dtypes and buffers the kernel cannot take are refused, on
    every device; autograd is refused as by the other kernels."""
    conv, bn = nn.Conv2d(32, 64, 3, padding=1, bias=False), nn.BatchNorm2d(64).eval()
    p = dc.pack(conv, bn)
    x = torch.randn(1, 5, 5, 32)
    with pytest.raises(ValueError):
        dc.dense_conv(x.permute(0, 3, 1, 2), p)  # not channels last
    with pytest.raises(ValueError):
        dc.dense_conv(torch.randn(1, 5, 5, 16), p)  # Cin differs
    with pytest.raises(TypeError):
        dc.dense_conv(x.double(), p)
    with pytest.raises(ValueError):
        dc.dense_conv(x, p, torch.zeros(1, 5, 5, 100), 40)  # channels past the buffer
    with pytest.raises(ValueError):
        dc.dense_conv(x, p, torch.zeros(1, 4, 5, 128), 0)  # another grid
    with pytest.raises(ValueError):
        dc.pack(nn.Conv2d(32, 64, 3, dilation=2), bn)
    with pytest.raises(RuntimeError, match="no backward"):
        dc.dense_conv(x.requires_grad_(True), p)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
def test_neck_kernel_matches_plain_on_the_card(B):
    """At the car neck's shapes (256 x 180 x 180): each of the 15 convs and
    the whole neck against the plain version on the card (cuDNN, TF32 off)
    within 1e-4 x max(1, |out|); 15 launches a neck call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import neck_convs, random_neck
    from shasta_tpu_torch import resolve_device

    neck, shared = random_neck(resolve_device("cuda"))
    x = torch.randn(B, 256, 180, 180, generator=torch.Generator().manual_seed(B)).cuda()
    with torch.no_grad():
        for name, h, p, _ in neck_convs(neck, shared, x):
            want = dc.dense_conv_plain(h, p)
            got = dc.dense_conv(h, p)
            err = (got - want).abs().max().item()
            assert err <= 1e-4 * max(1.0, want.abs().max().item()), (name, err)
        before = dc.dense_conv.launches
        got = shared(neck(x))
        assert dc.dense_conv.launches - before == 15
        want = run_neck(neck, shared, x)
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
