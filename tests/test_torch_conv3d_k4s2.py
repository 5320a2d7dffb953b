"""What surrounds the 3D stride-2 convolution kernels (``kernels/conv3d.py``)
and can be checked without a GPU: the forward's plain version against
``F.conv3d`` in float64, the weight repack, the identity the ``Upsample``
backward rests on, both autograd functions (``gradcheck`` through the plain
route), the 3D modules against their parent implementation, the export
route, the launch plan, the operation count, the input checks, and the
kernel's gather arithmetic emulated row by row; for the weight-gradient
kernel its plain version against ``aten.convolution_backward`` in float64,
the autograd functions' weight gradients against autograd's, its plan, its
checks and its gather emulated stage by stage. The forward kernel is held
against the plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py``; the weight-gradient kernel by
``chip_smoke.py`` and the ``gpu`` cases at the end of this file (run with
``-m gpu`` on a card; they skip without one)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark_h100.count import ops as bench_ops
from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch.kernels import conv3d as cv
from mrijax_torch.models import UNet3D
from mrijax_torch.models.blocks import Conv3d, Downsample, Upsample, _Upsample

# (batch, D, H, W, Cin, Cout): odd and even sizes, Cin in {8, 24}, Cout in {8, 40}
SHAPES = [(1, 5, 7, 8, 8, 8), (3, 9, 8, 7, 24, 40), (1, 8, 8, 8, 24, 8),
          (3, 7, 5, 9, 8, 40), (1, 9, 9, 5, 24, 40), (3, 8, 9, 8, 8, 8)]
# (M, Cout) of the main path: the UNet3D's two Downsamples at batch 8 and 32,
# and the VAE3D encoder's two at batch 1
MAIN_PATH = [(8 * 16 * 20 * 20, 256), (8 * 8 * 10 * 10, 512), (32 * 16 * 20 * 20, 256),
             (32 * 8 * 10 * 10, 512), (64 * 80 * 80, 64), (32 * 40 * 40, 128)]


def _operands(b, d, h, w, cin, cout, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, d, h, w, cin, generator=g, dtype=dtype)
    weight = torch.randn(cout, cin, 4, 4, 4, generator=g, dtype=dtype) / (64 * cin) ** 0.5
    bias = torch.randn(cout, generator=g, dtype=dtype)
    return x, weight, bias


def _library_conv(x, weight, bias=None):
    """F.conv3d on the channels-first view, back to channels-last."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, bias, stride=2, padding=1)
    return y.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_conv3d_in_float64(shape, with_bias):
    x, weight, bias = _operands(*shape)
    bias = bias if with_bias else None
    got = cv.conv3d_k4s2_reference(x, weight, bias)
    assert got.shape == (shape[0], *cv.output_spatial(shape[1:4]), shape[5])
    torch.testing.assert_close(got, _library_conv(x, weight, bias), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("layout", ["channels_last_3d", "contiguous"])
def test_weight_repack_round_trips(layout):
    """The K order is (kd, kh, kw, cin); a channels_last_3d weight (the
    models' layout) packs without a copy."""
    _, weight, _ = _operands(1, 4, 4, 4, 24, 40)
    if layout == "channels_last_3d":
        weight = weight.contiguous(memory_format=torch.channels_last_3d)
    packed = cv.pack_weight(weight)
    assert packed.shape == (40, 64 * 24)
    unpacked = packed.reshape(40, 4, 4, 4, 24).permute(0, 4, 1, 2, 3)
    assert torch.equal(unpacked, weight)
    assert packed[7, (2 * 16 + 1 * 4 + 3) * 24 + 5] == weight[7, 5, 2, 1, 3]
    assert (packed.data_ptr() == weight.data_ptr()) == (layout == "channels_last_3d")


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "concat_slice"])
@pytest.mark.parametrize("shape", [(1, 3, 4, 5, 8, 24), (2, 4, 3, 2, 40, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_transposed_convolution_input_gradient_is_the_convolution(shape, strided):
    """The input gradient of conv_transpose3d(k=4, s=2, p=1) by a (Cin, Cout,
    4, 4, 4) weight is the plain version of the convolution of the output
    gradient by the same weight read as (out = Cin, in = Cout), no flip —
    also where the gradient is a slice of a concatenation's."""
    b, d, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, d, h, w, cin, generator=g, dtype=torch.float64, requires_grad=True)
    weight = torch.randn(cin, cout, 4, 4, 4, generator=g, dtype=torch.float64)
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), weight, None, 2, 1).permute(0, 2, 3, 4, 1)
    assert y.shape == (b, 2 * d, 2 * h, 2 * w, cout)
    dy = torch.randn(b, 2 * d, 2 * h, 2 * w, 2 * cout, generator=g, dtype=x.dtype)
    dy = dy[..., :cout] if strided else dy[..., :cout].contiguous()
    (want,) = torch.autograd.grad(y, x, dy)
    torch.testing.assert_close(cv.conv3d_k4s2_reference(dy, weight), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["downsample", "upsample"])
def test_autograd_functions_pass_gradcheck_in_float64(kind):
    g = torch.Generator().manual_seed(1)
    if kind == "downsample":
        x = torch.randn(1, 2, 3, 2, 1, generator=g, dtype=torch.float64)
        weight = torch.randn(2, 1, 4, 4, 4, generator=g, dtype=torch.float64)
        fn = cv._Downsample3D.apply
    else:
        x = torch.randn(1, 2, 1, 2, 2, generator=g, dtype=torch.float64)
        weight = torch.randn(2, 1, 4, 4, 4, generator=g, dtype=torch.float64)
        fn = cv._Upsample3D.apply
    bias = torch.randn(weight.shape[0] if kind == "downsample" else weight.shape[1],
                       generator=g, dtype=torch.float64)
    for t in (x, weight, bias):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (x, weight, bias))
    assert torch.autograd.gradcheck(lambda a, w: fn(a, w, None), (x, weight))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["down", "up"])
def test_modules_match_their_parent_implementation(kind, dtype):
    """The 3D modules against what they computed before the kernel: cuDNN's
    (here oneDNN's) convolution on the channels-last view, and autograd's
    gradients. float32 takes that very route (bitwise); bf16 the plain
    version of the kernel, which rounds once from a float32 sum (one bf16
    ulp), and the library's weight and bias gradients (bitwise for the
    Downsample, within an ulp where the input gradient flows in)."""
    torch.manual_seed(3)
    if kind == "down":
        module = Downsample(8, 16, dtype=dtype, param_dtype=torch.float32)
        parent = Conv3d.forward
        x0 = torch.randn(2, 6, 5, 7, 8)
    else:
        module = Upsample(16, 8, dtype=dtype, param_dtype=torch.float32)
        parent = _Upsample.forward
        x0 = torch.randn(2, 3, 4, 3, 16)
    module.to(memory_format=torch.channels_last_3d)
    outs, grads = [], []
    for fn in (module.forward, lambda t: parent(module, t)):
        module.zero_grad()
        x = x0.to(dtype).requires_grad_(True)
        y = fn(x)
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
        y.backward(dy)
        outs.append(y.detach())
        grads.append([x.grad, module.weight.grad, module.bias.grad])
    exact = dtype == torch.float32
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(outs[0], outs[1], **tol)
    for name, got, want in zip(("x", "weight", "bias"), *grads):
        if exact or kind == "down" or name != "x":
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
        else:
            torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-2, msg=name)


def _count_plain_calls(monkeypatch):
    calls = []
    plain = cv.conv3d_k4s2_reference

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(cv, "conv3d_k4s2_reference", counted)
    return calls


def test_unet3d_routes_two_downsamples_and_two_upsample_gradients(monkeypatch):
    """The launches ``chip_smoke.py`` counts on the card, by the plain version
    on the CPU: 2 a bf16 UNet3D forward (the Downsamples), 2 more in its
    backward (the Upsamples' input gradients); none in float32."""
    calls = _count_plain_calls(monkeypatch)
    kw = dict(in_channels=8, base_channels=8, channel_mults=(1, 2, 4), time_emb_dim=8,
              num_heads=1, use_attention=False)
    net = UNet3D(**kw, dtype=torch.bfloat16, param_dtype=torch.float32)
    x, t = torch.randn(1, 8, 8, 8, 8), torch.tensor([3])
    with torch.no_grad():
        net(x, t)
    assert [tuple(s) for s in calls] == [(1, 8, 8, 8, 8), (1, 4, 4, 4, 16)]
    calls.clear()
    net(x, t).square().mean().backward()
    assert [tuple(s) for s in calls[2:]] == [(1, 8, 8, 8, 8), (1, 4, 4, 4, 16)]
    calls.clear()
    UNet3D(**kw)(x, t).square().mean().backward()
    assert calls == []


def test_export_shows_the_custom_op_with_its_shape():
    net = UNet3D(in_channels=8, base_channels=8, channel_mults=(1, 2), time_emb_dim=8,
                 num_heads=1, use_attention=False, dtype=torch.bfloat16).eval()
    x, t = torch.randn(1, 4, 6, 6, 8), torch.tensor([3])
    with torch.no_grad():
        ep = torch.export.export(net, (x, t))
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target) == "mrijax_torch.conv3d_k4s2.default"]
    assert len(nodes) == 1
    assert tuple(nodes[0].meta["val"].shape) == (1, 2, 3, 3, 16)
    assert nodes[0].meta["val"].dtype == torch.bfloat16
    assert not torch.compiler.is_exporting()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_custom_op_passes_opcheck_and_equals_the_plain_version(dtype):
    x, weight, bias = _operands(2, 4, 5, 3, 8, 16, dtype=dtype)
    for args in ((x, weight, bias), (x, weight, None)):
        result = torch.library.opcheck(torch.ops.mrijax_torch.conv3d_k4s2.default, args)
        assert set(result.values()) == {"SUCCESS"}, result
        assert torch.equal(torch.ops.mrijax_torch.conv3d_k4s2(*args),
                           cv.conv3d_k4s2_reference(*args))


@pytest.mark.parametrize("shape", [(8, 32, 40, 40, 128, 256), (8, 16, 20, 20, 256, 512),
                                   (1, 128, 160, 160, 64, 64), (3, 9, 7, 5, 24, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_operations_follow_the_benchmark_rule(shape):
    b, d, h, w, cin, cout = shape
    out = cv.output_spatial((d, h, w))
    for bias in (True, False):
        assert cv.operations((b, d, h, w, cin), cout, bias) == bench_ops.conv_flops(
            b, (d, h, w), out, cin, cout, 4, 2, 1, False, bias)


@pytest.mark.parametrize("m,n", MAIN_PATH + [(12, 40), (130, 8), (129, 264)])
def test_launch_plan_gives_every_block_the_same_number_of_tiles(m, n):
    plan = cv.launch_plan(m, n)
    assert plan.tile_n in cv.TILE_N and (plan.tile_n >= n or plan.tile_n == 256)
    assert plan.tiles == -(-m // cv.TILE_M) * -(-n // plan.tile_n)
    assert plan.grid <= cv.SM_COUNT and plan.waves == -(-plan.tiles // cv.SM_COUNT)
    # blocks walk tiles blockIdx.x + i·grid: every block gets waves or waves - 1
    per_block = np.bincount(np.arange(plan.tiles) % plan.grid, minlength=plan.grid)
    assert per_block.max() == plan.waves and per_block.min() >= plan.waves - 1
    if (m, n) == MAIN_PATH[0]:
        assert (plan.tile_n, plan.tiles, plan.waves, plan.grid) == (256, 400, 4, 100)


@pytest.mark.parametrize("fault", ["float32", "cin12", "cout12", "depth1", "channel_stride",
                                   "misaligned", "bias_shape", "weight_kernel"])
def test_checks_refuse_what_the_kernel_does_not_take(fault):
    x, weight, bias = _operands(1, 4, 4, 4, 16, 8, dtype=torch.bfloat16)
    cv._check(x, weight, bias)
    cv._check(x, weight, None)
    if fault == "float32":
        x = x.float()
    elif fault == "cin12":
        x, weight = x[..., :12], weight[:, :12]
    elif fault == "cout12":
        weight, bias = torch.cat([weight, weight[:4]]), torch.cat([bias, bias[:4]])
    elif fault == "depth1":
        x = x[:, :1]
    elif fault == "channel_stride":
        x = x.transpose(3, 4)
        weight = weight[:, :4].repeat(1, 4, 1, 1, 1)
    elif fault == "misaligned":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    elif fault == "bias_shape":
        bias = bias[:4]
    elif fault == "weight_kernel":
        weight = weight[..., :3]
    with pytest.raises(ValueError):
        cv._check(x, weight, bias)


def _kernel_gather(x, m0, kt):
    """The A rows the kernel's copying warpgroup writes for tile rows m0 ..
    m0 + 127 at k-step kt, computed as ``csrc/conv3d_k4s2.cu::copy_stages``
    computes them: thread (r0, c) takes rows r0 + 16 j and the 8 channels
    k = 64 kt + 8 c; tap = k / C, ci = k % C; the row's first voxel 2 o - 1;
    zero where a coordinate leaves the input or the row passes M."""
    b_, d, h, w, c_in = x.shape
    do, ho, wo = cv.output_spatial((d, h, w))
    m_total = b_ * do * ho * wo
    tile = torch.zeros(cv.TILE_M, 64, dtype=x.dtype)
    for r0 in range(16):
        for j in range(8):
            m = m0 + r0 + 16 * j
            if m >= m_total:
                continue
            ow, oh, od, b = m % wo, m // wo % ho, m // (wo * ho) % do, m // (wo * ho * do)
            for c in range(8):
                k = kt * 64 + 8 * c
                tap, ci = divmod(k, c_in)
                kd, kh, kw = tap >> 4, (tap >> 2) & 3, tap & 3
                i_d, i_h, i_w = 2 * od - 1 + kd, 2 * oh - 1 + kh, 2 * ow - 1 + kw
                if 0 <= i_d < d and 0 <= i_h < h and 0 <= i_w < w:
                    tile[r0 + 16 * j, 8 * c:8 * c + 8] = x[b, i_d, i_h, i_w, ci:ci + 8]
    return tile


@pytest.mark.parametrize("shape", [(1, 5, 4, 6, 24), (2, 4, 3, 5, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_gather_builds_the_im2col_matrix(shape):
    """The emulated gather over every tile and k-step gives exactly
    ``im2col`` (M rows, 64·Cin columns), ragged last tile included."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(5))
    cols = cv.im2col(x)
    m_total, k_total = cols.shape
    got = torch.cat([torch.cat([_kernel_gather(x, m0, kt) for kt in range(k_total // 64)], 1)
                     for m0 in range(0, m_total, cv.TILE_M)])
    assert torch.equal(got[:m_total], cols) and not got[m_total:].any()


# ------------------------------------------------------------ weight gradient

# (batch, D, H, W, Cg, Cp) of the large side: odd and even sizes, channels 8,
# 24, 64 and 136 (136: a ragged column tile of 256)
WGRAD_SHAPES = [(1, 5, 7, 8, 8, 24), (2, 9, 8, 7, 24, 8), (1, 7, 5, 9, 64, 136),
                (2, 6, 7, 5, 136, 64)]
# (m, Cp, Cg) of the main path: the flagship UNet3D's stride-2 convolutions
# at batch 32 (down0 = up0, down1 = up1) and 8, the VAE3D's two at batch 1
WGRAD_MAIN_PATH = [(32 * 16 * 20 * 20, 256, 128), (32 * 8 * 10 * 10, 512, 256),
                   (8 * 16 * 20 * 20, 256, 128), (8 * 8 * 10 * 10, 512, 256),
                   (64 * 80 * 80, 64, 64), (32 * 40 * 40, 128, 128)]


def _library_wgrad(kind, p, g):
    """``aten.convolution_backward``'s weight gradient (the library call the
    kernel replaces) in the kernel's (Cp, 4, 4, 4, Cg) layout."""
    if kind == "down":  # p = dy, g = x, weight (Cout = Cp, Cin = Cg, 4, 4, 4)
        dy, x, w_shape = p, g, (p.shape[-1], g.shape[-1], 4, 4, 4)
    else:  # p = x, g = dy, weight (Cin = Cp, Cout = Cg, 4, 4, 4)
        dy, x, w_shape = g, p, (p.shape[-1], g.shape[-1], 4, 4, 4)
    _, gw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), torch.zeros(w_shape, dtype=p.dtype),
        None, [2] * 3, [1] * 3, [1] * 3, kind == "up", [0] * 3, 1, [False, True, False])
    return gw.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("kind", ["down", "up"])
@pytest.mark.parametrize("shape", WGRAD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgrad_reference_matches_convolution_backward_in_float64(shape, kind):
    """Both orientations: the Downsample's (p = dy, g = x) and the transposed
    Upsample's (p = x, g = dy, the large side its output)."""
    b, d, h, w, c_g, c_p = shape
    gen = torch.Generator().manual_seed(11)
    if kind == "up":  # the Upsample's output is exactly twice its input
        d, h, w = 2 * (d // 2), 2 * (h // 2), 2 * (w // 2)
    g = torch.randn(b, d, h, w, c_g, generator=gen, dtype=torch.float64)
    p = torch.randn(b, *cv.output_spatial((d, h, w)), c_p, generator=gen, dtype=torch.float64)
    got = cv.conv3d_k4s2_wgrad_reference(p, g)
    assert got.shape == (c_p, 4, 4, 4, c_g) and got.dtype == torch.float64
    torch.testing.assert_close(got, _library_wgrad(kind, p, g), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["down", "up"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "concat_slice"])
def test_autograd_functions_give_autograds_weight_gradient_in_float64(kind, strided):
    """``_Downsample3D`` / ``_Upsample3D`` on the CPU (the weight kernel's
    plain version) against ``F.conv3d`` / ``F.conv_transpose3d`` under
    autograd, all three gradients, the output gradient also a slice of a
    concatenation's; the weight gradient is the weight's shape."""
    gen = torch.Generator().manual_seed(12)
    if kind == "down":
        x = torch.randn(2, 7, 6, 9, 16, generator=gen, dtype=torch.float64)
        weight = torch.randn(24, 16, 4, 4, 4, generator=gen, dtype=torch.float64)
        fn, lib = cv._Downsample3D.apply, lambda a, wt, bi: F.conv3d(a, wt, bi, 2, 1)
    else:
        x = torch.randn(2, 3, 4, 5, 24, generator=gen, dtype=torch.float64)
        weight = torch.randn(24, 16, 4, 4, 4, generator=gen, dtype=torch.float64)
        fn, lib = cv._Upsample3D.apply, lambda a, wt, bi: F.conv_transpose3d(a, wt, bi, 2, 1)
    bias = torch.randn(weight.shape[0 if kind == "down" else 1], generator=gen,
                       dtype=torch.float64)
    grads = []
    for run in (fn, lambda a, wt, bi: lib(a.permute(0, 4, 1, 2, 3), wt, bi).permute(0, 2, 3, 4, 1)):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
        y = run(*leaves)
        dy = torch.randn(*y.shape[:4], 2 * y.shape[-1], generator=torch.Generator().manual_seed(13),
                         dtype=torch.float64)
        dy = dy[..., :y.shape[-1]] if strided else dy[..., :y.shape[-1]].contiguous()
        grads.append(torch.autograd.grad(y, leaves, dy))
    for name, got, want in zip(("x", "weight", "bias"), *grads):
        assert got.shape == want.shape, name
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12, msg=name)


@pytest.mark.parametrize("m,c_p,c_g", WGRAD_MAIN_PATH + [(12, 24, 8), (2049, 136, 24),
                                                         (100, 264, 8), (64 * 33, 8, 8),
                                                         (4 * 64 * 80 * 80, 64, 512)])
def test_wgrad_plan_covers_every_tile_once_in_nonempty_parts(m, c_p, c_g):
    """A pure function of the shape: every (tile, part) unit is walked by one
    block, the parts of a tile cover its stages once each, none is empty
    and none longer than ``MAX_PART_STEPS``, a plan split to fill the SMs is
    one wave, and the tiles cover the (64·Cg, Cp) output."""
    plan = cv.wgrad_plan(m, c_p, c_g)
    assert plan == cv.wgrad_plan(m, c_p, c_g)
    assert plan.tile_n in cv.TILE_N and (plan.tile_n >= c_p or plan.tile_n == 256)
    assert plan.tiles * cv.TILE_M * plan.tile_n >= 64 * c_g * c_p
    assert plan.tiles == 64 * c_g // cv.TILE_M * -(-c_p // plan.tile_n)
    assert plan.steps == -(-m // cv.WGRAD_STEP) and plan.split >= 1
    assert plan.units == plan.tiles * plan.split and plan.grid <= cv.SM_COUNT
    walked = np.concatenate([np.arange(b, plan.units, plan.grid) for b in range(plan.grid)])
    assert sorted(walked) == list(range(plan.units))
    assert max(len(range(b, plan.units, plan.grid)) for b in range(plan.grid)) == plan.waves
    stages = [k for i in range(plan.split) for k in plan.part(i)]
    assert stages == list(range(plan.steps))
    assert all((cv.MIN_PART_STEPS if plan.split > 1 else 1) <= len(plan.part(i))
               <= cv.MAX_PART_STEPS for i in range(plan.split))
    if plan.split > -(-plan.steps // cv.MAX_PART_STEPS):  # split to fill the SMs
        assert plan.split <= cv.MAX_SPLIT and plan.waves == 1 and plan.units <= cv.SM_COUNT
    if (m, c_p, c_g) == WGRAD_MAIN_PATH[4]:  # the VAE's first level: 4 parts of 1600 stages
        assert (plan.tile_n, plan.tiles, plan.split, plan.grid) == (64, 32, 4, 128)
    if c_g == 512:  # 256 tiles fill the SMs; 25 600 stages are cut for their length
        assert (plan.tiles, plan.split, plan.waves) == (256, 16, 32)
    if (m, c_p, c_g) == WGRAD_MAIN_PATH[0]:
        assert (plan.tile_n, plan.tiles, plan.split, plan.grid) == (256, 64, 2, 128)
    if (m, c_p, c_g) == WGRAD_MAIN_PATH[1]:
        assert (plan.tile_n, plan.tiles, plan.split, plan.waves, plan.grid) == (256, 256, 1, 2, 128)


def _wgrad_gather(g, plan):
    """The G stages the weight kernel's copying warpgroup writes, for every
    (row tile, stage), computed as ``csrc/conv3d_k4s2.cu::wgrad_copy``
    computes them: thread (r0, c) holds chunk c of rows r0 + 16 j (j < 4) in
    both 64-column blocks, one (tap, channel) a block fixed for the unit;
    the rows' voxels from one division at the part's first stage, then
    ``next_stage``'s carries; zero where a tap leaves the input or a row
    passes M. Returns (64·Cg / 128 tiles, steps · 64, 128)."""
    b_, d, h, w, c_g = g.shape
    do, ho, wo = cv.output_spatial((d, h, w))
    m_total = b_ * do * ho * wo
    q = cv.WGRAD_STEP
    step_w, q = q % wo, q // wo
    step_h, q = q % ho, q // ho
    step_d, step_b = q % do, q // do
    row_tiles = 64 * c_g // cv.TILE_M
    out = torch.zeros(row_tiles, plan.steps * cv.WGRAD_STEP, cv.TILE_M, dtype=g.dtype)
    for unit in range(plan.units):
        tile, part = divmod(unit, plan.split)
        mt = tile // (plan.tiles // row_tiles)
        stages = plan.part(part)
        for tid in range(128):
            c, r0 = tid & 7, tid >> 3
            taps = []
            for e in (0, 1):
                tap, ch = divmod(mt * cv.TILE_M + 64 * e + 8 * c, c_g)
                taps.append((tap >> 4, (tap >> 2) & 3, tap & 3, ch))
            voxels = []
            for j in range(4):
                m = stages.start * cv.WGRAD_STEP + r0 + 16 * j
                voxels.append([m // wo // ho // do, m // wo // ho % do, m // wo % ho, m % wo])
            for kt in stages:
                for j, v in enumerate(voxels):
                    row = kt * cv.WGRAD_STEP + r0 + 16 * j
                    bb, od, oh, ow = v
                    for e, (kd, kh, kw, ch) in enumerate(taps):
                        i_d, i_h, i_w = 2 * od - 1 + kd, 2 * oh - 1 + kh, 2 * ow - 1 + kw
                        if row < m_total and 0 <= i_d < d and 0 <= i_h < h and 0 <= i_w < w:
                            out[mt, row, 64 * e + 8 * c:64 * e + 8 * c + 8] = \
                                g[bb, i_d, i_h, i_w, ch:ch + 8]
                    v[3] += step_w
                    carry = v[3] >= wo
                    v[3] -= wo * carry
                    v[2] += step_h + carry
                    carry = v[2] >= ho
                    v[2] -= ho * carry
                    v[1] += step_d + carry
                    carry = v[1] >= do
                    v[1] -= do * carry
                    v[0] += step_b + carry
    return out


@pytest.mark.parametrize("shape,sms", [((20, 6, 10, 14, 8), 132), ((1, 2, 4, 160, 16), 132),
                                       ((3, 9, 7, 5, 24), 4)],
                         ids=["split2_carries", "wide_rows", "ragged_m"])
def test_wgrad_gather_builds_the_im2col_matrix(shape, sms):
    """The emulated gather over every unit and stage gives exactly
    ``im2col``'s columns tile by tile (64·Cg rows of the product), rows past
    M zero; the stepping crosses every digit's carry (small sides (3, 5, 7),
    (1, 2, 80) with Wo ≥ 64, and (4, 3, 2) over a ragged last stage)."""
    g = torch.randn(*shape, generator=torch.Generator().manual_seed(14))
    cols = cv.im2col(g)
    m_total = cols.shape[0]
    plan = cv.wgrad_plan(m_total, 8, shape[-1], sms)
    if shape[0] == 20:
        assert plan.split == 2
    got = _wgrad_gather(g, plan)
    want = torch.zeros_like(got)
    want[:, :m_total] = cols.reshape(m_total, -1, cv.TILE_M).transpose(0, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault", ["float32", "cg12", "cp12", "depth1", "not_small_side",
                                   "channel_stride", "misaligned", "p_pitch", "devices"])
def test_wgrad_checks_refuse_what_the_kernel_does_not_take(fault):
    gen = torch.Generator().manual_seed(15)
    g = torch.randn(1, 6, 4, 5, 16, generator=gen).bfloat16()
    p = torch.randn(1, 3, 2, 2, 24, generator=gen).bfloat16()
    cv._check_wgrad(p, g)
    if fault == "float32":
        p = p.float()
    elif fault == "cg12":
        g = g[..., :12]
    elif fault == "cp12":
        p = p[..., :12]
    elif fault == "depth1":
        g, p = g[:, :1], p[:, :0]
    elif fault == "not_small_side":
        p = p[:, :2]
    elif fault == "channel_stride":
        g = g.transpose(3, 4)[..., :4].contiguous().transpose(3, 4)
        g = torch.cat([g] * 4, dim=3)
    elif fault == "misaligned":
        g = torch.cat([g.new_zeros(1), g.flatten()])[1:].view(g.shape)
    elif fault == "p_pitch":
        p = p.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "devices":
        p = p.to("meta")
    with pytest.raises(ValueError):
        cv._check_wgrad(p, g)


def test_row_pitch_reads_contiguous_and_concat_slices():
    """The plain operand's pitch: C when contiguous, the concatenation's
    width for a channel slice, 0 (copy first) for unevenly spaced voxels or
    a pitch that is not a 16-byte multiple."""
    t = torch.zeros(2, 3, 4, 5, 48, dtype=torch.bfloat16)
    assert cv.row_pitch(t) == 48
    assert cv.row_pitch(t[..., :24]) == 48
    assert cv.row_pitch(t[..., 8:32]) == 48
    assert cv.row_pitch(t[..., :4, :]) == 0
    assert cv.row_pitch(t.transpose(2, 3)) == 0
    assert cv.row_pitch(torch.zeros(2, 3, 4, 5, 20, dtype=torch.bfloat16)[..., :8]) == 0
    single = torch.zeros(1, 1, 1, 1, 16, dtype=torch.bfloat16)
    assert cv.row_pitch(single) == 16


def test_unet3d_routes_four_weight_gradients(monkeypatch):
    """The weight kernel's calls in a bf16 UNet3D backward, by its plain
    version on the CPU: one a stride-2 convolution (two Downsamples, two
    Upsamples), none in the forward and none in float32; every parameter
    gets its float32 gradient through the bf16 cast."""
    calls = []
    plain = cv.conv3d_k4s2_wgrad_reference

    def counted(p, g):
        calls.append((tuple(p.shape), tuple(g.shape)))
        return plain(p, g)

    monkeypatch.setattr(cv, "conv3d_k4s2_wgrad_reference", counted)
    kw = dict(in_channels=8, base_channels=8, channel_mults=(1, 2, 4), time_emb_dim=8,
              num_heads=1, use_attention=False)
    net = UNet3D(**kw, dtype=torch.bfloat16, param_dtype=torch.float32)
    x, t = torch.randn(1, 8, 8, 8, 8), torch.tensor([3])
    loss = net(x, t).square().mean()
    assert calls == []
    loss.backward()
    # (p, g): Downsample dy by x, Upsample x by dy; down0 = up0, down1 = up1
    assert sorted(calls) == sorted(2 * [((1, 4, 4, 4, 16), (1, 8, 8, 8, 8)),
                                        ((1, 2, 2, 2, 32), (1, 4, 4, 4, 16))])
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in net.parameters())
    calls.clear()
    UNet3D(**kw)(x, t).square().mean().backward()
    assert calls == []


# ------------------------------------------------- the weight kernel on the card


@pytest.fixture
def cuda():
    # decided when a test runs, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _wgrad_bar(want):
    """``chip_smoke.py``'s ``conv3d_bar``: half a bf16 ulp of the float32
    sum, plus 1e-4 of the largest value for another order of the sum."""
    return 2 ** -8 * want.abs() + 1e-4 * want.abs().max()


def _wgrad_operands(device, shape, kind, strided, seed=16):
    b, d, h, w, c_g, c_p = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(b, d, h, w, 2 * c_g, device=device, generator=gen).bfloat16()
    g = g[..., :c_g] if strided else g[..., :c_g].contiguous()
    p = torch.randn(b, *cv.output_spatial((d, h, w)), c_p, device=device, generator=gen)
    return p.bfloat16(), g


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "concat_slice"])
@pytest.mark.parametrize("shape", [(1, 5, 7, 8, 8, 24), (2, 9, 8, 7, 24, 8), (2, 6, 6, 6, 64, 136),
                                   (2, 16, 20, 20, 128, 256), (2, 8, 10, 10, 256, 512),
                                   (1, 32, 40, 40, 64, 64), (1, 12, 10, 10, 128, 264)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wgrad_kernel_matches_plain_version(cuda, shape, strided):
    """Within ``chip_smoke.py``'s bar of the plain version's float32 sum:
    every compiled tile width, split and whole sums, a ragged last stage and
    ragged column tiles, g a slice of a concatenation's."""
    p, g = _wgrad_operands(cuda, shape, "down", strided)
    cv.launches.reset()
    got = cv.conv3d_k4s2_wgrad(p, g)
    assert cv.launches["conv3d_k4s2_wgrad"] == 1
    want = cv.conv3d_k4s2_wgrad_reference(p.float(), g.float())
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert not bool(((got.float() - want).abs() > _wgrad_bar(want)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 32, 40, 40, 128, 256), (8, 16, 20, 20, 64, 136)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wgrad_kernel_gives_the_same_bits_twice(cuda, shape):
    """No float atomics: the split sums are added in a fixed order."""
    p, g = _wgrad_operands(cuda, shape, "down", False)
    plan = cv.wgrad_plan(p.numel() // p.shape[-1], shape[-1], shape[-2])
    assert plan.split > 1
    assert torch.equal(cv.conv3d_k4s2_wgrad(p, g), cv.conv3d_k4s2_wgrad(p, g))


@pytest.mark.gpu
def test_wgrad_kernel_launches_four_times_a_flagship_unet3d_backward(cuda):
    """At the flagship's widths (base 128, mults (1, 2, 4)): the two
    Downsamples' and the two Upsamples' weight gradients, none forward;
    none in float32."""
    kw = dict(in_channels=16, base_channels=128, channel_mults=(1, 2, 4), time_emb_dim=32,
              num_heads=4)
    x = torch.randn(2, 8, 8, 8, 16, device=cuda)
    t = torch.tensor([3, 9], device=cuda)
    for dtype, want in ((torch.bfloat16, 4), (torch.float32, 0)):
        net = UNet3D(**kw, dtype=dtype, param_dtype=torch.float32).to(cuda)
        cv.launches.reset()
        loss = net(x, t).square().mean()
        assert cv.launches["conv3d_k4s2_wgrad"] == 0
        loss.backward()
        assert cv.launches["conv3d_k4s2_wgrad"] == want
        assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())


@pytest.mark.gpu
def test_wgrad_kernel_refuses_what_it_does_not_take(cuda):
    p, g = _wgrad_operands(cuda, (1, 6, 4, 6, 16, 24), "down", False)
    cv.conv3d_k4s2_wgrad(p, g)
    for bad_p, bad_g in ((p.float(), g.float()), (p[..., :12], g), (p, g[..., :12]),
                         (p.transpose(1, 2).contiguous().transpose(1, 2), g)):
        with pytest.raises(ValueError):
            cv.conv3d_k4s2_wgrad(bad_p, bad_g)
