"""What surrounds the 3D stride-2 convolution kernel (``kernels/conv3d.py``)
and can be checked without a GPU: its plain version against ``F.conv3d``
in float64, the weight repack, the identity the ``Upsample`` backward rests
on, both autograd functions (``gradcheck`` through the plain route), the 3D
modules against their parent implementation, the export route, the launch
plan, the operation count, the input checks, and the kernel's gather
arithmetic emulated row by row. The kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark_h100.count import ops as bench_ops
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
