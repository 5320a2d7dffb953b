"""The 2D family's model pieces — ``ResBlock2D``, ``ScalarCondEmbedding``, the
2D down/upsampling convolutions, ``resize_bilinear``, ``pad_to_min_spatial``
and ``UNet2D`` — against ``mrijax`` on the same weights (carried over by
``unet2d_state_dict_from_flax``) and the same inputs. float32 on the CPU,
where the GroupNorm+SiLU sites take the kernels' plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.models import UNet2D as JUNet2D
from mrijax.models import blocks as jblocks
from mrijax.ops import resize as jresize
from mrijax_torch.config import UNetConfig
from mrijax_torch.io import unet2d_state_dict_from_flax
from mrijax_torch.io.flax_convert import conv_weight, convt_weight, linear_weight
from mrijax_torch.models import UNet2D
from mrijax_torch.models.blocks import (
    Downsample2D,
    ResBlock2D,
    ScalarCondEmbedding,
    Upsample2D,
)
from mrijax_torch.ops import pad_to_min_spatial, resize_bilinear
from mrijax_torch.train.experiments import build_unet2d

MULTS = (1, 2)
KW = dict(base_channels=8, channel_mults=MULTS, time_emb_dim=16)
VARIANTS = {"1ch": dict(in_channels=1, out_channels=1),
            "25d": dict(in_channels=12, out_channels=4)}   # radius 1: 4 + 4·2 context


def random_params(module, rng, *args):
    # eval_shape: only the tree's shapes are needed, so no initializer runs
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _load_conv(module, p, transposed=False):
    with torch.no_grad():
        module.weight.copy_((convt_weight if transposed else conv_weight)(p["kernel"]))
        module.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))


# ------------------------------------------------------------------- blocks


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_resblock2d_matches_flax(cin, cout):
    """conv→GN→SiLU, + SiLU(Dense(cond)), conv→GN→SiLU, + skip (a 1×1
    ``res_conv`` where the channels change). 1e-5 absolute."""
    rng = np.random.default_rng(0)
    x, cond = normal(rng, 2, 6, 5, cin), normal(rng, 2, 12)
    jm = jblocks.ResBlock2D(cout)
    params = random_params(jm, rng, jnp.asarray(x), jnp.asarray(cond))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(cond))
    block = ResBlock2D(cin, cout, 12)
    p = params["params"]
    sd = {"conv1.weight": conv_weight(p["Conv_0"]["kernel"]),
          "conv1.bias": torch.from_numpy(p["Conv_0"]["bias"]),
          "norm1.weight": torch.from_numpy(p["GroupNormSiLU_0"]["scale"]),
          "norm1.bias": torch.from_numpy(p["GroupNormSiLU_0"]["bias"]),
          "time_mlp.weight": linear_weight(p["Dense_0"]["kernel"]),
          "time_mlp.bias": torch.from_numpy(p["Dense_0"]["bias"]),
          "conv2.weight": conv_weight(p["Conv_1"]["kernel"]),
          "conv2.bias": torch.from_numpy(p["Conv_1"]["bias"]),
          "norm2.weight": torch.from_numpy(p["GroupNormSiLU_1"]["scale"]),
          "norm2.bias": torch.from_numpy(p["GroupNormSiLU_1"]["bias"])}
    if cin != cout:
        sd["res_conv.weight"] = conv_weight(p["Conv_2"]["kernel"])
        sd["res_conv.bias"] = torch.from_numpy(p["Conv_2"]["bias"])
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == (2, 6, 5, cout) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_scalar_cond_embedding_matches_flax():
    rng = np.random.default_rng(1)
    z = np.asarray([0.0, 0.3, 1.0, -1.0], np.float32)
    jm = jblocks.ScalarCondEmbedding(16)
    params = random_params(jm, rng, jnp.asarray(z))
    want = jm.apply(params, jnp.asarray(z))
    emb = ScalarCondEmbedding(16)
    p = params["params"]
    emb.load_state_dict({"0.weight": linear_weight(p["Dense_0"]["kernel"]),
                         "0.bias": torch.from_numpy(p["Dense_0"]["bias"]),
                         "2.weight": linear_weight(p["Dense_1"]["kernel"]),
                         "2.bias": torch.from_numpy(p["Dense_1"]["bias"])}, strict=True)
    with torch.no_grad():
        got = emb(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_scalar_cond_embedding_rounds_z_to_the_compute_dtype():
    """In bf16 the slice position is rounded before the first linear, as flax
    casts it: 0.3 and its bf16 neighbour give the same embedding, and the
    fp32 model fed the rounded position agrees with the bf16 one to bf16
    precision."""
    emb = ScalarCondEmbedding(16, dtype=torch.bfloat16, param_dtype=torch.float32)
    z = torch.tensor([0.3, 0.7001])
    rounded = z.to(torch.bfloat16).float()
    assert not torch.equal(rounded, z)
    with torch.no_grad():
        torch.testing.assert_close(emb(z), emb(rounded), rtol=0, atol=0)
        fp32 = ScalarCondEmbedding(16)
        fp32.load_state_dict(emb.state_dict())
        torch.testing.assert_close(emb(z).float(), fp32(rounded), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("size", [(8, 8), (9, 6)])
def test_downsample_and_upsample_2d_match_flax(size):
    """k4 s2 p1 convolution and k4 s2 transposed convolution (flax ``SAME`` ↔
    torch ``padding=1`` with the kernel flipped), at even and odd sizes.
    1e-5 absolute."""
    rng = np.random.default_rng(2)
    x = normal(rng, 2, *size, 8)
    for jm, mod, key, transposed in (
            (jblocks.Downsample(16, spatial_rank=2), Downsample2D(8, 16), "Conv_0", False),
            (jblocks.Upsample(16, spatial_rank=2), Upsample2D(8, 16), "ConvTranspose_0", True)):
        params = random_params(jm, rng, jnp.asarray(x))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        _load_conv(mod, params["params"][key], transposed)
        with torch.no_grad():
            got = mod(torch.from_numpy(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------- ops


@pytest.mark.parametrize("shape,target", [
    ((2, 8, 8, 3), (17, 17)),        # 2D up, to an odd size
    ((2, 17, 13, 3), (8, 6)),        # 2D down, without antialiasing
    ((1, 5, 8, 6, 2), (11, 8, 7)),   # 3D up / same / up
    ((1, 9, 10, 7, 2), (4, 5, 3)),   # 3D down
])
def test_resize_bilinear_matches_jax_image_resize(shape, target):
    x = normal(np.random.default_rng(3), *shape)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), target))
    got = resize_bilinear(torch.from_numpy(x), target)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape,target", [((1, 5, 8, 6, 2), (8, 8, 9)),
                                          ((2, 7, 4, 3), (6, 9))])
def test_pad_to_min_spatial_matches_jnp_pad(shape, target):
    x = normal(np.random.default_rng(4), *shape)
    want = np.asarray(jresize.pad_to_min_spatial(jnp.asarray(x), target))
    got = pad_to_min_spatial(torch.from_numpy(x), target)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -------------------------------------------------------------------- UNet2D


@pytest.fixture(scope="module")
def unets():
    """Both variants in both packages on the same random weights."""
    rng = np.random.default_rng(5)
    out = {}
    for name, ch in VARIANTS.items():
        jm = JUNet2D(**ch, **KW)
        x = jnp.zeros((1, 16, 16, 4 if name == "25d" else 1))
        ctx = jnp.zeros((1, 16, 16, 8)) if name == "25d" else None
        params = random_params(jm, rng, x, jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), ctx)
        out[name] = (jm, params)
    return out


def port_unet(unets, name, **kw):
    model = UNet2D(**VARIANTS[name], **KW, **kw)
    model.load_state_dict(
        unet2d_state_dict_from_flax(unets[name][1], channel_mults=MULTS), strict=True)
    return model


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_unet2d_matches_flax(unets, name, size, remat):
    """The whole forward at 16² and 17² (the up path's resize branch),
    1-channel and 2.5D with context, with ``remat`` off and on (on: the
    forward runs under autograd, through ``torch.utils.checkpoint``).
    1e-4 absolute."""
    jm, params = unets[name]
    rng = np.random.default_rng(6)
    x = normal(rng, 2, size, size, 4 if name == "25d" else 1)
    ctx = normal(rng, 2, size, size, 8) if name == "25d" else None
    t = np.asarray([3, 17], np.int32)
    z = np.asarray([0.25, -1.0], np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z),
                               None if ctx is None else jnp.asarray(ctx)))
    model = port_unet(unets, name, remat=remat)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(z),
            None if ctx is None else torch.from_numpy(ctx))
    with torch.set_grad_enabled(remat):
        got = model(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.requires_grad == remat
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)


def test_unet2d_remat_keeps_keys_and_gradients(unets):
    """``remat`` changes neither the ``state_dict`` keys nor a gradient
    (1e-6: recomputing a block repeats the same float32 operations), and the
    flax tree of a remat model converts as it is."""
    plain, remat = port_unet(unets, "25d"), port_unet(unets, "25d", remat=True)
    assert plain.state_dict().keys() == remat.state_dict().keys()
    jremat = JUNet2D(**VARIANTS["25d"], **KW, remat=True)
    tree = jax.eval_shape(lambda: jremat.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,)), jnp.zeros((1, 16, 16, 8))))
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(unets["25d"][1]))
    rng = np.random.default_rng(7)
    x, ctx = torch.from_numpy(normal(rng, 2, 17, 17, 4)), torch.from_numpy(normal(rng, 2, 17, 17, 8))
    t, z = torch.tensor([2, 9]), torch.tensor([0.1, 0.9])
    grads = []
    for model in (plain, remat):
        model.zero_grad()
        (model(x, t, z, ctx) ** 2).mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=1e-6, msg=k)


def test_bf16_parameters_keep_group_norm_affine_in_fp32():
    model = UNet2D(**VARIANTS["1ch"], **KW, dtype=torch.bfloat16)
    trained = UNet2D(**VARIANTS["1ch"], **KW, dtype=torch.bfloat16, param_dtype=torch.float32)
    for name, p in model.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name
    assert all(p.dtype == torch.float32 for p in trained.parameters())
    # conv weights in the layout the channels-last convolutions read
    assert model.init_conv.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = model(torch.zeros(1, 8, 8, 1), torch.tensor([1]), torch.tensor([0.5]))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_build_unet2d_follows_the_config_and_refuses_remat_levels():
    cfg = UNetConfig(in_channels=12, out_channels=4, base_channels=8, channel_mults=MULTS,
                     time_emb_dim=16, remat=True)
    model = build_unet2d(cfg)
    assert isinstance(model, UNet2D) and model.remat and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.init_conv.in_channels == 12 and model.out_conv.out_channels == 4
    with pytest.raises(ValueError, match="remat_levels"):
        build_unet2d(UNetConfig(remat_levels=(0,)))
