"""The port's 3D blocks and models against the flax modules of ``mrijax`` on
the same weights (carried over by ``mrijax_torch.io.flax_convert``) and the
same numpy inputs, float32 on the CPU. Tolerance 3e-4 absolute, that of
``tests/test_torch_parity_3d.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrijax.models import UNet3D as JUNet3D
from mrijax.models import VAE3D as JVAE3D
from mrijax.models import blocks as jblocks
from mrijax_torch.io import flax_convert
from mrijax_torch.models import UNet3D, VAE3D, blocks

ATOL = 3e-4


def random_flax_params(module, rng, *init_args, **init_kw):
    """Trace a flax module's init for its tree, then fill every leaf with
    seeded numpy normals (so norms' scales and all biases are non-trivial).
    Returns the tree as nested dicts of numpy arrays."""
    # eval_shape: only the tree's shapes are needed, so no initializer runs
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *init_args, **init_kw))
    return jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("cin,cout,timed", [(16, 16, True), (16, 32, True), (8, 16, False)])
def test_resblock3d_matches_flax(cin, cout, timed):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 5, 6, cin)).astype(np.float32)
    emb = rng.normal(size=(2, 24)).astype(np.float32) if timed else None
    jm = jblocks.ResBlock3D(cout, 8)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(emb),) if timed else ())
    params = random_flax_params(jm, rng, *jargs)
    want = jm.apply(to_jax(params), *jargs)

    tm = blocks.ResBlock3D(cin, cout, 24 if timed else None, 8)
    sd = {}
    flax_convert._put_resblock(sd, "b", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(emb) if timed else None)
    assert got.is_contiguous() and tuple(got.shape) == (2, 4, 5, 6, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_block3d_matches_flax(use_flash):
    """With ``use_flash`` the port's block goes through the flash front, whose
    CPU route is the kernel's plain version; flax's is chunked attention."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 4, 5, 32)).astype(np.float32)
    jm = jblocks.AttentionBlock3D(num_heads=2, groups=8, use_flash=use_flash)
    params = random_flax_params(jm, rng, jnp.asarray(x))
    want = jm.apply(to_jax(params), jnp.asarray(x))

    tm = blocks.AttentionBlock3D(32, num_heads=2, groups=8, use_flash=use_flash)
    sd = {}
    flax_convert._put_attention(sd, "a", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_time_embedding_and_resampling_match_flax():
    rng = np.random.default_rng(2)
    t = np.asarray([3, 17], np.int32)
    jm = jblocks.TimeEmbedding(32)
    params = random_flax_params(jm, rng, jnp.asarray(t))
    tm = blocks.TimeEmbedding(32)
    sd = {}
    flax_convert._put_linear(sd, "1", params["params"]["Dense_0"])
    flax_convert._put_linear(sd, "3", params["params"]["Dense_1"])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(to_jax(params), jnp.asarray(t))),
                               atol=ATOL)

    x = rng.normal(size=(1, 4, 6, 4, 8)).astype(np.float32)
    for jm, tm, put, key in (
        (jblocks.Downsample(16, spatial_rank=3), blocks.Downsample(8, 16),
         flax_convert._put_conv, "Conv_0"),
        (jblocks.Upsample(4, spatial_rank=3), blocks.Upsample(8, 4),
         flax_convert._put_convt, "ConvTranspose_0"),
    ):
        params = random_flax_params(jm, rng, jnp.asarray(x))
        sd = {}
        put(sd, "m", params["params"][key])
        tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x)))
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


UNET_KW = dict(in_channels=4, base_channels=16, channel_mults=(1, 2),
               time_emb_dim=32, num_heads=2)


@pytest.mark.parametrize("variant", [
    dict(use_attention=True),
    dict(use_attention=False),
    dict(use_attention=True, attention_levels=(0,)),
    dict(use_attention=True, attention_levels=(0, 1), use_flash_attention=False),
])
def test_unet3d_matches_flax(variant):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32)
    t = np.asarray([5, 11], np.int32)
    jkw = dict(variant)
    jkw.setdefault("use_flash_attention", True)
    jm = JUNet3D(**UNET_KW, **jkw)
    params = random_flax_params(jm, rng, jnp.asarray(x), jnp.asarray(t))
    want = jm.apply(to_jax(params), jnp.asarray(x), jnp.asarray(t))

    tm = UNet3D(**UNET_KW, **variant).eval()
    sd = flax_convert.unet3d_state_dict_from_flax(
        params, UNET_KW["channel_mults"], variant["use_attention"],
        variant.get("attention_levels", ()))
    tm.load_state_dict(sd, strict=True)  # strict: every key mapped, none left over
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_unet3d_three_levels_and_odd_spatial_crop_skip():
    """Three levels at a spatial size that is not a multiple of 4: the up path
    must centre-crop its skips as the flax model does."""
    rng = np.random.default_rng(4)
    kw = dict(in_channels=2, base_channels=8, channel_mults=(1, 2, 4),
              time_emb_dim=16, num_heads=2)
    x = rng.normal(size=(1, 6, 10, 6, 2)).astype(np.float32)
    t = np.asarray([2], np.int32)
    jm = JUNet3D(**kw)
    params = random_flax_params(jm, rng, jnp.asarray(x), jnp.asarray(t))
    want = jm.apply(to_jax(params), jnp.asarray(x), jnp.asarray(t))
    tm = UNet3D(**kw).eval()
    tm.load_state_dict(flax_convert.unet3d_state_dict_from_flax(params, (1, 2, 4)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("num_down", [2, 3])
def test_vae3d_encode_decode_match_flax(num_down):
    rng = np.random.default_rng(5)
    kw = dict(in_channels=4, base_channels=8, num_down=num_down, latent_channels=4)
    x = rng.normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    jm = JVAE3D(**kw)
    params = random_flax_params(jm, rng, jnp.asarray(x), jax.random.PRNGKey(1))
    jp = to_jax(params)
    mu_j, logvar_j = jm.apply(jp, jnp.asarray(x), method="encode")
    recon_j = jm.apply(jp, mu_j, method="decode_from_latent")

    tm = VAE3D(**kw).eval()
    tm.load_state_dict(flax_convert.vae3d_state_dict_from_flax(params, num_down),
                       strict=True)
    assert tm.spatial_downsample == jm.spatial_downsample
    with torch.no_grad():
        mu_t, logvar_t = tm.encode(torch.from_numpy(x))
        latent_t = tm.encode_to_latent(torch.from_numpy(x))
        recon_t = tm.decode_from_latent(torch.from_numpy(np.array(mu_j)))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=ATOL)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j), atol=ATOL)
    np.testing.assert_array_equal(latent_t.numpy(), mu_t.numpy())
    assert recon_t.dtype == torch.float32 and tuple(recon_t.shape) == x.shape
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), atol=ATOL)


def test_vae3d_reparameterize_uses_the_generator():
    vae = VAE3D(in_channels=2, base_channels=8, num_down=2, latent_channels=2)
    mu = torch.zeros(1, 2, 2, 2, 2)
    logvar = torch.full_like(mu, np.log(4.0))
    a = vae.reparameterize(mu, logvar, torch.Generator().manual_seed(7))
    b = vae.reparameterize(mu, logvar, torch.Generator().manual_seed(7))
    want = 2.0 * torch.randn(mu.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, want)


def test_bf16_models_keep_norm_parameters_in_float32():
    """dtype semantics of the flax modules: convs and linears in ``dtype``,
    GroupNorm affine parameters float32, outputs float32."""
    unet = UNet3D(in_channels=2, base_channels=8, channel_mults=(1, 2),
                  time_emb_dim=16, num_heads=1, dtype=torch.bfloat16).eval()
    for name, p in unet.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name
    x = torch.randn(1, 4, 4, 4, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = unet(x, torch.tensor([3]))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
