"""The loaders of reference PyTorch checkpoints — ``load_reference_unet2d``,
``convert_reference_unet3d``, ``convert_reference_vae3d`` and the helpers —
against the torch twins of the reference topology that
``tests/test_torch_parity.py`` and ``tests/test_torch_parity_3d.py`` hold the
JAX package's converter against: the same random twin, loaded into the port,
gives the twin's outputs (2e-4 absolute, the bar of those tests), and the
same ``state_dict`` as the JAX package's route (twin → ``convert_reference_*``
→ ``mrijax_torch.io.flax_convert``), bitwise."""

import numpy as np
import pytest
import torch

from mrijax.io import torch_convert as jconvert
from mrijax_torch.io import (
    convert_reference_unet3d,
    convert_reference_vae3d,
    infer_timesteps,
    load_reference_unet2d,
    strip_prefixes,
    unet2d_state_dict_from_flax,
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)
from mrijax_torch.models import UNet2D, UNet3D, VAE3D
from test_torch_parity import TorchRefUNet
from test_torch_parity_3d import TUNet3D, TVAE3D

ATOL = 2e-4


def channels_first(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def channels_last(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def assert_same_state(model: torch.nn.Module, want: dict):
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def wrap(sd, how):
    """The reference checkpoint as its training scripts leave it."""
    if how == "diffusion":       # diffusion.state_dict(): UNet under model., schedule beside
        return {**{f"model.{k}": v for k, v in sd.items()},
                "betas": torch.linspace(1e-4, 0.02, 37)}
    if how == "ddp":             # a DDP-wrapped UNet inside the diffusion wrapper
        return {f"model.module.{k}": v for k, v in sd.items()}
    return {"state_dict": wrap(sd, "diffusion")}


@pytest.mark.parametrize("how", ["diffusion", "ddp", "nested"])
@pytest.mark.parametrize("mults,size,ch", [((1, 2, 4), 24, (1, 1)), ((1, 2), 17, (1, 1)),
                                           ((1, 2), 16, (12, 4))],
                         ids=["1ch-24", "1ch-17", "25d-16"])
def test_load_reference_unet2d_matches_the_torch_twin(mults, size, ch, how):
    cin, cout = ch
    torch.manual_seed(0)
    twin = TorchRefUNet(img_channels=cout, base=16, mults=mults, tdim=32,
                        in_channels=cin).eval()
    model = UNet2D(in_channels=cin, out_channels=cout, base_channels=16, channel_mults=mults,
                   time_emb_dim=32)
    assert load_reference_unet2d(model, wrap(twin.state_dict(), how)) is model
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size, cout)).astype(np.float32)
    ctx = rng.normal(size=(2, size, size, cin - cout)).astype(np.float32) if cin > cout else None
    t, z = torch.tensor([3, 7]), torch.tensor([0.25, 0.75])
    with torch.no_grad():
        want = twin(channels_first(x), t, z,
                    None if ctx is None else channels_first(ctx))
        got = model.eval()(torch.from_numpy(x), t, z,
                           None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), channels_last(want), atol=ATOL)
    if how == "diffusion":
        params = jconvert.convert_reference_unet2d(wrap(twin.state_dict(), how),
                                                   channel_mults=mults)
        assert_same_state(model, unet2d_state_dict_from_flax(params, channel_mults=mults))


def test_strip_prefixes_and_infer_timesteps_match_jax():
    sd = {"model.module.init_conv.weight": torch.zeros(4, 1, 3, 3),
          "module.out_conv.bias": torch.ones(2), "betas": torch.linspace(1e-4, 0.02, 123),
          "alphas_cumprod": torch.ones(123)}
    got = strip_prefixes(sd)
    want = jconvert.strip_prefixes({k: v.numpy() for k, v in sd.items()})
    assert got.keys() == want.keys() == {"init_conv.weight", "out_conv.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for d in (sd, {"state_dict": sd}):
        assert infer_timesteps(d) == jconvert.infer_timesteps(d) == 123
    assert infer_timesteps({"init_conv.weight": torch.zeros(1)}) is None
    assert strip_prefixes({"state_dict": sd}).keys() == got.keys()
    with pytest.raises(ValueError, match="reference checkpoint"):
        load_reference_unet2d(UNet2D(base_channels=8, channel_mults=(1, 2)),
                              {"init_conv.weight": torch.zeros(8, 1, 3, 3)})


@pytest.mark.parametrize("prefix", ["", "module."])
def test_convert_reference_unet3d_matches_the_torch_twin(prefix):
    """Bottleneck attention included: the twin's 1×1×1 qkv / proj
    convolutions become the port's linears."""
    torch.manual_seed(0)
    twin = TUNet3D(cin=4, base=16, mults=(1, 2), tdim=32, heads=2).eval()
    sd = convert_reference_unet3d({prefix + k: v for k, v in twin.state_dict().items()})
    assert sd["mid_attn.qkv.weight"].shape == (96, 32)
    model = UNet3D(in_channels=4, base_channels=16, channel_mults=(1, 2), time_emb_dim=32,
                   num_heads=2, use_attention=True).eval()
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    t = torch.tensor([5])
    with torch.no_grad():
        want = twin(channels_first(x), t)
        got = model(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), channels_last(want), atol=ATOL)
    params = jconvert.convert_reference_unet3d(twin.state_dict(), channel_mults=(1, 2))
    assert_same_state(model, unet3d_state_dict_from_flax(params, (1, 2)))


@pytest.mark.parametrize("nested", [False, True])
def test_convert_reference_vae3d_matches_the_torch_twin(nested):
    torch.manual_seed(1)
    twin = TVAE3D(cin=4, base=16, num_down=2, latent=4).eval()
    sd = {f"module.{k}": v for k, v in twin.state_dict().items()}
    model = VAE3D(in_channels=4, base_channels=16, num_down=2, latent_channels=4).eval()
    model.load_state_dict(convert_reference_vae3d({"state_dict": sd} if nested else sd),
                          strict=True)
    x = np.random.default_rng(1).normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        mu_t, logvar_t = twin.encoder(channels_first(x))
        recon_t = twin.decoder(mu_t)
        mu, logvar = model.encode(torch.from_numpy(x))
        recon = model.decode_from_latent(mu)
    np.testing.assert_allclose(mu.numpy(), channels_last(mu_t), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), channels_last(logvar_t), atol=ATOL)
    np.testing.assert_allclose(recon.numpy(), channels_last(recon_t), atol=ATOL)
    params = jconvert.convert_reference_vae3d(twin.state_dict(), num_down=2)
    assert_same_state(model, vae3d_state_dict_from_flax(params, 2))
