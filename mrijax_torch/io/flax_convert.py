"""Carry flax parameter trees of the JAX package over to the port's modules.

The functions take the flax tree **as nested dicts of numpy arrays** (with or
without the outer ``{"params": ...}``) and return a ``state_dict`` for
``mrijax_torch.models``; nothing of JAX is imported. They are the inverse of
the JAX package's reference-checkpoint converter, which maps the same
PyTorch key layout onto flax names.

Leaf transforms:

* Conv           flax (*k, I, O)  →  torch (O, I, *k)
* ConvTranspose  flax (*k, I, O)  →  torch (I, O, *k), spatially flipped
  (flax ``padding="SAME"``, kernel 4, stride 2 ≡ ``ConvTranspose3d(4, 2, 1)``)
* Dense          flax (I, O)      →  torch (O, I)
* GroupNorm      scale/bias       →  weight/bias (fp32)

The fused qkv ``Dense(3C)`` splits as (3, H, Dh) along its output axis in both
packages, so it carries over without a permutation.

flax auto-names follow creation order in the flax modules: ``Conv_0`` (stem),
``ResBlock3D_{n}``, ``Downsample_{i}``, ``Upsample_{k}``, ``AttentionBlock3D_0``
(bottleneck), ``DownAttn_{i}`` / ``UpAttn_{i}`` (``attention_levels``),
``GroupNormSiLU_0`` + ``Conv_1`` (head).
"""

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def conv_weight(kernel) -> torch.Tensor:
    """flax (*k, I, O) → torch (O, I, *k)."""
    k = np.asarray(kernel)
    spatial = tuple(range(k.ndim - 2))
    return _tensor(k.transpose(k.ndim - 1, k.ndim - 2, *spatial))


def convt_weight(kernel) -> torch.Tensor:
    """flax ConvTranspose (*k, I, O) → torch (I, O, *k), spatially flipped."""
    k = np.asarray(kernel)
    spatial = tuple(range(k.ndim - 2))
    w = k.transpose(k.ndim - 2, k.ndim - 1, *spatial)
    flip = tuple(slice(None, None, -1) for _ in spatial)
    return _tensor(w[(slice(None), slice(None)) + flip])


def linear_weight(kernel) -> torch.Tensor:
    """flax Dense (I, O) → torch (O, I)."""
    return _tensor(np.asarray(kernel).T)


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _put_conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = conv_weight(p["kernel"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _put_convt(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = convt_weight(p["kernel"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _put_linear(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = linear_weight(p["kernel"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _put_norm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _tensor(p["scale"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _put_resblock(sd: Dict, prefix: str, p: Mapping) -> None:
    _put_norm(sd, f"{prefix}.norm1", p["GroupNormSiLU_0"])
    _put_conv(sd, f"{prefix}.conv1", p["Conv_0"])
    if "Dense_0" in p:
        _put_linear(sd, f"{prefix}.time_mlp", p["Dense_0"])
    _put_norm(sd, f"{prefix}.norm2", p["GroupNormSiLU_1"])
    _put_conv(sd, f"{prefix}.conv2", p["Conv_1"])
    if "Conv_2" in p:
        _put_conv(sd, f"{prefix}.skip", p["Conv_2"])


def _put_attention(sd: Dict, prefix: str, p: Mapping) -> None:
    _put_norm(sd, f"{prefix}.norm", p["GroupNorm_0"])
    _put_linear(sd, f"{prefix}.qkv", p["Dense_0"])
    _put_linear(sd, f"{prefix}.proj", p["Dense_1"])


def unet3d_state_dict_from_flax(
    params: Mapping,
    channel_mults: Sequence[int] = (1, 2, 4),
    use_attention: bool = True,
    attention_levels: Sequence[int] = (),
) -> Dict[str, torch.Tensor]:
    """flax params of the JAX package's ``UNet3D`` → ``state_dict`` of
    ``mrijax_torch.models.UNet3D`` built with the same configuration."""
    p = _unwrap(params)
    levels = len(channel_mults)
    sd: Dict[str, torch.Tensor] = {}
    _put_linear(sd, "time_mlp.1", p["TimeEmbedding_0"]["Dense_0"])
    _put_linear(sd, "time_mlp.3", p["TimeEmbedding_0"]["Dense_1"])
    _put_conv(sd, "in_conv", p["Conv_0"])
    rb = 0
    for i in range(levels):
        _put_resblock(sd, f"downs.{i}.res1", p[f"ResBlock3D_{rb}"])
        _put_resblock(sd, f"downs.{i}.res2", p[f"ResBlock3D_{rb + 1}"])
        rb += 2
        if i in attention_levels:
            _put_attention(sd, f"downs.{i}.attn", p[f"DownAttn_{i}"])
        if i != levels - 1:
            _put_conv(sd, f"downs.{i}.down", p[f"Downsample_{i}"]["Conv_0"])
    _put_resblock(sd, "mid1", p[f"ResBlock3D_{rb}"])
    rb += 1
    if use_attention:
        _put_attention(sd, "mid_attn", p["AttentionBlock3D_0"])
    _put_resblock(sd, "mid2", p[f"ResBlock3D_{rb}"])
    rb += 1
    # up path: ups.j is level levels-1-j; ups.0 has no transposed conv
    for j in range(levels):
        i = levels - 1 - j
        if j > 0:
            _put_convt(sd, f"ups.{j}.up", p[f"Upsample_{j - 1}"]["ConvTranspose_0"])
        _put_resblock(sd, f"ups.{j}.res1", p[f"ResBlock3D_{rb}"])
        _put_resblock(sd, f"ups.{j}.res2", p[f"ResBlock3D_{rb + 1}"])
        rb += 2
        if i in attention_levels:
            _put_attention(sd, f"ups.{j}.attn", p[f"UpAttn_{i}"])
    _put_norm(sd, "out_norm", p["GroupNormSiLU_0"])
    _put_conv(sd, "out_conv", p["Conv_1"])
    return sd


def vae3d_state_dict_from_flax(
    params: Mapping, num_down: int = 3
) -> Dict[str, torch.Tensor]:
    """flax params of the JAX package's ``VAE3D`` → ``state_dict`` of
    ``mrijax_torch.models.VAE3D`` built with the same configuration."""
    p = _unwrap(params)
    enc, dec = p["encoder"], p["decoder"]
    sd: Dict[str, torch.Tensor] = {}

    _put_conv(sd, "encoder.in_conv", enc["Conv_0"])
    # encoder.downs is a flat list: [res, (res, conv)] per level
    k = rb = 0
    for i in range(num_down):
        _put_resblock(sd, f"encoder.downs.{k}", enc[f"ResBlock3D_{rb}"])
        rb, k = rb + 1, k + 1
        if i != num_down - 1:
            _put_resblock(sd, f"encoder.downs.{k}", enc[f"ResBlock3D_{rb}"])
            rb, k = rb + 1, k + 1
            _put_conv(sd, f"encoder.downs.{k}", enc[f"Downsample_{i}"]["Conv_0"])
            k += 1
    _put_conv(sd, "encoder.to_mu_logvar", enc["Conv_1"])

    _put_conv(sd, "decoder.from_latent", dec["Conv_0"])
    k = rb = 0
    for i in reversed(range(num_down)):
        _put_resblock(sd, f"decoder.ups.{k}", dec[f"ResBlock3D_{rb}"])
        rb, k = rb + 1, k + 1
        if i != 0:
            _put_resblock(sd, f"decoder.ups.{k}", dec[f"ResBlock3D_{rb}"])
            rb, k = rb + 1, k + 1
            up = dec[f"Upsample_{num_down - 1 - i}"]["ConvTranspose_0"]
            _put_convt(sd, f"decoder.ups.{k}", up)
            k += 1
    _put_conv(sd, "decoder.out_conv", dec["Conv_1"])
    return sd
