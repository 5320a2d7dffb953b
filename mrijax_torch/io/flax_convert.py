"""Carry flax parameter trees of the JAX package over to the port's modules.

The functions take the flax tree **as nested dicts of numpy arrays** (with or
without the outer ``{"params": ...}``) and return a ``state_dict`` for
``mrijax_torch.models``; nothing of JAX is imported. They are the inverse of
the JAX package's reference-checkpoint converter, which maps the same
PyTorch key layout onto flax names.

Leaf transforms:

* Conv           flax (*k, I, O)  →  torch (O, I, *k)
* ConvTranspose  flax (*k, I, O)  →  torch (I, O, *k), spatially flipped
  (flax ``padding="SAME"``, kernel 4, stride 2 ≡ ``ConvTranspose{2,3}d(4, 2, 1)``)
* Dense          flax (I, O)      →  torch (O, I)
* GroupNorm      scale/bias       →  weight/bias (fp32)

The fused qkv ``Dense(3C)`` splits as (3, H, Dh) along its output axis in both
packages, so it carries over without a permutation.

flax auto-names follow creation order in the flax modules: ``Conv_0`` (stem),
``ResBlock3D_{n}`` / ``ResBlock2D_{n}``, ``Downsample_{i}``, ``Upsample_{k}``,
``AttentionBlock3D_0`` (bottleneck), ``DownAttn_{i}`` / ``UpAttn_{i}``
(``attention_levels``), ``GroupNormSiLU_0`` + ``Conv_1`` (head); the 2D UNet
adds ``TimeEmbedding_0`` and ``ScalarCondEmbedding_0``. Inside ``ResBlock2D``
the convolutions are ``Conv_0``, ``Conv_1`` and the skip ``Conv_2``, created
in that order.

``train_state_from_flax`` carries a whole flax ``TrainState`` over (params,
Adam moments and count, learning rate, EMA shadow), so that both packages can
go on from the same mid-run state. The leaf transforms are permutations, so
the moments take the same route as the parameters they belong to.

The evaluation suite's networks (``mrijax_torch.evals``: ``ConvFeatureNet``,
``InceptionV3``, ``ResNet18``, ``LPIPS``) carry the flax tree's names as
module names, so their bridge is mechanical: a ``{kernel, bias}`` node is a
convolution, a ``{scale, bias}`` node a GroupNorm, a bare array (LPIPS's
``lin{i}`` heads) a parameter as it is; the path joined by ``.`` is the key.
"""

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mrijax_torch.train.state import TrainState, create_train_state


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


def _put_resblock2d(sd: Dict, prefix: str, p: Mapping) -> None:
    _put_conv(sd, f"{prefix}.conv1", p["Conv_0"])
    _put_norm(sd, f"{prefix}.norm1", p["GroupNormSiLU_0"])
    _put_linear(sd, f"{prefix}.time_mlp", p["Dense_0"])
    _put_conv(sd, f"{prefix}.conv2", p["Conv_1"])
    _put_norm(sd, f"{prefix}.norm2", p["GroupNormSiLU_1"])
    if "Conv_2" in p:
        _put_conv(sd, f"{prefix}.res_conv", p["Conv_2"])


def unet2d_state_dict_from_flax(
    params: Mapping, *, channel_mults: Sequence[int] = (1, 2, 4, 8),
) -> Dict[str, torch.Tensor]:
    """flax params of the JAX package's ``UNet2D`` → ``state_dict`` of
    ``mrijax_torch.models.UNet2D`` built with the same configuration (1-channel
    or 2.5D: the channel counts come with the tensors)."""
    p = _unwrap(params)
    n_trans = len(channel_mults) - 1
    sd: Dict[str, torch.Tensor] = {}
    _put_linear(sd, "time_mlp.1", p["TimeEmbedding_0"]["Dense_0"])
    _put_linear(sd, "time_mlp.3", p["TimeEmbedding_0"]["Dense_1"])
    _put_linear(sd, "slice_mlp.0", p["ScalarCondEmbedding_0"]["Dense_0"])
    _put_linear(sd, "slice_mlp.2", p["ScalarCondEmbedding_0"]["Dense_1"])
    _put_conv(sd, "init_conv", p["Conv_0"])
    rb = 0
    for i in range(n_trans):
        _put_resblock2d(sd, f"downs.{i}.res1", p[f"ResBlock2D_{rb}"])
        _put_resblock2d(sd, f"downs.{i}.res2", p[f"ResBlock2D_{rb + 1}"])
        _put_conv(sd, f"downs.{i}.down", p[f"Downsample_{i}"]["Conv_0"])
        rb += 2
    _put_resblock2d(sd, "mid_block1", p[f"ResBlock2D_{rb}"])
    _put_resblock2d(sd, "mid_block2", p[f"ResBlock2D_{rb + 1}"])
    rb += 2
    for j in range(n_trans):
        _put_convt(sd, f"ups.{j}.up", p[f"Upsample_{j}"]["ConvTranspose_0"])
        _put_resblock2d(sd, f"ups.{j}.res1", p[f"ResBlock2D_{rb}"])
        _put_resblock2d(sd, f"ups.{j}.res2", p[f"ResBlock2D_{rb + 1}"])
        rb += 2
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


def _feature_net_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            name = prefix + str(key)
            if not isinstance(value, Mapping):
                sd[name] = _tensor(value)
            elif "kernel" in value:
                _put_conv(sd, name, value)
            elif "scale" in value:
                _put_norm(sd, name, value)
            else:
                walk(value, name + ".")

    walk(_unwrap(params), "")
    return sd


def conv_feature_net_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax params of the JAX package's ``ConvFeatureNet`` (``Conv_{2i}``,
    ``GroupNorm_{i}``, ``Conv_{2i+1}`` per width) → ``state_dict`` of
    ``mrijax_torch.evals.ConvFeatureNet`` of the same widths."""
    return _feature_net_state_dict(params)


def inception_v3_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax tree of the JAX package's ``InceptionV3`` (a flax init, or
    ``convert_inception_v3`` of a torchvision checkpoint) → ``state_dict`` of
    ``mrijax_torch.evals.InceptionV3``."""
    return _feature_net_state_dict(params)


def resnet18_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax tree of the JAX package's ``ResNet18`` (or
    ``convert_resnet18``'s) → ``state_dict`` of ``mrijax_torch.evals.ResNet18``."""
    return _feature_net_state_dict(params)


def lpips_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax tree of the JAX package's ``LPIPS`` (or
    ``convert_lpips_alex``'s) → ``state_dict`` of ``mrijax_torch.evals.LPIPS``."""
    return _feature_net_state_dict(params)


def train_state_from_flax(
    model: torch.nn.Module,
    convert: Callable[[Mapping], Dict[str, torch.Tensor]],
    *,
    params: Mapping,
    mu: Mapping,
    nu: Mapping,
    count: int,
    learning_rate: float,
    ema_params: Optional[Mapping] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainState:
    """The numpy pieces of a flax ``TrainState`` of the JAX package → the
    port's train state around ``model``.

    ``convert`` maps a flax tree onto ``model``'s ``state_dict`` layout, for
    example ``functools.partial(unet3d_state_dict_from_flax,
    channel_mults=...)`` (``unet2d_state_dict_from_flax`` likewise). ``mu``,
    ``nu`` and ``count`` are optax Adam's first and second moments (trees
    like ``params``) and its step count,
    ``learning_rate`` the injected hyperparameter, ``ema_params`` the shadow
    tree or ``None``.
    """
    model.load_state_dict(convert(params), strict=True)
    state = create_train_state(model, learning_rate, ema=ema_params is not None,
                               device=device)
    first, second = convert(mu), convert(nu)
    shadow = convert(ema_params) if ema_params is not None else None
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {
            # where torch.optim.Adam keeps its count by default: a float32
            # scalar on the host
            "step": torch.tensor(float(count), dtype=torch.float32),
            # in the parameter's own memory layout, as Adam allocates them
            "exp_avg": torch.empty_like(p).copy_(first[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(second[name]),
        }
        if shadow is not None:
            state.ema_params[name].copy_(shadow[name])
    state.step = int(count)
    return state
