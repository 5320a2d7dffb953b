"""Load checkpoints of the reference PyTorch models into the port's models.

Counterpart of the model converters of ``mrijax/io/torch_convert.py``. The
port's modules carry the reference's own names (``time_mlp``, ``slice_mlp``,
``init_conv``, ``downs.{i}.res1``, …; ``norm1``/``conv1``/``time_mlp``/
``norm2``/``conv2`` with ``res_conv`` in 2D and ``skip`` in 3D), and its
convolutions the reference's channels-first weight layout, so most of a
reference ``state_dict`` loads as it is. What is left to do here:

* unwrap the checkpoint: a ``{"state_dict": ...}`` nesting and the
  ``model.`` / ``module.`` prefixes of the reference's diffusion wrapper and of
  DataParallel / DDP (the three remaps of the reference's sampling script);
  the schedule buffers (``betas``, …) are dropped, as the port recomputes them
  from the config — ``infer_timesteps`` reads T from them first;
* the 3D attention block: the reference's 1×1×1 ``qkv`` and ``proj``
  convolutions are ``nn.Linear`` layers over the channel axis in the port,
  so their (O, I, 1, 1, 1) weights become (O, I). The fused qkv output splits
  as (3, heads, Dh) in both.

The feature backbones of the evaluation suite (torchvision ``inception_v3``
and ``resnet18``, ``lpips.LPIPS(net="alex")``) convert as in the JAX package:
``convert_inception_v3``, ``convert_resnet18`` and ``convert_lpips_alex``
return the JAX converters' **numpy flax tree** (BatchNorm folded into the
convolution in float64, kernels (kh, kw, I, O)), so an npz written by either
package's ``save_params_npz`` loads in the other; the port's extractors carry
the tree onto their modules with ``mrijax_torch.io.flax_convert``.
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_PREFIXES = ("model.module.", "module.model.", "model.", "module.")


def _unnest(state_dict: Mapping) -> Mapping:
    inner = state_dict.get("state_dict")
    return inner if isinstance(inner, Mapping) else state_dict


def strip_prefixes(state_dict: Mapping) -> StateDict:
    """Unwrap ``{"state_dict": ...}`` nesting and drop DataParallel / DDP
    prefixes, keeping only the UNet's ``model.*`` subtree (the schedule
    buffers are dropped). Values become tensors."""
    out = {}
    for k, v in _unnest(state_dict).items():
        for pre in _PREFIXES:
            if k.startswith(pre):
                out[k[len(pre):]] = torch.as_tensor(v)
                break
    return out


def infer_timesteps(state_dict: Mapping) -> Optional[int]:
    """T from the checkpointed ``betas`` buffer (at the top level, else in a
    ``{"state_dict": ...}`` nesting), or None without one."""
    if "betas" in state_dict:
        return int(torch.as_tensor(state_dict["betas"]).shape[0])
    inner = state_dict.get("state_dict")
    return infer_timesteps(inner) if isinstance(inner, Mapping) else None


def load_reference_unet2d(model: torch.nn.Module, state_dict: Mapping) -> torch.nn.Module:
    """A reference 2D / 2.5D UNet checkpoint (``diffusion.state_dict()``:
    the UNet under ``model.*`` beside the schedule buffers) → ``model``, a
    ``mrijax_torch.models.UNet2D`` of the same configuration, loaded
    strictly. Returns ``model``."""
    p = strip_prefixes(state_dict)
    if not p:
        raise ValueError("no model.* keys found — is this a reference checkpoint?")
    model.load_state_dict(p, strict=True)
    return model


def _linear_from_conv1x1(sd: StateDict) -> StateDict:
    """(O, I, 1, 1, 1) weights of the attention's ``qkv`` / ``proj`` → the
    (O, I) of ``nn.Linear``; every other entry as it is."""
    out = {}
    for k, v in sd.items():
        if k.endswith((".qkv.weight", ".proj.weight")) and v.dim() == 5:
            v = v.reshape(v.shape[0], v.shape[1])
        out[k] = v
    return out


def convert_reference_unet3d(state_dict: Mapping) -> StateDict:
    """Reference ``UNet3DModel[WithAttention]`` weights → ``state_dict`` of
    ``mrijax_torch.models.UNet3D`` of the same configuration (load it with
    ``strict=True``). A 3D checkpoint may be saved without the wrapper's
    prefixes; then its keys are taken as they are."""
    p = strip_prefixes(state_dict)
    if not p:
        p = {k: torch.as_tensor(v) for k, v in _unnest(state_dict).items()}
    return _linear_from_conv1x1(p)


def convert_reference_vae3d(state_dict: Mapping) -> StateDict:
    """Reference ``VAE3D`` weights → ``state_dict`` of
    ``mrijax_torch.models.VAE3D`` of the same configuration: the
    ``{"state_dict": ...}`` nesting and a DataParallel ``module.`` prefix
    removed, nothing else to change."""
    return {k[len("module."):] if k.startswith("module.") else k: torch.as_tensor(v)
            for k, v in _unnest(state_dict).items()}


# --------------------------------------------------- eval feature backbones


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _conv_kernel(w) -> np.ndarray:
    """(O, I, kh, kw) → flax (kh, kw, I, O)."""
    w = _np(w)
    return np.ascontiguousarray(w.transpose(*range(2, w.ndim), 1, 0))


def _fold_bn(p: Mapping, conv_key: str, bn_key: str, *, eps: float) -> dict:
    """Fold an inference-mode BatchNorm into the preceding conv — exact:
    BN(conv(x)+b) = s·conv(x) + (s·(b−μ) + β) with s = γ/√(σ²+eps)."""
    w = _np(p[f"{conv_key}.weight"])  # (O, I, kh, kw)
    gamma = _np(p[f"{bn_key}.weight"]).astype(np.float64)
    beta = _np(p[f"{bn_key}.bias"]).astype(np.float64)
    mean = _np(p[f"{bn_key}.running_mean"]).astype(np.float64)
    var = _np(p[f"{bn_key}.running_var"]).astype(np.float64)
    s = gamma / np.sqrt(var + eps)
    kernel = _conv_kernel(
        (w.astype(np.float64) * s[:, None, None, None]).astype(np.float32))
    b = _np(p[f"{conv_key}.bias"]).astype(np.float64) if f"{conv_key}.bias" in p else 0.0
    bias = (s * (b - mean) + beta).astype(np.float32)
    return {"kernel": kernel, "bias": bias}


def convert_inception_v3(state_dict: Mapping) -> dict:
    """torchvision ``inception_v3`` state_dict → the flax params tree of
    ``InceptionV3`` (BN folded, eps=1e-3; fc and AuxLogits dropped — only the
    2048-d pool3 trunk is used for FID/KID,
    `evaluation_scripts/evaluate_models.py:94-99`)."""
    p = {k: _np(v) for k, v in state_dict.items()}
    params: dict = {}
    for k in p:
        if not k.endswith(".conv.weight"):
            continue
        prefix = k[: -len(".conv.weight")]
        if prefix.startswith(("AuxLogits", "fc")):
            continue
        node = params
        for part in prefix.split("."):
            node = node.setdefault(part, {})
        node["conv"] = _fold_bn(p, f"{prefix}.conv", f"{prefix}.bn", eps=1e-3)
    if "Conv2d_1a_3x3" not in params:
        raise ValueError("not a torchvision inception_v3 state_dict")
    return {"params": params}


def convert_resnet18(state_dict: Mapping) -> dict:
    """torchvision ``resnet18`` state_dict → the flax params tree of
    ``ResNet18`` (BN folded, eps=1e-5; fc dropped — the PR extractor
    replaces it with Identity, metrics.py:156-160)."""
    p = {k: _np(v) for k, v in state_dict.items()}
    if "conv1.weight" not in p:
        raise ValueError("not a torchvision resnet18 state_dict")
    params: dict = {"conv1": _fold_bn(p, "conv1", "bn1", eps=1e-5)}
    for layer in range(1, 5):
        for blk in range(2):
            t = f"layer{layer}.{blk}"
            node = {
                "conv1": _fold_bn(p, f"{t}.conv1", f"{t}.bn1", eps=1e-5),
                "conv2": _fold_bn(p, f"{t}.conv2", f"{t}.bn2", eps=1e-5),
            }
            if f"{t}.downsample.0.weight" in p:
                node["downsample"] = _fold_bn(
                    p, f"{t}.downsample.0", f"{t}.downsample.1", eps=1e-5)
            params[f"layer{layer}_{blk}"] = node
    return {"params": params}


_ALEX_TAPS = (0, 3, 6, 8, 10)  # conv indices in alexnet.features
_ALEX_SLICES = (1, 2, 3, 4, 5)  # lpips slice holding each tap conv


def convert_lpips_alex(state_dict: Mapping) -> dict:
    """``lpips.LPIPS(net="alex")`` state_dict → the flax params tree of
    ``LPIPS``.

    Accepts the lpips-package key layout (``net.slice1.0.weight`` +
    ``lin0.model.1.weight``) and the flat variant (``features.0.weight`` +
    ``lin0.weight``). The scaling-layer buffers are fixed constants of the
    module, so they are ignored here."""
    p = {k: _np(v) for k, v in state_dict.items()}
    net: dict = {}
    lins: dict = {}
    for i, (gi, sl) in enumerate(zip(_ALEX_TAPS, _ALEX_SLICES)):
        for wkey in (f"net.slice{sl}.{gi}.weight", f"features.{gi}.weight"):
            if wkey in p:
                bkey = wkey[: -len("weight")] + "bias"
                net[f"conv{gi}"] = {"kernel": _conv_kernel(p[wkey]), "bias": _np(p[bkey])}
                break
        else:
            raise ValueError(f"missing alexnet conv {gi} in LPIPS state_dict")
        for lkey in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                     f"lin{i}.1.weight", f"lin{i}.weight"):
            if lkey in p:
                lins[f"lin{i}"] = _np(p[lkey]).reshape(-1).astype(np.float32)
                break
        else:
            raise ValueError(f"missing lin{i} head in LPIPS state_dict")
    return {"params": {"net": net, **lins}}
