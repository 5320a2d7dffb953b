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

The feature backbones of the evaluation suite (Inception, ResNet-18, LPIPS)
come with the evals port.
"""

from typing import Dict, Mapping, Optional

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
