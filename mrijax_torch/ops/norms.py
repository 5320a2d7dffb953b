"""Group normalization (channels-last) and the fused GroupNorm+SiLU op.

Counterpart of ``mrijax/ops/norms.py``. Semantics match
``torch.nn.GroupNorm(groups, C, eps=1e-5, affine=True)`` but operate on
channels-LAST tensors ``(B, *spatial, C)``. These are functional ops; the
learnable scale/bias live in the calling module.
"""

import torch
import torch.nn.functional as F

from mrijax_torch.kernels.groupnorm import group_norm_silu_fused


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over channels-last input of shape (B, *spatial, C).

    Statistics are computed in float32 and the result is cast back to the
    input dtype (bf16-safe).
    """
    orig_dtype = x.dtype
    xf = x.float()
    b, c = xf.shape[0], xf.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    # (B, prod(spatial), G, C/G) -> reduce over (spatial, C/G) per group
    xg = xf.reshape(b, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape)
    out = out * scale.float() + bias.float()
    return out.to(orig_dtype)


def group_norm_silu(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm followed by SiLU (the norm→act prologue of every res block)."""
    return F.silu(group_norm(x, num_groups, scale, bias, eps))


def group_norm_silu_auto(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The fused GroupNorm+SiLU of ``mrijax_torch.kernels.groupnorm``: the
    hand-written CUDA kernels (2 reads + 1 write) for a CUDA tensor, their
    plain version for a CPU tensor. The only thing that selects the plain
    version is where the tensor lies; any channel count divisible by
    ``num_groups`` is taken."""
    return group_norm_silu_fused(x, scale, bias, num_groups, eps)
