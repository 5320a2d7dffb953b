"""Multi-head self-attention over flattened spatial tokens (plain path).

Counterpart of ``mrijax/ops/attention.py``: per-head ``softmax(qᵀk · scale) v``
with ``scale = head_dim ** -0.5``. ``mrijax_torch.kernels.flash_attention``
provides the hand-written flash (online-softmax, O(N) memory) kernel; both
produce the same results within tolerance.
"""

import torch


def multi_head_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Attention over tokens. q, k, v: (B, N, H, Dh). Returns (B, N, H, Dh).

    Logits and softmax are computed in float32 (bf16-safe); the probabilities
    are cast to the input dtype for the value product and the result is cast
    back to the input dtype.
    """
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    # (B, H, N, M), accumulated in fp32
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    attn = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = attn / attn.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(dtype).float(), v.float())
    return out.to(dtype)
