"""Core tensor ops used across models (channels-last, as in ``mrijax.ops``)."""

from mrijax_torch.ops.attention import multi_head_self_attention
from mrijax_torch.ops.embeddings import sinusoidal_time_embedding
from mrijax_torch.ops.norms import group_norm, group_norm_silu, group_norm_silu_auto
from mrijax_torch.ops.resize import center_crop_to

__all__ = [
    "sinusoidal_time_embedding",
    "group_norm",
    "group_norm_silu",
    "group_norm_silu_auto",
    "center_crop_to",
    "multi_head_self_attention",
]
