"""3D UNet for latent diffusion — plain and bottleneck-attention variants.

Counterpart of ``mrijax/models/unet3d.py``. Topology (parity):
* per level i: {res(ch_i→ch_i), res(ch_i→ch_i), downsample conv4 s2 to
  ch_{i+1}} (no downsample at the last level); the skip is stored *before*
  the downsample;
* bottleneck: res → [attention] → res;
* up path: convT4 s2 (except at the top level) → center-crop skip on shape
  mismatch → concat → res(2ch→ch) → res(ch→ch);
* head: GN → SiLU → conv3×3×3 → in_channels.

Layout is channels-last (B, D, H, W, C). Module names follow the reference
PyTorch layout: ``in_conv``, ``downs.{i}.res1/res2/down``, ``mid1``,
``mid_attn``, ``mid2``, ``ups.{j}.up/res1/res2`` (``ups.0`` is the deepest
level and has no ``up``), ``out_norm``, ``out_conv``, ``time_mlp``; the extra
``attention_levels`` blocks are ``downs.{i}.attn`` / ``ups.{j}.attn``.

``remat`` / ``remat_levels`` recompute res blocks in the backward pass
(``torch.utils.checkpoint``, non-reentrant) to trade operations for memory;
a recomputed block launches its GroupNorm+SiLU kernels a second time. The
``state_dict`` keys do not depend on either. ``dtype`` is the compute dtype,
``param_dtype`` the dtype the convolutions and linears hold their parameters
in (``None``: ``dtype``; training uses float32).

``sp_axis`` and ``mesh`` split the token axis of every attention block over
that mesh axis (``parallel.sequence``); activations stay replicated over it.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mrijax_torch.models.blocks import (
    AttentionBlock3D,
    Conv3d,
    Downsample,
    GroupNormSiLU,
    ResBlock3D,
    TimeEmbedding,
    Upsample,
)
from mrijax_torch.ops.resize import center_crop_to


class UNet3D(nn.Module):
    def __init__(
        self,
        in_channels: int = 16,
        base_channels: int = 64,
        channel_mults: Sequence[int] = (1, 2, 4),
        time_emb_dim: int = 256,
        groups: int = 8,
        num_heads: int = 4,
        use_attention: bool = True,
        # extra attention at the listed resolution levels (0 = full latent
        # resolution) on both the down and up paths
        attention_levels: Sequence[int] = (),
        use_flash_attention: bool = True,
        # rematerialize every res block in the backward pass
        remat: bool = False,
        # selective remat: when set, ONLY the res blocks at these resolution
        # levels (0 = full latent resolution; the bottleneck counts as the
        # deepest level) are rematerialized, overriding ``remat``
        remat_levels: Optional[Sequence[int]] = None,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
        # sequence parallelism for the attention blocks (token axis split
        # over mesh axis ``sp_axis``); None = single-device attention
        sp_axis: Optional[str] = None,
        mesh=None,
    ):
        super().__init__()
        self.dtype = dtype
        chs = [base_channels * m for m in channel_mults]
        levels = len(chs)
        if remat_levels is not None:
            bad = [l for l in remat_levels if not 0 <= l < levels]
            if bad:
                # a mistyped level would otherwise switch remat off everywhere
                raise ValueError(
                    f"remat_levels {tuple(remat_levels)} out of range for "
                    f"{levels} resolution levels (valid: 0..{levels - 1})"
                )
            self._remat_levels = frozenset(remat_levels)
        else:
            self._remat_levels = frozenset(range(levels)) if remat else frozenset()

        def res(cin, cout):
            return ResBlock3D(cin, cout, time_emb_dim, groups, dtype, param_dtype)

        def attn(ch):
            return AttentionBlock3D(ch, num_heads, groups, dtype, use_flash_attention,
                                    param_dtype, sp_axis, mesh)

        self.time_mlp = TimeEmbedding(time_emb_dim, dtype, param_dtype)
        self.in_conv = Conv3d(in_channels, chs[0], 3, padding=1, dtype=dtype,
                              param_dtype=param_dtype)

        self.downs = nn.ModuleList()
        for i, ch in enumerate(chs):
            block = nn.ModuleDict({"res1": res(ch, ch), "res2": res(ch, ch)})
            if i in attention_levels:
                block["attn"] = attn(ch)
            if i != levels - 1:
                block["down"] = Downsample(ch, chs[i + 1], dtype, param_dtype)
            self.downs.append(block)

        self.mid1 = res(chs[-1], chs[-1])
        if use_attention:
            self.mid_attn = attn(chs[-1])
        self.mid2 = res(chs[-1], chs[-1])

        self.ups = nn.ModuleList()
        cur = chs[-1]
        for i in reversed(range(levels)):
            ch = chs[i]
            block = nn.ModuleDict()
            if i != levels - 1:
                block["up"] = Upsample(cur, ch, dtype, param_dtype)
            block["res1"] = res(2 * ch, ch)
            block["res2"] = res(ch, ch)
            if i in attention_levels:
                block["attn"] = attn(ch)
            self.ups.append(block)
            cur = ch

        self.out_norm = GroupNormSiLU(chs[0], groups)
        self.out_conv = Conv3d(chs[0], in_channels, 3, padding=1, dtype=dtype,
                               param_dtype=param_dtype)
        # conv weights in the layout the channels-last convolutions read
        self.to(memory_format=torch.channels_last_3d)

    def _res(self, level: int, block: ResBlock3D, h: torch.Tensor,
             t_emb: torch.Tensor) -> torch.Tensor:
        """One res block, recomputed in the backward pass at a remat level."""
        if level in self._remat_levels and torch.is_grad_enabled():
            # the blocks draw no random numbers: no generator state to carry
            return checkpoint(block, h, t_emb, use_reentrant=False,
                              preserve_rng_state=False)
        return block(h, t_emb)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, C) latent, t: (B,) integer timesteps → predicted
        noise (B, D, H, W, C) in float32."""
        t_emb = self.time_mlp(t)
        h = self.in_conv(x.to(self.dtype))
        deepest = len(self.downs) - 1

        skips = []
        for i, block in enumerate(self.downs):
            h = self._res(i, block["res2"], self._res(i, block["res1"], h, t_emb), t_emb)
            if "attn" in block:
                h = block["attn"](h)
            skips.append(h)
            if "down" in block:
                h = block["down"](h)

        h = self._res(deepest, self.mid1, h, t_emb)
        if hasattr(self, "mid_attn"):
            h = self.mid_attn(h)
        h = self._res(deepest, self.mid2, h, t_emb)

        for j, block in enumerate(self.ups):
            i = deepest - j
            if "up" in block:
                h = block["up"](h)
            skip = skips.pop()
            if h.shape[1:4] != skip.shape[1:4]:
                skip = center_crop_to(skip, h.shape[1:4])
            h = torch.cat([h, skip], dim=-1)
            h = self._res(i, block["res2"], self._res(i, block["res1"], h, t_emb), t_emb)
            if "attn" in block:
                h = block["attn"](h)

        return self.out_conv(self.out_norm(h)).float()
