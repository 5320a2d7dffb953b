"""2D slice UNet — the slice-position-conditioned 2D DDPM and the 2.5D
all-modalities DDPM.

Counterpart of ``mrijax/models/unet2d.py``. Topology (parity):
* channels = base·mults, default 64·(1, 2, 4, 8);
* conditioning = time embedding + slice-position embedding, summed, injected
  into every res block;
* down path: per transition {res(in→out), res(out→out), conv4 s2}, storing
  the pre-downsample activation as the skip;
* bottleneck: two res blocks;
* up path: convT4 s2 (in→out) → bilinear resize on a shape mismatch (odd
  sizes) → concat skip → res(out+skip→out) → res(out→out);
* head: GN → SiLU → conv3×3 → out_channels.

Layout is channels-last (B, H, W, C). Module names follow the reference
PyTorch layout, so a reference checkpoint loads as it is
(``mrijax_torch.io.torch_convert.load_reference_unet2d``): ``time_mlp``,
``slice_mlp``, ``init_conv``, ``downs.{i}.res1/res2/down``, ``mid_block1``,
``mid_block2``, ``ups.{j}.up/res1/res2``, ``out_norm``, ``out_conv``.

``remat`` recomputes every res block in the backward pass
(``torch.utils.checkpoint``, non-reentrant); the ``state_dict`` keys do not
depend on it. ``dtype`` is the compute dtype, ``param_dtype`` the dtype the
convolutions and linears hold their parameters in (``None``: ``dtype``;
training uses float32). The output is float32.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mrijax_torch.models.blocks import (
    Conv2d,
    Downsample2D,
    GroupNormSiLU,
    ResBlock2D,
    ScalarCondEmbedding,
    TimeEmbedding,
    Upsample2D,
)
from mrijax_torch.ops.resize import resize_bilinear


class UNet2D(nn.Module):
    """Slice-position-conditioned 2D UNet.

    For the 2.5D all-modalities model use ``in_channels=4·(1+2·radius)``,
    ``out_channels=4`` and pass ``context`` (the neighbour slices,
    channels-last) to ``forward``: it is concatenated on the channel axis
    before the stem convolution.
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        base_channels: int = 64,
        channel_mults: Sequence[int] = (1, 2, 4, 8),
        time_emb_dim: int = 256,
        groups: int = 8,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        param_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        chs = [base_channels * m for m in channel_mults]
        kw = dict(dtype=dtype, param_dtype=param_dtype)

        def res(cin, cout):
            return ResBlock2D(cin, cout, time_emb_dim, groups, **kw)

        self.time_mlp = TimeEmbedding(time_emb_dim, **kw)
        self.slice_mlp = ScalarCondEmbedding(time_emb_dim, **kw)
        self.init_conv = Conv2d(in_channels, chs[0], 3, padding=1, **kw)

        self.downs = nn.ModuleList()
        for cin, cout in zip(chs[:-1], chs[1:]):
            self.downs.append(nn.ModuleDict({
                "res1": res(cin, cout), "res2": res(cout, cout),
                "down": Downsample2D(cout, cout, **kw)}))

        self.mid_block1 = res(chs[-1], chs[-1])
        self.mid_block2 = res(chs[-1], chs[-1])

        self.ups = nn.ModuleList()
        cur = chs[-1]
        for skip_ch, cout in zip(reversed(chs[1:]), reversed(chs[:-1])):
            self.ups.append(nn.ModuleDict({
                "up": Upsample2D(cur, cout, **kw),
                "res1": res(cout + skip_ch, cout), "res2": res(cout, cout)}))
            cur = cout

        self.out_norm = GroupNormSiLU(chs[0], groups)
        self.out_conv = Conv2d(chs[0], out_channels, 3, padding=1, **kw)
        # conv weights in the layout the channels-last convolutions read
        self.to(memory_format=torch.channels_last)

    def _res(self, block: ResBlock2D, h: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """One res block, recomputed in the backward pass under ``remat``."""
        if self.remat and torch.is_grad_enabled():
            # the blocks draw no random numbers: no generator state to carry
            return checkpoint(block, h, cond, use_reentrant=False,
                              preserve_rng_state=False)
        return block(h, cond)

    def forward(self, x: torch.Tensor, t: torch.Tensor, z_pos: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C) noisy slice, t: (B,) integer timesteps, z_pos: (B,)
        slice positions (``CFG_NULL_Z`` for "no condition"), context:
        (B, H, W, Ck) or None → predicted noise (B, H, W, out_channels) in
        float32."""
        cond = self.time_mlp(t) + self.slice_mlp(z_pos)
        if context is not None:
            x = torch.cat([x, context.to(x.dtype)], dim=-1)
        h = self.init_conv(x.to(self.dtype))

        skips = []
        for block in self.downs:
            h = self._res(block["res2"], self._res(block["res1"], h, cond), cond)
            skips.append(h)
            h = block["down"](h)

        h = self._res(self.mid_block2, self._res(self.mid_block1, h, cond), cond)

        for block in self.ups:
            skip = skips.pop()
            h = block["up"](h)
            if h.shape[1:3] != skip.shape[1:3]:
                h = resize_bilinear(h, skip.shape[1:3])
            h = torch.cat([h, skip], dim=-1)
            h = self._res(block["res2"], self._res(block["res1"], h, cond), cond)

        return self.out_conv(self.out_norm(h)).float()
