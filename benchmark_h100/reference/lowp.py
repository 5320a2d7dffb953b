"""The control's lower precision: float8 with one scale a tensor.

The configurations compute in bfloat16; the nearest precision below it is
float8. ``quantize`` rounds a float32 tensor to float8 E4M3 with a scale
that maps its largest magnitude onto the format's largest finite value
(448), as a per-tensor scaled float8 matrix product does with its operands,
and returns it in float32. Under autograd the gradient passes straight
through and is itself rounded to float8 E5M2 with its own scale (largest
finite value 57 344), as float8 training rounds the gradients its backward
products take.
"""

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Quantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, dy):
        return _round(dy, torch.float8_e5m2, E5M2_MAX)


def quantize(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to scaled float8 E4M3 (its gradient to scaled E5M2)."""
    if x.device.type == "meta":
        return x
    return _Quantize.apply(x)
