"""SSIM and MS-SSIM in PyTorch (channels-last), torchmetrics-compatible math.

Counterpart of ``mrijax/evals/ssim.py``. Used for the gen-vs-gen diversity
statistic (`slice_cond_2d_ddpm/metrics.py:419-443` uses SSIM;
`evaluation_scripts/metrics.py` uses MS-SSIM). Standard parameters: 11×11
Gaussian window σ=1.5, C1=(0.01·L)², C2=(0.03·L)²; MS-SSIM weights (0.0448,
0.2856, 0.3001, 0.2363, 0.1333) with 2× average-pool between scales.

The separable window runs as two depthwise ``F.conv2d`` (valid mode), the
pooling as ``F.avg_pool2d``, on the device of the inputs, in float32. Inputs
are (B, H, W, C) tensors or arrays (arrays go to the CPU).
"""

from typing import Tuple

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_separable(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable filtering of (B, C, H, W), one channel at a time."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_components(
    a: torch.Tensor, b: torch.Tensor, data_range: float, win_size: int, sigma: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (ssim_map, contrast_sensitivity_map) of (B, C, H, W) inputs."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window(win_size, sigma, a.device)
    mu_a = _filter2d_separable(a, win)
    mu_b = _filter2d_separable(b, win)
    mu_aa = _filter2d_separable(a * a, win)
    mu_bb = _filter2d_separable(b * b, win)
    mu_ab = _filter2d_separable(a * b, win)
    var_a = mu_aa - mu_a ** 2
    var_b = mu_bb - mu_b ** 2
    cov = mu_ab - mu_a * mu_b
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    ssim_map = ((2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)) * cs
    return ssim_map, cs


def _channels_first(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32).permute(0, 3, 1, 2)


@torch.no_grad()
def ssim(a, b, *, data_range: float = 2.0, win_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per batch element. a, b: (B, H, W, C) → (B,)."""
    ssim_map, _ = _ssim_components(_channels_first(a), _channels_first(b),
                                   data_range, win_size, sigma)
    return ssim_map.mean(dim=(1, 2, 3))


@torch.no_grad()
def ms_ssim(a, b, *, data_range: float = 2.0, win_size: int = 11, sigma: float = 1.5,
            levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM, (B, H, W, C) → (B,). Needs H, W ≥ win_size·2^(levels−1)
    (drop levels for small images)."""
    a, b = _channels_first(a), _channels_first(b)
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32, device=a.device)
    weights = weights / weights.sum()
    vals = []
    for i in range(levels):
        ssim_map, cs_map = _ssim_components(a, b, data_range, win_size, sigma)
        if i == levels - 1:
            vals.append(ssim_map.mean(dim=(1, 2, 3)).clamp_min(0.0))
        else:
            vals.append(cs_map.mean(dim=(1, 2, 3)).clamp_min(0.0))
            a = F.avg_pool2d(a, 2)
            b = F.avg_pool2d(b, 2)
    stacked = torch.stack(vals, dim=0)  # (levels, B)
    return torch.prod(stacked ** weights[:, None], dim=0)
