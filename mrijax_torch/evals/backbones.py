"""Pretrained-feature backbones for FID/KID, improved PR, and LPIPS.

Counterpart of ``mrijax/evals/backbones.py``: ``nn.Module`` versions of the
three torchvision/lpips architectures the reference evaluation stack runs on:

* ``InceptionV3`` — the 2048-d pool3 trunk of torchvision ``inception_v3``
  used for FID/KID (`evaluation_scripts/evaluate_models.py:82-131`,
  torchmetrics path `slice_cond_2d_ddpm/metrics.py:329-335`);
* ``ResNet18`` — the 512-d globally-pooled trunk used for improved
  precision/recall (`slice_cond_2d_ddpm/metrics.py:147-229`);
* ``AlexNetFeatures`` + ``LPIPS`` — the AlexNet-LPIPS perceptual distance
  used for diversity (`slice_cond_2d_ddpm/metrics.py:419-443`).

As in the JAX package, BatchNorm is folded into the preceding convolution's
weight and bias when the weights are converted
(``mrijax_torch.io.torch_convert.convert_inception_v3`` etc.), so every
``BasicConv`` is one biased convolution and a ReLU. Module names are the flax
tree's (``Mixed_5b.branch1x1.conv``, ``layer2_0.downsample``, ``net.conv3``,
``lin0``), so ``mrijax_torch.io.flax_convert`` carries a converted tree over
leaf by leaf.

Inputs and outputs are channels-last, ``(B, H, W, C)``, as in the JAX
package; the convolutions run on the channels-first *view* of that buffer (a
``channels_last`` tensor). Pools follow torchvision: the 3×3 average pools
count the padding (``count_include_pad=True``), the max pools are unpadded,
except ResNet's stem, which pads by 1 with −∞.
"""

from typing import List, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

# ImageNet normalization constants (evaluate_models.py:124-127)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Size2 = Union[int, Tuple[int, int]]


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BasicConv(nn.Module):
    """torchvision ``BasicConv2d`` with the BatchNorm folded in: conv(+bias)
    then ReLU (channels-first inside the trunks)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Size2, stride: int = 1,
                 padding: Size2 = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avg_pool3(x):
    # AvgPool2d(3, stride=1, padding=1), count_include_pad=True (torch default)
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        h = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(h), self.branch3x3_2b(h)], dim=1)
        h = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(h), self.branch3x3dbl_3b(h)], dim=1)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """torchvision ``inception_v3`` up to global average pool → 2048-d.

    Input: (B, 299, 299, 3), already ImageNet-normalized (the full [-1,1] →
    FID-feature pipeline lives in ``mrijax_torch.evals.features``).
    ``transform_input=True`` replicates torchvision's pretrained-model input
    remap (torchvision's IMAGENET1K_V1 weights turn it on); it runs after the
    normalisation.
    """

    def __init__(self, transform_input: bool = True):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_input:
            x = torch.cat([x[..., i:i + 1] * (IMAGENET_STD[i] / 0.5)
                           + (IMAGENET_MEAN[i] - 0.5) / 0.5 for i in range(3)], dim=-1)
        x = _to_nchw(x)
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _max_pool3s2(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _max_pool3s2(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))  # adaptive avgpool(1,1) → (B, 2048)


# ------------------------------------------------------------------ ResNet18


class ResNetBasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.downsample = nn.Conv2d(in_ch, out_ch, 1, stride=stride) if downsample else None

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet18(nn.Module):
    """torchvision ``resnet18`` trunk (fc → identity): 512-d pooled features.

    Input: (B, H, W, 3) ImageNet-normalized, any H/W ≥ 32 (the reference
    feeds 128² directly, metrics.py:456-476).
    """

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        cin = 64
        for layer, w in enumerate((64, 128, 256, 512), start=1):
            stride = 1 if layer == 1 else 2
            setattr(self, f"layer{layer}_0",
                    ResNetBasicBlock(cin, w, stride=stride, downsample=layer > 1))
            setattr(self, f"layer{layer}_1", ResNetBasicBlock(w, w))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(_to_nchw(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for layer in range(1, 5):
            x = getattr(self, f"layer{layer}_1")(getattr(self, f"layer{layer}_0")(x))
        return x.mean(dim=(2, 3))  # (B, 512)


# ----------------------------------------------------------- AlexNet / LPIPS

# LPIPS ScalingLayer constants (lpips/lpips.py, version 0.1)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

LPIPS_ALEX_TAP_CHANNELS = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    """torchvision ``alexnet.features`` conv trunk, returning the five ReLU
    taps LPIPS reads (after features[0,3,6,8,10]), each (B, H, W, C)."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv3 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv6 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv8 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv10 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        x = F.relu(self.conv0(_to_nchw(x)))
        taps.append(x)
        x = F.relu(self.conv3(_max_pool3s2(x)))
        taps.append(x)
        x = F.relu(self.conv6(_max_pool3s2(x)))
        taps.append(x)
        x = F.relu(self.conv8(x))
        taps.append(x)
        x = F.relu(self.conv10(x))
        taps.append(x)
        return [_to_nhwc(t) for t in taps]


class LPIPS(nn.Module):
    """AlexNet-LPIPS perceptual distance (lpips package semantics,
    ``net_type="alex"``, ``normalize=False`` → inputs in [-1, 1]).

    Per tap: unit-normalize across channels (eps 1e-10 added to the norm),
    squared difference, learned per-channel weights (the ``lin`` 1×1 convs,
    held here as vectors, initialised to ones as in flax), spatial mean,
    summed over the five taps.
    """

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(LPIPS_ALEX_TAP_CHANNELS):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(c)))
        # fixed constants, not weights: kept out of the state_dict
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE), persistent=False)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        f1 = self.net((x1 - self.shift) / self.scale)
        f2 = self.net((x2 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-10)
            d = torch.sum((a - b) ** 2 * getattr(self, f"lin{i}"), dim=-1)  # (B, H, W)
            total = total + d.mean(dim=(1, 2))
        return total  # (B,)


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisers for ``module`` in place: every convolution
    ``lecun_normal`` (a normal of variance 1/fan_in truncated at ±2 σ, the
    σ corrected for the truncation) with zero bias, every GroupNorm scale 1
    and bias 0; other parameters (LPIPS's ``lin`` heads: ones) as they are.
    The same distribution as a flax init, not the same draws."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return module

