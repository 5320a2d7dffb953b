"""Image feature extractors for FID/KID/precision-recall/perceptual metrics.

Counterpart of ``mrijax/evals/features.py``. The reference uses
ImageNet-pretrained extractors (Inception-v3 for FID/KID,
`evaluation_scripts/evaluate_models.py:82-131` and
`slice_cond_2d_ddpm/metrics.py:329-335`; ResNet18 for improved PR, :147-229;
AlexNet-LPIPS for diversity, :419-443). The architectures live in
``mrijax_torch.evals.backbones``; this module wraps them in the reference's
input pipelines:

* ``InceptionFeatureExtractor`` — [-1,1] → [0,1] clip → 3-channel → resize
  299 bilinear → ImageNet normalize → 2048-d pool3 features
  (evaluate_models.py:103-131).
* ``ResNet18FeatureExtractor`` — [-1,1] → [0,1] → 3-channel → ImageNet
  normalize → 512-d pooled features at native resolution
  (metrics.py:456-476), for improved precision/recall.
* ``LPIPSDistance`` — AlexNet-LPIPS perceptual distance on [-1,1] pairs.

Weights: ``weights_path`` takes an npz in the JAX package's layout — what
either package's ``save_params_npz`` writes of ``convert_inception_v3`` /
``convert_resnet18`` / ``convert_lpips_alex`` — and ``params`` the same flax
tree in memory; ``mrijax_torch.io.flax_convert`` carries it onto the module.
Metrics computed with such weights are reported as plain ``fid`` / ``kid``
(``metric_suffix`` ""). Without weights a network is initialised with flax's
initialisers from a torch generator seeded with ``seed``: the same
distribution as the JAX package's ``PRNGKey`` init, not the same draws, so the
port's ``fid_rand`` / ``kid_rand`` are not numerically comparable with the JAX
package's (nor with ImageNet FID) — they are labeled ``_rand``.

The networks run in float32 on ``device`` (default the card). The library
leaves torch's global flags alone: on the card cuDNN may use TF32 for these
convolutions unless the caller turns ``torch.backends.cudnn.allow_tf32`` off.
Calls take (B, H, W, C) tensors or arrays and return float32 tensors on
``device``; ``embed_batched`` returns a numpy array.
"""

from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mrijax_torch._device import require_device
from mrijax_torch.evals.backbones import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    LPIPS,
    InceptionV3,
    ResNet18,
    lecun_normal_,
)
from mrijax_torch.io.checkpoint import load_params_npz
from mrijax_torch.io.flax_convert import (
    conv_feature_net_state_dict_from_flax,
    inception_v3_state_dict_from_flax,
    lpips_state_dict_from_flax,
    resnet18_state_dict_from_flax,
)
from mrijax_torch.ops.resize import resize_bilinear

Device = Union[str, torch.device]


class ConvFeatureNet(nn.Module):
    """Per width: a stride-2 3×3 conv, GroupNorm (flax's eps 1e-6), SiLU, a
    3×3 conv, SiLU; then the global average → (B, widths[-1]). Channels-last
    in; module names are the flax auto-names (``Conv_{2i}``,
    ``GroupNorm_{i}``, ``Conv_{2i+1}``)."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512), groups: int = 8,
                 in_channels: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        cin = in_channels
        for i, w in enumerate(self.widths):
            gs = groups if w % groups == 0 else 1
            setattr(self, f"Conv_{2 * i}", nn.Conv2d(cin, w, 3, stride=2, padding=1))
            setattr(self, f"GroupNorm_{i}", nn.GroupNorm(gs, w, eps=1e-6))
            setattr(self, f"Conv_{2 * i + 1}", nn.Conv2d(w, w, 3, padding=1))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.widths)):
            h = getattr(self, f"Conv_{2 * i}")(h)
            h = F.silu(getattr(self, f"GroupNorm_{i}")(h))
            h = F.silu(getattr(self, f"Conv_{2 * i + 1}")(h))
        return h.mean(dim=(2, 3))  # global average pool -> (B, W[-1])


def _load(net: nn.Module, convert: Callable[[Mapping], dict], weights_path, params,
          seed: int, dev: torch.device) -> nn.Module:
    """``net`` on ``dev`` in eval mode with the flax tree ``params``, else the
    npz at ``weights_path``, else flax-like random weights drawn from
    ``seed``."""
    if params is None and weights_path is not None:
        params, _ = load_params_npz(weights_path)
    if params is not None:
        net.load_state_dict(convert(params), strict=True)
    else:
        lecun_normal_(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


class _Embedder:
    """What the three embedding extractors share: float32 input on the
    device, no autograd, batched embedding to numpy."""

    net: nn.Module
    device: torch.device

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        """images: (B, H, W, C) float in [-1, 1] → (B, dim) float32."""
        return self._embed(torch.as_tensor(images).to(self.device, torch.float32))

    def embed_batched(self, images, batch_size: int = 64) -> np.ndarray:
        out = []
        for i in range(0, images.shape[0], batch_size):
            out.append(self(images[i: i + batch_size]).cpu().numpy())
        return np.concatenate(out, axis=0)


class FeatureExtractor(_Embedder):
    """Deterministic feature embedding for batches of single-channel images
    in [-1, 1] (the eval protocol's model space): repeat to 3 channels,
    resize to ``image_size``, ``ConvFeatureNet``."""

    metric_suffix = "_rand"  # not ImageNet features — label metrics as such

    def __init__(
        self,
        image_size: int = 299,
        widths: Sequence[int] = (64, 128, 256, 512),
        seed: int = 0,
        weights_path: Optional[str] = None,
        device: Device = "cuda",
    ):
        self.device = require_device(device)
        self.image_size = image_size
        self.net = _load(ConvFeatureNet(widths=widths), conv_feature_net_state_dict_from_flax,
                         weights_path, None, seed, self.device)

    @property
    def dim(self) -> int:
        return self.net.widths[-1]

    def _embed(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = resize_bilinear(x, (self.image_size, self.image_size))
        return self.net(x)


# ----------------------------------------------------- pretrained pipelines


def _to_unit_rgb(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] (B,H,W,1|3) → [0,1] 3-channel (evaluate_models.py:110-117)."""
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def _imagenet_normalize(x01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x01.device)
    return (x01 - mean) / std


class InceptionFeatureExtractor(_Embedder):
    """Real-FID 2048-d features through the Inception-v3 trunk.

    ``weights_path`` takes an npz produced by::

        import torch
        from mrijax_torch.io import convert_inception_v3, save_params_npz
        sd = torch.load("inception_v3_google-*.pth", map_location="cpu")
        save_params_npz("inception.npz", convert_inception_v3(sd))

    (or by the JAX package's ``mrijax convert-features``). With converted
    ImageNet weights, ``metric_suffix`` is "" and the harness reports
    standard FID/KID comparable to BASELINE.md. Without weights (seeded
    random init) the suffix stays "_rand".
    """

    dim = 2048

    def __init__(
        self,
        weights_path: Optional[str] = None,
        params: Optional[Mapping] = None,
        image_size: int = 299,
        transform_input: bool = True,
        device: Device = "cuda",
    ):
        self.device = require_device(device)
        self.image_size = image_size
        self.metric_suffix = "" if (weights_path or params is not None) else "_rand"
        self.net = _load(InceptionV3(transform_input=transform_input),
                         inception_v3_state_dict_from_flax, weights_path, params, 0,
                         self.device)

    def _embed(self, x):
        x = resize_bilinear(_to_unit_rgb(x), (self.image_size, self.image_size))
        return self.net(_imagenet_normalize(x))


class ResNet18FeatureExtractor(_Embedder):
    """512-d features for improved precision/recall through the ResNet18
    trunk, fed at native resolution (no resize — metrics.py:456-476)."""

    dim = 512

    def __init__(self, weights_path: Optional[str] = None, params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        self.device = require_device(device)
        self.metric_suffix = "" if (weights_path or params is not None) else "_rand"
        self.net = _load(ResNet18(), resnet18_state_dict_from_flax, weights_path, params, 0,
                         self.device)

    def _embed(self, x):
        return self.net(_imagenet_normalize(_to_unit_rgb(x)))


class LPIPSDistance:
    """AlexNet-LPIPS perceptual distance on [-1,1] image pairs (the
    reference's diversity metric, metrics.py:419-443; lpips ``normalize=False``
    semantics). Convert weights with ``convert_lpips_alex``."""

    def __init__(self, weights_path: Optional[str] = None, params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        self.device = require_device(device)
        self.is_pretrained = weights_path is not None or params is not None
        self.net = _load(LPIPS(), lpips_state_dict_from_flax, weights_path, params, 0,
                         self.device)

    def _rgb(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device, torch.float32)
        return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x

    @torch.no_grad()
    def __call__(self, x1, x2) -> torch.Tensor:
        """x1, x2: (B, H, W, C) in [-1, 1] → (B,) distances."""
        return self.net(self._rgb(x1), self._rgb(x2))
