"""Generative-quality evaluation suite (counterpart of ``mrijax/evals``).

FID/KID over a fixed seeded random-feature extractor (pluggable pretrained
weights), SSIM/MS-SSIM in PyTorch, improved precision/recall, memorization,
Dice/HD95, and a streaming matched-condition harness reproducing the
reference's metrics.json protocol. Networks and SSIM run on the device
(default the card); the statistics are float64 numpy on the host.
"""

from mrijax_torch.evals.features import (
    ConvFeatureNet,
    FeatureExtractor,
    InceptionFeatureExtractor,
    LPIPSDistance,
    ResNet18FeatureExtractor,
)
from mrijax_torch.evals.backbones import AlexNetFeatures, InceptionV3, LPIPS, ResNet18
from mrijax_torch.evals.frechet import (
    FidAccumulator,
    frechet_distance,
    fid_from_features,
    kid_from_features,
)
from mrijax_torch.evals.ssim import ssim, ms_ssim
from mrijax_torch.evals.prd import improved_precision_recall
from mrijax_torch.evals.memorization import memorization_stats, max_cosine_similarity
from mrijax_torch.evals.segmentation import (
    dice_coefficient,
    dice_per_label,
    hd95,
    hd95_per_label,
    BRATS_LABELS,
)
from mrijax_torch.evals.harness import evaluate_conditional_2d
from mrijax_torch.evals.multi import evaluate_runs

__all__ = [
    "FeatureExtractor",
    "ConvFeatureNet",
    "InceptionFeatureExtractor",
    "ResNet18FeatureExtractor",
    "LPIPSDistance",
    "InceptionV3",
    "ResNet18",
    "AlexNetFeatures",
    "LPIPS",
    "FidAccumulator",
    "frechet_distance",
    "fid_from_features",
    "kid_from_features",
    "ssim",
    "ms_ssim",
    "improved_precision_recall",
    "memorization_stats",
    "max_cosine_similarity",
    "dice_coefficient",
    "dice_per_label",
    "hd95",
    "hd95_per_label",
    "BRATS_LABELS",
    "evaluate_conditional_2d",
    "evaluate_runs",
]
