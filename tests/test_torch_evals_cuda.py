"""The evaluation suite's networks and SSIM on the card against the CPU.

Marked ``gpu``: run with ``python -m pytest tests/test_torch_evals_cuda.py -m gpu``
on a machine with an NVIDIA GPU. Without one every test here skips
(``chip_smoke.py::eval_path`` makes the same comparisons). cuDNN's TF32 is
turned off for the comparisons (it moves Inception features by ~1e-3
relative): features within ``1e-4·max|f|``, SSIM within 1e-5.
"""

import numpy as np
import pytest
import torch

from torch_replicas import InceptionV3Trunk, LPIPSAlexReplica, ResNet18Trunk, randomize_

from mrijax_torch.evals import features, ms_ssim, ssim
from mrijax_torch.io import convert_inception_v3, convert_lpips_alex, convert_resnet18

pytestmark = pytest.mark.gpu

FEATURE_REL = 1e-4
SSIM_ATOL = 1e-5


@pytest.fixture
def cuda():
    # decided when a test runs, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def images(seed, n=4, size=128, channels=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, size, size, channels)).astype(np.float32)


def assert_close_to_cpu(make, *inputs):
    got = make("cuda")(*inputs).cpu().numpy()
    want = make("cpu")(*inputs).numpy()
    bar = FEATURE_REL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bar


@pytest.mark.parametrize("kind", ["inception", "resnet18", "conv"])
def test_feature_extractors_card_vs_cpu(cuda, kind):
    x = images(0)
    if kind == "inception":
        tree = convert_inception_v3(randomize_(InceptionV3Trunk(), seed=1).state_dict())
        assert_close_to_cpu(lambda d: features.InceptionFeatureExtractor(params=tree, device=d), x)
    elif kind == "resnet18":
        tree = convert_resnet18(randomize_(ResNet18Trunk(), seed=2).state_dict())
        assert_close_to_cpu(lambda d: features.ResNet18FeatureExtractor(params=tree, device=d), x)
    else:
        assert_close_to_cpu(lambda d: features.FeatureExtractor(device=d), x)


def test_lpips_card_vs_cpu(cuda):
    tree = convert_lpips_alex(randomize_(LPIPSAlexReplica(), seed=3).state_dict())
    assert_close_to_cpu(lambda d: features.LPIPSDistance(params=tree, device=d),
                        images(1), images(2))


@pytest.mark.parametrize("fn,size,kw", [(ssim, 128, {}), (ms_ssim, 128, {"levels": 4}),
                                        (ms_ssim, 176, {"levels": 5})])
def test_ssim_card_vs_cpu(cuda, fn, size, kw):
    a = np.clip(images(3, size=size) * 0.5 + 0.5, 0, 1)
    b = np.clip(a + 0.1 * images(4, size=size), 0, 1)
    got = fn(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(), data_range=1.0, **kw)
    want = fn(a, b, data_range=1.0, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=SSIM_ATOL)
