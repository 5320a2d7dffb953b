"""The port's evaluation backbones, converters and feature extractors against
``mrijax.evals`` on the same weights and inputs.

* The converters of torchvision / lpips checkpoints (``convert_inception_v3``,
  ``convert_resnet18``, ``convert_lpips_alex``), run on the torchvision-layout
  replicas of ``tests/torch_replicas.py`` with randomised weights and
  BatchNorm statistics, give trees bitwise equal to the JAX converters'; an
  npz written by either package's ``save_params_npz`` loads in the other.
* The networks, given the same tree (carried onto the port's modules by
  ``*_state_dict_from_flax``), agree with the flax ones within
  ``1e-5·max(1, max|f_jax|)``: float32 sums in another order, where
  random-weight activations reach the thousands.
* Extractors and their labels (``metric_suffix``, ``is_pretrained``) and the
  device rule: without CUDA they raise unless ``device="cpu"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_replicas import (
    InceptionV3Trunk,
    LPIPSAlexReplica,
    ResNet18Trunk,
    randomize_,
)

from mrijax.evals import backbones as jb
from mrijax.evals import features as jfeatures
from mrijax.io import save_params_npz as jax_save_params_npz
from mrijax.io import torch_convert as jconvert
from mrijax_torch.evals import backbones as pb
from mrijax_torch.evals import features
from mrijax_torch.io import (
    convert_inception_v3,
    convert_lpips_alex,
    convert_resnet18,
    inception_v3_state_dict_from_flax,
    lpips_state_dict_from_flax,
    resnet18_state_dict_from_flax,
    save_params_npz,
)

REL = 1e-5


def assert_features_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    bar = REL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar, f"max |Δ| {err:.3e} > {bar:.3e}"


def assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module")
def replicas():
    return {"inception": randomize_(InceptionV3Trunk(transform_input=True), seed=1),
            "resnet18": randomize_(ResNet18Trunk(), seed=2),
            "lpips": randomize_(LPIPSAlexReplica(), seed=3)}


@pytest.fixture(scope="module")
def trees(replicas):
    return {"inception": convert_inception_v3(replicas["inception"].state_dict()),
            "resnet18": convert_resnet18(replicas["resnet18"].state_dict()),
            "lpips": convert_lpips_alex(replicas["lpips"].state_dict())}


def nhwc(rng, *shape, low=None):
    if low is None:
        return rng.normal(size=shape).astype(np.float32)
    return rng.uniform(low, 1.0, size=shape).astype(np.float32)


# ---------------------------------------------------------------- converters


@pytest.mark.parametrize("kind, jax_convert", [
    ("inception", jconvert.convert_inception_v3),
    ("resnet18", jconvert.convert_resnet18),
    ("lpips", jconvert.convert_lpips_alex)])
def test_converters_bitwise(replicas, trees, kind, jax_convert):
    """BatchNorm folded in float64 and kernels permuted exactly as the JAX
    converters do; the flat lpips key variant as well."""
    assert_same_tree(trees[kind], jax_convert(replicas[kind].state_dict()))
    if kind == "lpips":
        sd = replicas[kind].state_dict()
        flat = {k.replace(".model.1.", "."): v for k, v in sd.items()}
        flat = {(f"features.{k.split('.')[2]}.{k.split('.')[3]}" if k.startswith("net.")
                 else k): v for k, v in flat.items()}
        assert_same_tree(convert_lpips_alex(flat), trees[kind])
    with pytest.raises(ValueError):
        {"inception": convert_inception_v3, "resnet18": convert_resnet18,
         "lpips": convert_lpips_alex}[kind]({"foo.weight": torch.zeros(1)})


# ----------------------------------------------------------------- backbones


def test_inception_v3_matches_flax(trees):
    """96², ImageNet-normalised domain; ``transform_input`` on and off."""
    rng = np.random.default_rng(10)
    x = nhwc(rng, 2, 96, 96, 3)
    for transform in (True, False):
        want = jax.jit(jb.InceptionV3(transform_input=transform).apply)(
            trees["inception"], jnp.asarray(x))
        net = pb.InceptionV3(transform_input=transform)
        net.load_state_dict(inception_v3_state_dict_from_flax(trees["inception"]), strict=True)
        with torch.no_grad():
            got = net(torch.from_numpy(x))
        assert got.shape == (2, 2048)
        assert_features_close(got.numpy(), want)


@pytest.mark.parametrize("hw", [(32, 32), (33, 35)])
def test_resnet18_matches_flax(trees, hw):
    """At 32² and at odd sizes (the stem's −∞-padded max pool, the stride-2
    downsamples)."""
    rng = np.random.default_rng(11)
    x = nhwc(rng, 2, *hw, 3)
    want = jb.ResNet18().apply(trees["resnet18"], jnp.asarray(x))
    net = pb.ResNet18()
    net.load_state_dict(resnet18_state_dict_from_flax(trees["resnet18"]), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, 512)
    assert_features_close(got.numpy(), want)


@pytest.mark.parametrize("hw", [(64, 64), (67, 65)])
def test_alexnet_taps_and_lpips_match_flax(trees, hw):
    """The five AlexNet taps (unpadded max pools at odd sizes), then the
    LPIPS distance on [-1, 1] pairs."""
    rng = np.random.default_rng(12)
    x1, x2 = nhwc(rng, 2, *hw, 3, low=-1.0), nhwc(rng, 2, *hw, 3, low=-1.0)
    net = pb.LPIPS()
    net.load_state_dict(lpips_state_dict_from_flax(trees["lpips"]), strict=True)
    want_taps = jb.AlexNetFeatures().apply({"params": trees["lpips"]["params"]["net"]},
                                           jnp.asarray(x1))
    with torch.no_grad():
        got_taps = net.net(torch.from_numpy(x1))
        got = net(torch.from_numpy(x1), torch.from_numpy(x2))
    assert len(got_taps) == len(want_taps) == 5
    for g, w in zip(got_taps, want_taps):
        assert_features_close(g.numpy(), w)
    want = jb.LPIPS().apply(trees["lpips"], jnp.asarray(x1), jnp.asarray(x2))
    assert got.shape == (2,)
    assert_features_close(got.numpy(), want)


# ---------------------------------------------------------------- extractors


def test_inception_extractor_end_to_end_and_npz_from_jax(tmp_path, trees):
    """[-1, 1] single-channel 32² → clip, 3 channels, bilinear 96², ImageNet
    normalisation, trunk: the port's extractor loading an npz that
    ``mrijax.io.save_params_npz`` wrote against the JAX extractor on the
    tree itself."""
    rng = np.random.default_rng(13)
    x = nhwc(rng, 2, 32, 32, 1, low=-1.0)
    path = tmp_path / "inception.npz"
    jax_save_params_npz(path, trees["inception"])
    fe = features.InceptionFeatureExtractor(weights_path=str(path), image_size=96,
                                            device="cpu")
    assert fe.metric_suffix == "" and fe.dim == 2048
    want = jfeatures.InceptionFeatureExtractor(params=trees["inception"], image_size=96)(x)
    assert_features_close(fe(x).numpy(), want)
    # the tree in memory gives the same module
    same = features.InceptionFeatureExtractor(params=trees["inception"], image_size=96,
                                              device="cpu").net.state_dict()
    assert all(torch.equal(v, same[k]) for k, v in fe.net.state_dict().items())


def test_resnet18_and_lpips_extractors_npz_to_jax(tmp_path, trees):
    """The other direction: npz files written by the port's
    ``save_params_npz`` load into the JAX extractors."""
    rng = np.random.default_rng(14)
    x = nhwc(rng, 3, 40, 40, 1, low=-1.0)
    y = nhwc(rng, 3, 40, 40, 1, low=-1.0)
    for kind in ("resnet18", "lpips"):
        save_params_npz(tmp_path / f"{kind}.npz", trees[kind])
    jr = jfeatures.ResNet18FeatureExtractor(weights_path=str(tmp_path / "resnet18.npz"))
    pr = features.ResNet18FeatureExtractor(params=trees["resnet18"], device="cpu")
    assert pr.metric_suffix == "" and pr.dim == 512
    assert_features_close(pr(x).numpy(), jr(x))
    assert_features_close(pr.embed_batched(x, batch_size=2), jr(x))
    jl = jfeatures.LPIPSDistance(weights_path=str(tmp_path / "lpips.npz"))
    pl = features.LPIPSDistance(params=trees["lpips"], device="cpu")
    assert pl.is_pretrained
    assert_features_close(pl(x, y).numpy(), jl(x, y))


def test_feature_extractor_matches_jax(tmp_path):
    """``ConvFeatureNet`` with small widths (GroupNorm at 8 groups and, for a
    width not divisible by 8, at 1) on seeded numpy parameters of the flax
    tree's shapes (``jax.eval_shape``: a flax init takes ~20 s here), one npz
    for both extractors; resize 16² → 40²."""
    widths = (8, 12, 16)
    rng = np.random.default_rng(15)
    tree = jax.eval_shape(lambda: jfeatures.ConvFeatureNet(widths=widths).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 40, 40, 3))))
    tree = jax.tree_util.tree_map(
        lambda leaf: (0.3 * rng.normal(size=leaf.shape)).astype(np.float32), tree)
    path = tmp_path / "convnet.npz"
    jax_save_params_npz(path, tree)
    jfe = jfeatures.FeatureExtractor(image_size=40, widths=widths, weights_path=str(path))
    fe = features.FeatureExtractor(image_size=40, widths=widths, weights_path=str(path),
                                   device="cpu")
    assert fe.dim == jfe.dim == 16 and fe.metric_suffix == jfe.metric_suffix == "_rand"
    for channels in (1, 3):
        x = nhwc(rng, 4, 16, 16, channels, low=-1.0)
        assert_features_close(fe(x).numpy(), jfe(x))


def test_random_init_extractors_labeled_and_seeded():
    """Without weights: flax's initialisers from a seeded torch generator
    (the same draws for the same seed), labeled ``_rand``."""
    a = features.FeatureExtractor(image_size=32, widths=(8, 16), device="cpu")
    b = features.FeatureExtractor(image_size=32, widths=(8, 16), device="cpu")
    c = features.FeatureExtractor(image_size=32, widths=(8, 16), seed=1, device="cpu")
    x = np.random.default_rng(16).uniform(-1, 1, size=(2, 16, 16, 1)).astype(np.float32)
    assert np.array_equal(a(x).numpy(), b(x).numpy())
    assert not np.array_equal(a(x).numpy(), c(x).numpy())
    w = a.net.Conv_0.weight
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    assert float(w.detach().abs().max()) <= 2 * std
    assert not a.net.Conv_0.bias.any()
    r = features.ResNet18FeatureExtractor(device="cpu")
    assert r.metric_suffix == "_rand"
    lp = features.LPIPSDistance(device="cpu")
    assert not lp.is_pretrained
    d = lp(np.zeros((1, 32, 32, 1)), np.ones((1, 32, 32, 1)))
    assert d.shape == (1,) and bool(torch.isfinite(d).all())


@pytest.mark.parametrize("make", [
    lambda **kw: features.FeatureExtractor(image_size=32, widths=(8,), **kw),
    lambda **kw: features.InceptionFeatureExtractor(**kw),
    lambda **kw: features.ResNet18FeatureExtractor(**kw),
    lambda **kw: features.LPIPSDistance(**kw),
], ids=["conv", "inception", "resnet18", "lpips"])
def test_extractors_default_to_the_card(make):
    """The extractors default to CUDA and raise where it is absent (the tests
    above run them with ``device="cpu"``)."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
