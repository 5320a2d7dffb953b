"""The evaluation slice as a whole: ``evaluate_conditional_2d`` of the port
against ``mrijax.evals``'s on the same model, extractors and real batches.

Each package scores its own DDIM sampler (10 steps of a ``UNet2D`` with base
8, mults (1, 2), at 32², linear T = 50, the flax parameters carried over by
``unet2d_state_dict_from_flax``). The two frameworks' random streams differ,
so each ``sample_fn`` ignores its RNG argument and starts from an ``x_t``
drawn with numpy from (seed, call index). The same ``FeatureExtractor``
(npz), ``ResNet18FeatureExtractor`` and ``LPIPSDistance`` parameters go to
both. 32² is the least size at which AlexNet-LPIPS keeps a spatial extent
after its second max pool. 48 samples in batches of 16, 8 diversity pairs,
improved precision/recall on; one case for the 1-channel family and one for
2.5D with ``eval_channel``.

Bars: the same keys in ``metrics.json``; ``num_samples`` equal; every other
number within 1e-4 relative or 1e-6 absolute (``eval_seconds`` excepted),
but precision and recall, where one point crossing a k-NN radius moves the
value by 1/48, within 1/48.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_replicas import LPIPSAlexReplica, ResNet18Trunk, randomize_

from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.evals import features as jfeatures
from mrijax.evals.harness import evaluate_conditional_2d as jax_evaluate
from mrijax.io import save_params_npz as jax_save_params_npz
from mrijax.models import UNet2D as JUNet2D
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.evals import features
from mrijax_torch.evals.harness import evaluate_conditional_2d
from mrijax_torch.io import convert_lpips_alex, convert_resnet18, unet2d_state_dict_from_flax
from mrijax_torch.models import UNet2D

T = 50
STEPS = 10
SIZE = 32
RADIUS = 1
MULTS = (1, 2)
KW = dict(base_channels=8, channel_mults=MULTS, time_emb_dim=16)
NUM_SAMPLES, BATCH, PAIRS = 48, 16, 8
RTOL, ATOL = 1e-4, 1e-6
PR_TOL = 1.0 / NUM_SAMPLES
FAMILIES = {"1ch": dict(in_channels=1, out_channels=1),
            "25d": dict(in_channels=4 + 8 * RADIUS, out_channels=4)}


def seeded_tree(module, rng, *args, scale):
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: (scale * rng.normal(size=leaf.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    """(JAX, port) pairs of the three extractors on the same parameters."""
    rng = np.random.default_rng(1)
    widths = (8, 16)
    path = tmp_path_factory.mktemp("weights") / "convnet.npz"
    jax_save_params_npz(path, seeded_tree(jfeatures.ConvFeatureNet(widths=widths), rng,
                                          jnp.zeros((1, 48, 48, 3)), scale=1.0))
    resnet = convert_resnet18(randomize_(ResNet18Trunk(), seed=2).state_dict())
    lpips = convert_lpips_alex(randomize_(LPIPSAlexReplica(), seed=3).state_dict())
    return {
        "feature_extractor": (
            jfeatures.FeatureExtractor(image_size=48, widths=widths, weights_path=str(path)),
            features.FeatureExtractor(image_size=48, widths=widths, weights_path=str(path),
                                      device="cpu")),
        "pr_feature_extractor": (jfeatures.ResNet18FeatureExtractor(params=resnet),
                                 features.ResNet18FeatureExtractor(params=resnet,
                                                                   device="cpu")),
        "lpips": (jfeatures.LPIPSDistance(params=lpips),
                  features.LPIPSDistance(params=lpips, device="cpu")),
    }


def real_batches(family, seed=3):
    """Three batches of 16 seeded slices (images in [-1, 1], z in [0, 1],
    the 2.5D context), then one more that the harness must not read."""
    rng = np.random.default_rng(seed)
    ch = FAMILIES[family]["out_channels"]
    for _ in range(NUM_SAMPLES // BATCH + 1):
        batch = {"image": rng.uniform(-1, 1, size=(BATCH, SIZE, SIZE, ch)).astype(np.float32),
                 "z_pos": rng.uniform(0, 1, size=(BATCH,)).astype(np.float32)}
        if family == "25d":
            batch["context"] = rng.uniform(-1, 1, size=(BATCH, SIZE, SIZE, 8 * RADIUS)
                                           ).astype(np.float32)
        yield batch


def start_noise(call, shape):
    return np.random.default_rng((7, call)).normal(size=shape).astype(np.float32)


def samplers(family):
    """The JAX and the port ``sample_fn`` of one family, on the same weights."""
    rng = np.random.default_rng(0)
    ch = FAMILIES[family]
    betas = linear_beta_schedule(T)
    jm = JUNet2D(**ch, **KW)
    ctx = jnp.zeros((1, SIZE, SIZE, 8 * RADIUS)) if family == "25d" else None
    params = seeded_tree(jm, rng, jnp.zeros((1, SIZE, SIZE, ch["out_channels"])),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), ctx, scale=0.1)
    model = UNet2D(**ch, **KW).eval()
    model.load_state_dict(unet2d_state_dict_from_flax(params, channel_mults=MULTS))
    jdiff = JGaussianDiffusion(jsched.make_schedule(betas))
    diff = GaussianDiffusion(make_schedule(betas))

    @jax.jit
    def jax_ddim(p, x_t, z, context):
        return jdiff.ddim_sample(lambda x, t: jm.apply(p, x, t, z, context), x_t.shape,
                                 x_t=x_t, num_steps=STEPS)

    calls = {"jax": 0, "port": 0}

    def jax_sample(batch, key):
        del key
        shape = (batch["z_pos"].shape[0], SIZE, SIZE, ch["out_channels"])
        x_t = start_noise(calls["jax"], shape)
        calls["jax"] += 1
        return jax_ddim(params, jnp.asarray(x_t), jnp.asarray(batch["z_pos"]),
                        jnp.asarray(batch["context"]) if family == "25d" else None)

    def port_sample(batch, generator):
        assert isinstance(generator, torch.Generator)
        z = batch["z_pos"]
        shape = (z.shape[0], SIZE, SIZE, ch["out_channels"])
        x_t = torch.from_numpy(start_noise(calls["port"], shape))
        calls["port"] += 1
        context = batch["context"] if family == "25d" else None
        return diff.ddim_sample(lambda x, t: model(x, t, z, context), shape, x_t=x_t,
                                num_steps=STEPS)

    return jax_sample, port_sample, calls


def assert_reports_close(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            if k != "eval_seconds":
                assert_reports_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    elif isinstance(want, str):
        assert got == want, path
    elif "improved_precision" in path or "improved_recall" in path:
        assert abs(got - want) <= PR_TOL, (path, got, want)
    else:
        assert np.isclose(got, want, rtol=RTOL, atol=ATOL), (path, got, want)


@pytest.mark.parametrize("family", ["1ch", "25d"])
def test_evaluate_conditional_2d_matches_jax(tmp_path, extractors, family):
    jax_sample, port_sample, calls = samplers(family)
    kw = dict(num_samples=NUM_SAMPLES, num_diversity_pairs=PAIRS, compute_pr=True, seed=0,
              eval_channel=3 if family == "25d" else None)
    want = jax_evaluate(jax_sample, real_batches(family), out_path=tmp_path / "jax.json",
                        **{k: v[0] for k, v in extractors.items()}, **kw)
    got = evaluate_conditional_2d(port_sample, real_batches(family),
                                  out_path=tmp_path / "port.json",
                                  progress_path=tmp_path / "progress.txt", device="cpu",
                                  **{k: v[1] for k, v in extractors.items()}, **kw)
    # three real batches, then the two diversity draws
    assert calls == {"jax": 5, "port": 5}
    assert got["num_samples"] == want["num_samples"] == NUM_SAMPLES
    saved = json.loads((tmp_path / "port.json").read_text())
    assert saved.keys() == json.loads((tmp_path / "jax.json").read_text()).keys()
    assert_reports_close(saved, want)
    for key in ("fid_rand", "kid_rand_mean", "fid_rand_per_z_bin", "diversity_ssim_mean",
                "diversity_lpips_mean", "improved_precision", "memorization"):
        assert key in got, key
    assert got["improved_pr_feature_space"] == "resnet18"
    assert f"{NUM_SAMPLES}/{NUM_SAMPLES} samples" in (tmp_path / "progress.txt").read_text()
