"""The port's bench (``mrijax_torch/bench.py``) on the CPU.

Every mode of ``bench.py::main`` runs through ``bench.main([flag, "--tiny",
"--device", "cpu"])`` in this process and prints lines with its ``metric``
name and ``bench.py``'s keys for it (less the ones with no counterpart, which
the module's docstring lists), plus the port's own; the headline's sampling
is held against the JAX composition of ``bench.py:330-342``; the operation
count against XLA's cost analysis, lowered on the CPU with Pallas off as
``bench.py::_flops_of`` lowers it. On the card ``chip_smoke.py`` phase 18
runs every mode with ``--tiny`` and the headline with ``--smoke``.
"""

import ast
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.kernels.dispatch import disable_pallas
from mrijax.models import UNet3D as JUNet3D
from mrijax.models import VAE3D as JVAE3D
from mrijax.models import blocks as jblocks
from mrijax_torch import bench
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.io import unet3d_state_dict_from_flax, vae3d_state_dict_from_flax
from mrijax_torch.models import UNet3D, VAE3D
from mrijax_torch.models.blocks import Conv3d, Downsample, Linear, Upsample

REPO = Path(__file__).resolve().parent.parent
# what every line carries besides bench.py's keys
COMMON = {"device", "torch", "cuda", "source", "scale", "build_secs", "batch", "run_secs",
          "flops", "mfu", "peak_gb", "setup_secs"}
# bench.py's keys of each metric, less vs_baseline and setup_{client,worker}_secs
KEYS = {
    "3d_ldm_volume_sampling_throughput": {"metric", "value", "unit", "secs_per_volume",
                                          "setup_secs", "pipeline_tflops", "mfu"},
    "3d_ldm_train_step_time": {"metric", "value", "unit", "steps_per_s", "step_tflops", "mfu"},
    "3d_ldm_cached_train_throughput": {"metric", "value", "unit", "sec_per_step",
                                       "step_tflops", "mfu"},
    "vae3d_train_throughput": {"metric", "value", "unit", "sec_per_step", "step_tflops", "mfu"},
    "slice_cond_2d_train_step_time": {"metric", "value", "unit", "images_per_s",
                                      "step_tflops", "mfu"},
    "ddpm_25d_train_step_time": {"metric", "value", "unit", "images_per_s", "step_tflops",
                                 "mfu"},
    "slice_cond_2d_train_profile": {"metric", "measurement", "value", "unit", "images_per_s",
                                    "step_tflops", "mfu"},
    "slice_cond_2d_sampling_throughput": {"metric", "value", "unit", "secs_per_batch",
                                          "pipeline_tflops", "mfu"},
    "slice_cond_2d_sampling_ladder": {"metric", "batch", "sampler", "value", "unit",
                                      "secs_per_batch", "mfu", "timed_runs"},
    "input_pipeline_2d": {"metric", "variant", "value", "unit"},
    "eval_2d_throughput": {"metric", "sampler", "value", "unit", "num_samples",
                           "eval_seconds", "fid_rand", "kid_rand_mean"},
    "3d_ldm_sampling_sweep": {"metric", "batch", "decode_chunk", "ddim_steps", "sampler",
                              "value", "unit", "secs_per_volume"},
}
# mode → (metric, lines)
MODES = [
    ([], "3d_ldm_volume_sampling_throughput", 1),
    (["--train"], "3d_ldm_train_step_time", 1),
    (["--train-cached"], "3d_ldm_cached_train_throughput", 1),
    (["--train-cached-sweep"], "3d_ldm_cached_train_throughput", 5),
    (["--train-vae"], "vae3d_train_throughput", 1),
    (["--train-vae-sweep"], "vae3d_train_throughput", 6),
    (["--train-2d"], "slice_cond_2d_train_step_time", 1),
    (["--train-25d"], "ddpm_25d_train_step_time", 1),
    (["--train-2d-profile"], "slice_cond_2d_train_profile", 5),
    (["--sample-2d"], "slice_cond_2d_sampling_throughput", 1),
    (["--sample-2d", "--steps", "3", "--sampler", "dpm"], "slice_cond_2d_sampling_throughput", 1),
    (["--sample-2d-sweep"], "slice_cond_2d_sampling_ladder", 9),
    (["--input-pipeline"], "input_pipeline_2d", 5),
    (["--eval-2d"], "eval_2d_throughput", 2),
    (["--sweep"], "3d_ldm_sampling_sweep", 6),
]
SECONDS = ("value", "setup_secs", "secs_per_volume", "secs_per_ddim_step", "decode_secs",
           "steps_per_s", "sec_per_step", "images_per_s", "secs_per_batch", "secs_per_step",
           "eval_seconds")


@pytest.mark.parametrize("argv, metric, n_lines", MODES,
                         ids=[" ".join(argv) or "headline" for argv, _, _ in MODES])
def test_every_mode_prints_its_lines_on_the_cpu(argv, metric, n_lines, capsys):
    assert bench.main([*argv, "--tiny", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == n_lines
    for line in lines:
        assert line["metric"] == metric
        host_only = line.get("variant", "").endswith("_host_only")
        want = KEYS[metric] | COMMON | (set() if host_only or metric != "input_pipeline_2d"
                                        else {"secs_per_step"})
        assert want <= set(line), want - set(line)
        assert line["device"] == "cpu" and line["mfu"] is None and line["peak_gb"] is None
        assert line["scale"] == "tiny" and line["build_secs"] is None
        assert line["torch"] == torch.__version__ and len(line["source"]) == 16
        for key in SECONDS:
            if key in line:
                assert math.isfinite(line[key]) and line[key] > 0, (key, line[key])
        assert line["run_secs"] and all(math.isfinite(s) and s > 0 for s in line["run_secs"])
        if not host_only:
            assert line["flops"] > 0
    if metric == "3d_ldm_volume_sampling_throughput":
        (line,) = lines
        assert line["decode_chunk"] == bench.TINY.decode_chunk
        assert line["ddim_steps"] == bench.TINY.step_cap
        assert line["pipeline_tflops"] == pytest.approx(line["flops"] / 1e12)
    if metric == "slice_cond_2d_train_profile":
        assert [x["measurement"] for x in lines] == [
            "per_step_readback", "chained", "fwd_only", "fwd_bwd", "chained_b128"]
    if metric == "input_pipeline_2d":
        assert [x["variant"] for x in lines] == [
            "device_resident", "packed_loader_host_only", "packed_loader",
            "live_loader_host_only", "live_loader"]


def test_every_mode_flag_of_bench_py_has_a_counterpart():
    """The flags ``bench.py::main`` tests for, against the port's."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {n.value for n in ast.walk(main)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and re.fullmatch(r"--[a-z0-9-]+", n.value)}
    assert flags == set(bench.MODES) | {"--steps", "--sampler"}


def test_without_device_cpu_the_bench_raises(monkeypatch):
    """``--device`` defaults to cuda; where there is no card nothing runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main(["--tiny", "--train-2d"])


# ------------------------------------------------------ the headline's sampling

UNET_KW = dict(in_channels=4, base_channels=8, channel_mults=(1, 2), time_emb_dim=16,
               num_heads=2)
VAE_KW = dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4)
LATENT = (4, 4, 8, 8, 4)
CHUNK = 2
STEPS = 5
# float32 sums in another order over 5 DDIM steps and the decode: measured
# 1.05e-5 here, the volumes reaching 25
SAMPLE_ATOL = 1e-4


def _random_params(module, rng, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return jax.tree_util.tree_map(
        lambda leaf: jnp.asarray((0.02 * rng.normal(size=leaf.shape)).astype(np.float32)), tree)


def test_headline_sampling_matches_the_jax_composition():
    """``bench.sample_volumes`` (DDIM, then the decode ``CHUNK`` volumes at a
    time) against ``bench.py:330-342``'s ``ddim_sample`` and ``lax.map`` of
    ``decode_from_latent`` over the chunks, on converted weights from the
    same start latent."""
    rng = np.random.default_rng(0)
    junet, jvae = JUNet3D(**UNET_KW), JVAE3D(**VAE_KW)
    up = _random_params(junet, rng, jnp.zeros(LATENT), jnp.zeros((LATENT[0],), jnp.int32))
    vp = _random_params(jvae, rng, jnp.zeros((1, 8, 16, 16, 2)), jax.random.PRNGKey(1))
    betas = cosine_beta_schedule(bench.T_STEPS)
    x_t = rng.normal(size=LATENT).astype(np.float32)

    jdiff = JGaussianDiffusion(jsched.make_schedule(betas))
    z = jdiff.ddim_sample(lambda x, t: junet.apply(up, x, t), LATENT, x_t=jnp.asarray(x_t),
                          num_steps=STEPS)
    zc = z.reshape(LATENT[0] // CHUNK, CHUNK, *z.shape[1:])
    want = jax.lax.map(lambda zz: jvae.apply(vp, zz, method="decode_from_latent"), zc)
    want = np.asarray(want.reshape(LATENT[0], *want.shape[2:]))

    unet, vae = UNet3D(**UNET_KW).eval(), VAE3D(**VAE_KW).eval()
    unet.load_state_dict(unet3d_state_dict_from_flax(up, UNET_KW["channel_mults"]))
    vae.load_state_dict(vae3d_state_dict_from_flax(vp, VAE_KW["num_down"]))
    got = bench.sample_volumes(unet, vae, GaussianDiffusion(make_schedule(betas)), LATENT,
                               x_t=torch.from_numpy(x_t), num_steps=STEPS, decode_chunk=CHUNK)
    assert got.shape == want.shape == (4, 8, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLE_ATOL)
    with pytest.raises(ValueError, match="not divisible"):
        bench.decode_in_chunks(vae, torch.zeros(3, 4, 8, 8, 4), 2)


# ----------------------------------------------------------------- operations


def _xla_flops(module, *args) -> float:
    """``bench.py::_flops_of``: the flops of XLA's cost analysis of the
    module's forward, lowered on the CPU with Pallas off."""
    with disable_pallas():
        params = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        ca = jax.jit(lambda p, *a: module.apply(p, *a), backend="cpu").lower(
            params, *args).cost_analysis()
    return float(ca["flops"])


def _xla_offset() -> float:
    """XLA's CPU cost analysis reads one operation less than a program
    holds (an add of 32 elements reads 31); what it misses of a program."""
    x = jnp.zeros((32,))
    ca = jax.jit(lambda a: a + 1.0, backend="cpu").lower(x).cost_analysis()
    return 32.0 - float(ca["flops"])


X3D = (2, 8, 8, 8, 16)


@pytest.mark.parametrize("layer", ["conv3d_padded", "downsample", "conv_transpose3d", "linear"])
def test_layer_flops_equal_xla_cost_analysis(layer):
    """One layer of each kind, exactly: valid taps, bias adds included."""
    x = jnp.zeros(X3D)
    jmod, tmod = {
        "conv3d_padded": (fnn.Conv(16, (3, 3, 3), padding=1), Conv3d(16, 16, 3, padding=1)),
        "downsample": (jblocks.Downsample(32, 3), Downsample(16, 32)),
        "conv_transpose3d": (jblocks.Upsample(8, 3), Upsample(16, 8)),
        "linear": (fnn.Dense(24), Linear(16, 24)),
    }[layer]
    if layer == "linear":
        x = jnp.zeros((2, 10, 16))
    got = bench.forward_flops(tmod, lambda: tmod(torch.zeros(x.shape)))
    assert got == _xla_flops(jmod, x) + _xla_offset()


# tiny UNet3D forward: XLA also counts the elementwise work (GroupNorm, SiLU,
# adds, the softmax, the time embedding), which the port leaves out; measured
# here the port's count is 0.9650 of XLA's at (1, 8, 8, 8, 4) and at batch 2
UNET_FLOPS_RATIO = (0.95, 1.0)


def test_unet3d_flops_within_tolerance_of_xla():
    latent = (1, 8, 8, 8, 4)
    junet = JUNet3D(**UNET_KW)
    xla = _xla_flops(junet, jnp.zeros(latent), jnp.zeros((1,), jnp.int32)) + _xla_offset()
    unet = UNet3D(**UNET_KW).eval()
    got = bench.forward_flops(
        unet, lambda: unet(torch.zeros(latent), torch.ones(1, dtype=torch.long)))
    assert UNET_FLOPS_RATIO[0] <= got / xla <= UNET_FLOPS_RATIO[1], got / xla


def test_recomputed_flops_are_the_rematerialised_blocks():
    """Nothing without remat; every res block's forward with ``remat``; the
    level-0 blocks alone (down and up path) with ``remat_levels=(0,)``."""
    latent, t = torch.zeros(1, 8, 8, 8, 4), torch.ones(1, dtype=torch.long)

    def counts(**kw):
        unet = UNet3D(**UNET_KW, **kw)
        call = lambda: unet(latent, t)  # noqa: E731
        return unet, bench.recomputed_flops(unet, call), bench._flops_by_layer(unet, call)

    unet, none, _ = counts()
    assert none == 0 and all(p.grad is None for p in unet.parameters())
    unet, every, by_layer = counts(remat=True)
    res = [m for m in unet.modules() if type(m).__name__ == "ResBlock3D"]
    assert every == sum(by_layer[layer] for m in res for layer in m.modules() if layer in by_layer)
    unet, level0, by_layer = counts(remat_levels=(0,))
    level0_blocks = [unet.downs[0]["res1"], unet.downs[0]["res2"], unet.ups[-1]["res1"],
                     unet.ups[-1]["res2"]]
    assert level0 == sum(by_layer[layer] for m in level0_blocks for layer in m.modules()
                         if layer in by_layer)
    assert 0 < level0 < every
