"""The new entry points' pieces on the card: NVML power telemetry and a 2D
program exported on the card, served against the eager sampler.

Marked ``gpu``: run with ``python -m pytest tests/test_torch_cli_cuda.py -m gpu
--noconftest`` on a machine with an NVIDIA GPU (this file imports nothing of
JAX). Without one every test here skips; ``chip_smoke.py::cli_path`` makes
the same checks at full width."""

import time

import pytest
import torch

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch import aot, generate
from mrijax_torch.config import preset_slice_cond_2d
from mrijax_torch.kernels import groupnorm as gn
from mrijax_torch.obs.energy import NvmlPowerSensor
from mrijax_torch.train.experiments import build_diffusion, build_unet2d

pytestmark = pytest.mark.gpu

TINY_2D = {"data.image_size": 16, "unet.base_channels": 8, "unet.channel_mults": (1, 2),
           "unet.time_emb_dim": 16, "unet.compute_dtype": "float32", "diffusion.timesteps": 50}


@pytest.fixture
def cuda():
    # decided when a test runs, never at import: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_nvml_sensor_reads_the_card(cuda):
    sensor = NvmlPowerSensor(torch.cuda.current_device())
    limit = sensor.power_limit_w()
    e0 = sensor.read_energy_j()
    torch.ones(1 << 24, device=cuda).mul_(2).sum().item()
    time.sleep(0.2)
    assert 0 < sensor.read_power_w() <= limit
    assert sensor.read_energy_j() >= e0 > 0


def test_exported_slice_sampler_on_the_card(cuda, tmp_path):
    """A 2D program exported on the card samples bitwise like the eager
    sampler, with the same kernel launches."""
    cfg = preset_slice_cond_2d("/unused", **TINY_2D)
    torch.manual_seed(0)
    model = build_unet2d(cfg.unet).to(cuda).eval()
    path = aot.save_exported(tmp_path / "p.pt2", aot.build_slice_sampler(
        cfg, num_samples=4, ddim_steps=5, device="cuda"))
    weights = {k: v.detach() for k, v in model.named_parameters()}
    outs, counts = [], []
    for run in ("exported", "eager"):
        gn.launches.reset()
        gen = torch.Generator(device=cuda).manual_seed(3)
        if run == "exported":
            outs.append(aot.load_exported(path)(weights, gen, torch.full((4,), 0.5, device=cuda)))
        else:
            outs.append(generate.sample_2d(model, build_diffusion(cfg.diffusion), num_samples=4,
                                           image_size=16, generator=gen, ddim_steps=5))
        counts.append(gn.launches.as_dict())
    assert torch.equal(outs[0], outs[1])
    sites = 5 * sum(m.__class__.__name__ == "GroupNormSiLU" for m in model.modules())
    assert counts[0] == counts[1] == {"gn_silu_stats": sites, "gn_silu_apply": sites,
                                      "gn_silu_bwd_reduce": 0, "gn_silu_bwd_apply": 0}
    with pytest.raises(ValueError, match="exported for device type 'cuda'"):
        aot.deserialize_exported(path, "cpu")
