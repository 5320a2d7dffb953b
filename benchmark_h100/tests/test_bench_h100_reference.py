"""The plain reference against the port's own plain versions on the CPU, in
float32 at tiny widths, and the frozen count against
``mrijax_torch.bench.forward_flops``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mrijax_torch.bench import forward_flops
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.models import UNet2D, UNet3D, VAE3D
from mrijax_torch.train.state import create_train_state
from mrijax_torch.train.steps import make_cached_latent_train_step

from benchmark_h100 import judge, seeding
from benchmark_h100.count import ops
from benchmark_h100.kind_base import UNET3D_KEYS, _kw
from benchmark_h100.reference import diffusion as ref
from benchmark_h100.reference import nets

U3 = dict(in_channels=4, base_channels=8, channel_mults=(1, 2), time_emb_dim=16, groups=8,
          num_heads=2, use_attention=True)
U2 = dict(in_channels=1, out_channels=1, base_channels=8, channel_mults=(1, 2, 4),
          time_emb_dim=16, groups=8)
V3 = dict(in_channels=2, base_channels=8, num_down=3, latent_channels=4)
CPU = torch.device("cpu")


def _seeded(model, seed):
    spec = seeding.param_spec(model)
    weights = seeding.make_weights(spec, seed, seeding.WEIGHTS_UNET, CPU)
    seeding.load_weights(model, weights)
    return model.eval(), weights


def _close(a, b, tol=2e-5):
    assert judge.rel_rows(a, b) < tol


@pytest.mark.parametrize("attention_levels", [(), (1,)])
def test_unet3d_forward(attention_levels):
    cfg = dict(U3, attention_levels=attention_levels)
    model, p = _seeded(UNet3D(**cfg, use_flash_attention=False), 1)
    x = torch.randn(2, 4, 8, 8, 4, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([3, 17])
    with torch.no_grad():
        _close(model(x, t), nets.unet3d(p, cfg, x, t))


def test_vae3d_decode():
    model, p = _seeded(VAE3D(**V3), 3)
    z = torch.randn(2, 2, 3, 3, 4, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        _close(model.decode_from_latent(z), nets.vae3d_decode(p, z))


def test_unet2d_forward():
    model, p = _seeded(UNet2D(**U2), 5)
    x = torch.randn(3, 16, 16, 1, generator=torch.Generator().manual_seed(6))
    t, z = torch.tensor([0, 500, 999]), torch.tensor([0.0, 0.4, 1.0])
    with torch.no_grad():
        _close(model(x, t, z), nets.unet2d(p, U2, x, t, z))


@pytest.mark.parametrize("schedule, timesteps, steps", [("cosine", 400, 400), ("linear", 1000, 50)])
def test_ddim_step_and_grid(schedule, timesteps, steps):
    from mrijax_torch.diffusion import linear_beta_schedule

    make = cosine_beta_schedule if schedule == "cosine" else linear_beta_schedule
    betas = make(timesteps)
    d = GaussianDiffusion(make_schedule(betas))
    seq = d.ddim_timestep_sequence(steps)
    np.testing.assert_array_equal(seq, ref.ddim_timesteps(timesteps, steps))
    acp = ref.alphas_cumprod(schedule, timesteps, CPU)
    torch.testing.assert_close(acp, d.schedule.alphas_cumprod, rtol=0, atol=0)
    x = torch.randn(2, 5, 5, 3)
    eps = torch.randn_like(x)
    for i in (0, len(seq) - 1):
        t_prev = int(seq[i + 1]) if i + 1 < len(seq) else 0
        got = d.ddim_step(lambda *_: eps, x, torch.full((2,), int(seq[i])),
                          torch.full((2,), t_prev))
        _close(got, ref.ddim_update(acp, x, eps, int(seq[i]), t_prev), 1e-6)


def test_cached_latent_train_step():
    """Loss and first gradient (Adam's first moment over 1 − β₁) of the
    port's step against the reference's, leaf by leaf."""
    # 16 channels: two a group, so no bias before a GroupNorm has a gradient of nought
    cfg = dict(U3, base_channels=16, attention_levels=())
    model, p0 = _seeded(UNet3D(**cfg, use_flash_attention=False, remat_levels=(0,)), 7)
    state = create_train_state(model, 1e-3, device=CPU)
    d = GaussianDiffusion(make_schedule(cosine_beta_schedule(400)), loss_type="min_snr")
    step = make_cached_latent_train_step(model, d, t_min=1)
    g = torch.Generator().manual_seed(8)
    x0 = torch.randn(4, 4, 8, 8, 4, generator=g)
    t = torch.tensor([1, 50, 200, 399])
    noise = torch.randn(x0.shape, generator=g)
    _, loss = step(state, {"latent": x0}, None, 1.0, t=t, noise=noise)

    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    acp = ref.alphas_cumprod("cosine", 400, CPU)
    eps = nets.unet3d(params, cfg, ref.q_sample(acp, x0, t, noise), t)
    loss_r = ref.loss_terms("min_snr", acp, eps, noise, t, 5.0).sum() / 4
    grads = dict(zip(params, torch.autograd.grad(loss_r, list(params.values()))))
    assert abs(float(loss) - float(loss_r.detach())) < 1e-5 * abs(float(loss_r.detach()))
    for k, p in model.named_parameters():
        got = state.optimizer.state[p]["exp_avg"] / 0.1
        assert float((got - grads[k]).norm()) <= 1e-4 * float(grads[k].norm()) + 1e-12, k


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(9)
    p = {"a": torch.randn(50, generator=g), "b": torch.randn(3, 4, generator=g)}
    mine = {k: v.clone() for k, v in p.items()}
    theirs = [torch.nn.Parameter(v.clone()) for v in p.values()]
    adam, torch_adam = ref.Adam(mine, 2e-4), torch.optim.Adam(theirs, lr=2e-4)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        for q, gr in zip(theirs, grads.values()):
            q.grad = gr.clone()
        torch_adam.step()
        adam.step(grads)
    for q, k in zip(theirs, mine):
        torch.testing.assert_close(mine[k], q.detach(), rtol=1e-6, atol=1e-7)


def _reference_count(spec, run):
    with ops.counting() as tally:
        run(seeding.make_weights(spec, 0, 0, "meta"))
    return tally.total_flops


def test_count_matches_bench_forward_flops_3d():
    model = UNet3D(**U3)
    x, t = torch.zeros(2, 4, 8, 8, 4), torch.ones(2, dtype=torch.long)
    want = forward_flops(model, lambda: model(x, t))
    got = _reference_count(seeding.param_spec(model), lambda p: nets.unet3d(
        p, U3, torch.empty(x.shape, device="meta"), torch.zeros(2, dtype=torch.long, device="meta")))
    assert got == want
    vae = VAE3D(**V3)
    z = torch.zeros(1, 2, 3, 3, 4)
    want = forward_flops(vae, lambda: vae.decode_from_latent(z))
    got = _reference_count(seeding.param_spec(vae), lambda p: nets.vae3d_decode(
        p, torch.empty(z.shape, device="meta")))
    assert got == want


def test_count_matches_bench_forward_flops_2d():
    model = UNet2D(**U2)
    x, t, z = torch.zeros(2, 16, 16, 1), torch.ones(2, dtype=torch.long), torch.zeros(2)
    want = forward_flops(model, lambda: model(x, t, z))
    got = _reference_count(seeding.param_spec(model), lambda p: nets.unet2d(
        p, U2, torch.empty(x.shape, device="meta"),
        torch.zeros(2, dtype=torch.long, device="meta"), torch.zeros(2, device="meta")))
    assert got == want


def test_count_of_the_flagship_forward():
    """PR 18's count of the flagship UNet3D forward: 0.7779 TFLOP a latent."""
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "ldm3d_flagship.json")
                     .read_text())
    with torch.device("meta"):
        model = UNet3D(**_kw(cfg["unet"], UNET3D_KEYS))
    spec = seeding.param_spec(model)
    shape = (1, *cfg["latent"], cfg["unet"]["in_channels"])
    flops = _reference_count(spec, lambda p: nets.unet3d(
        p, cfg["unet"], torch.empty(shape, device="meta"),
        torch.zeros(1, dtype=torch.long, device="meta")))
    assert abs(flops / 1e12 - 0.7779) < 5e-4
    assert sum(int(np.prod(s)) for _, s, _ in spec) == cfg["assumed"]["parameters"]["unet"]
