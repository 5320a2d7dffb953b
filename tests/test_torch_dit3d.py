"""The 3D latent transformer denoiser (``mrijax_torch.models.dit3d``) on the
CPU in float32 at a tiny size (hidden 48, depth 2, 4 heads of 12, patch 2,
latent 4 × 6 × 6 × 4), held to its plain reference
(``models/dit3d_reference.py``): the forward to 1e-5, one cached-latent
train step's gradients to 1e-4; the layout helpers and tables against their
formulas; the adaLN chunk order; the sampler, the two-stage driver with a
checkpoint and a resume, and the CLI's 3D sample route with the DiT; the
three spans under a CPU profiler."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch import cli, config, generate
from mrijax_torch.data import packing, synthetic
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.models import VAE3D, dit3d
from mrijax_torch.models import dit3d_reference as ref
from mrijax_torch.models.dit3d import DiT3D
from mrijax_torch.obs import MetricsLogger
from mrijax_torch.obs.profiling import spans
from mrijax_torch.train import experiments
from mrijax_torch.train.state import create_train_state
from mrijax_torch.train.steps import make_cached_latent_train_step

TINY = dict(in_channels=4, patch=2, hidden=48, depth=2, heads=4, freq_dim=32)
LATENT = (2, 4, 6, 6, 4)
HIDDEN = TINY["hidden"]


def _seeded(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Weights N(0, 1/fan_in), biases N(0, 0.05²): every gate and shift
    nonzero, so every branch shows in the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = p.shape[-1] ** -0.5 if p.dim() > 1 else 0.05
            p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


def _model(**kw) -> DiT3D:
    return _seeded(DiT3D(**{**TINY, **kw}))


def _params(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _ref(params, x, t, q_block=16):
    return ref.dit3d_forward(params, x, t, patch=TINY["patch"], heads=TINY["heads"],
                             freq_dim=TINY["freq_dim"], q_block=q_block)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_forward_matches_the_reference():
    model = _model()
    x = torch.randn(LATENT, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 871])
    with torch.no_grad():
        got = model(x, t)
    assert got.dtype == torch.float32 and got.shape == LATENT
    # query blocks of 16 and of every token give the same attention
    for q_block in (16, 512):
        assert _rel(got, _ref(_params(model), x, t, q_block)) < 1e-5


def test_train_step_gradients_match_autograd_through_the_reference():
    model = _model()
    p0 = _params(model)
    diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(10)), loss_type="mse")
    state = create_train_state(model, 1e-3, device="cpu")
    g = torch.Generator().manual_seed(2)
    latent = torch.randn(LATENT, generator=g)
    t, noise = torch.tensor([1, 8]), torch.randn(LATENT, generator=g)
    step = make_cached_latent_train_step(model, diffusion, t_min=1)
    _, loss = step(state, {"latent": latent}, None, 0.5, t=t, noise=noise)

    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    acp = torch.from_numpy(np.cumprod(1.0 - np.linspace(1e-4, 0.02, 10))).float()
    a = acp[t].reshape(-1, 1, 1, 1, 1)
    x_t = a.sqrt() * latent * 0.5 + (1 - a).sqrt() * noise
    loss_r = (_ref(params, x_t, t) - noise).square().mean()
    grads = torch.autograd.grad(loss_r, list(params.values()))
    assert float(loss) == pytest.approx(float(loss_r.detach()), rel=1e-5)
    for (name, p), want in zip(model.named_parameters(), grads):
        assert _rel(p.grad, want) < 1e-4, name
    assert state.step == 1 and any(not torch.equal(p.detach(), p0[k])
                                   for k, p in model.named_parameters())


def test_patchify_then_unpatchify_is_the_identity_and_matches_the_reference():
    x = torch.randn(2, 4, 6, 8, 3)
    tokens = dit3d.patchify(x, 2)
    assert tokens.shape == (2, 2 * 3 * 4, 8 * 3)
    assert torch.equal(tokens, ref.to_tokens(x, 2))
    # token (d, h, w) row-major, its patch flattened in (pd, ph, pw, c) order
    d, h, w, pd, ph, pw, c = 1, 2, 3, 1, 0, 1, 2
    n = (d * 3 + h) * 4 + w
    assert tokens[1, n, ((pd * 2 + ph) * 2 + pw) * 3 + c] == x[1, 2 * d + pd, 2 * h + ph,
                                                              2 * w + pw, c]
    assert torch.equal(dit3d.unpatchify(tokens, (2, 3, 4), 2), x)
    with pytest.raises(ValueError, match="patches"):
        dit3d.patchify(torch.zeros(1, 3, 4, 4, 1), 2)


def test_position_table_and_timestep_embedding_follow_their_formulas():
    grid, k = (2, 3, 4), HIDDEN // 3
    table = dit3d.position_table(grid, HIDDEN)
    assert table.shape == (24, HIDDEN)
    assert torch.equal(table, ref.sincos_3d(grid, HIDDEN))
    for d, h, w in ((0, 0, 0), (1, 2, 3), (1, 0, 2)):
        row = table[(d * 3 + h) * 4 + w]
        for part, pos in enumerate((d, h, w)):
            for i in range(k // 2):
                omega = 10000.0 ** (-i / (k // 2))
                assert float(row[part * k + i]) == pytest.approx(math.sin(pos * omega), abs=1e-6)
                assert float(row[part * k + k // 2 + i]) == pytest.approx(math.cos(pos * omega),
                                                                          abs=1e-6)
    t = torch.tensor([0, 17, 999])
    emb = dit3d.timestep_embedding(t, 256)
    assert torch.equal(emb, ref.frequency_embedding(t, 256))
    for b, tv in enumerate(t.tolist()):
        for i in (0, 5, 127):
            f = math.exp(-math.log(1e4) * i / 128)
            assert float(emb[b, i]) == pytest.approx(math.cos(tv * f), abs=1e-4)
            assert float(emb[b, 128 + i]) == pytest.approx(math.sin(tv * f), abs=1e-4)
    with pytest.raises(ValueError, match="divide by 6"):
        DiT3D(hidden=44, heads=4)


@pytest.mark.parametrize("gate, off, on", [(2, "attn", "mlp"), (5, "mlp", "attn")],
                         ids=["gate1", "gate2"])
def test_a_zeroed_gate_turns_its_branch_off(gate, off, on):
    """Chunk ``gate`` of the six (shift₁, scale₁, gate₁, shift₂, scale₂,
    gate₂) at zero in every block: the branch it gates no longer reaches the
    output, the other one does."""
    model = _model()
    rows = slice(gate * HIDDEN, (gate + 1) * HIDDEN)
    with torch.no_grad():
        for block in model.blocks:
            block.adaLN_modulation[1].weight[rows] = 0
            block.adaLN_modulation[1].bias[rows] = 0
    x, t = torch.randn(LATENT), torch.tensor([4, 9])

    def out_after_scaling(branch):
        m = _seeded(DiT3D(**TINY))
        m.load_state_dict(model.state_dict())
        with torch.no_grad():
            for block in m.blocks:
                for p in getattr(block, branch).parameters():
                    p.mul_(3.0)
            return m(x, t)

    with torch.no_grad():
        base = model(x, t)
    assert torch.equal(out_after_scaling(off), base)
    assert _rel(out_after_scaling(on), base) > 1e-2


def test_generate_3d_volumes_with_the_dit_is_the_reference_ddim_composition():
    model = _model()
    with torch.device("cpu"):
        vae = VAE3D(in_channels=2, base_channels=8, num_down=2, latent_channels=4)
    schedule = make_schedule(linear_beta_schedule(20))
    diffusion = GaussianDiffusion(schedule)
    x_t = torch.randn(LATENT, generator=torch.Generator().manual_seed(3))
    got = generate.generate_3d_volumes(model, vae, diffusion, num_volumes=2,
                                       latent_spatial=LATENT[1:4], latent_channels=4,
                                       latent_scale=0.5, x_t=x_t, ddim_steps=4, device="cpu")
    acp = torch.from_numpy(np.cumprod(1.0 - np.linspace(1e-4, 0.02, 20))).float()
    seq = np.unique(np.linspace(19, 1, 4).round().astype(int))[::-1].tolist()
    p, x = _params(model), x_t
    with torch.no_grad():
        for t, t_prev in zip(seq, seq[1:] + [0]):
            eps = _ref(p, x, torch.full((2,), t))
            x0 = (x - (1 - acp[t]).sqrt() * eps) / acp[t].sqrt()
            x = acp[t_prev].sqrt() * x0 + (1 - acp[t_prev]).sqrt() * eps
        want = vae.decode_from_latent(x / 0.5)
    assert got.shape == (2, 8, 12, 12, 2)
    assert _rel(got, want) < 1e-4


@pytest.fixture(scope="module")
def brats_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    synthetic.write_synthetic_brats(root, num_subjects=6, shape=(32, 32, 20), seed=0)
    return root


def test_two_stage_driver_trains_the_dit_resumes_and_samples_through_the_cli(
        tmp_path, brats_root):
    """Stage 2 of ``train_ddpm_3d_ldm`` on cached latents with the DiT in
    place of the UNet3D: it trains, checkpoints and writes ``dit.json``; the
    same call again resumes both stages at their end; the CLI's 3D sample
    route restores the DiT from the run directory."""
    packed = tmp_path / "packed"
    packing.pack_volumes(brats_root, packed)
    over = {
        "name": "dit", "data.batch_size": 1, "data.latent_batch_size": 2,
        "data.patch_size": (8, 16, 16), "data.val_fraction": 0.34,
        "data.packed_dir": str(packed),
        "vae.base_channels": 8, "vae.num_down": 2, "vae.latent_channels": 4,
        "vae.compute_dtype": "float32", "vae.remat": False,
        "diffusion.timesteps": 10, "train.cache_latents": True,
        "train.epochs": 1, "train.learning_rate": 1e-3, "train.debug_fast": True,
        "train.debug_max_steps": 2, "train.ema_decay": None,
        "vae_train.epochs": 1, "vae_train.learning_rate": 0.0, "vae_train.debug_fast": True,
        "vae_train.debug_max_steps": 2,
        "train.checkpoint_dir": str(tmp_path / "ckpt"),
    }
    dit_cfg = config.DiTConfig(**{**TINY, "remat": True, "compute_dtype": "float32"})
    cfg = config.preset_ddpm_3d_ldm(str(brats_root), **over)
    logger = MetricsLogger("r", root=str(tmp_path / "runs"))
    _, ldm, scale = experiments.run_experiment(cfg, device="cpu", logger=logger, dit=dit_cfg)
    model = ldm.state.model
    assert isinstance(model, DiT3D) and model.remat and ldm.epochs_run == 1
    assert ldm.state.step == 2
    run_dir = tmp_path / "ckpt" / "ddpm_3d_ldm" / "dit"
    assert config.DiTConfig.from_json(run_dir / "dit.json") == dit_cfg
    trained = _params(model)

    vae_res, ldm2, scale2 = experiments.run_experiment(
        config.preset_ddpm_3d_ldm(str(brats_root), **over), device="cpu",
        logger=MetricsLogger("r", root=str(tmp_path / "runs2")), dit=dit_cfg)
    assert (vae_res.epochs_run, ldm2.epochs_run) == (0, 0) and scale2 == scale
    for k, v in ldm2.state.model.named_parameters():
        assert torch.equal(v.detach(), trained[k]), k

    cfg.to_json(run_dir / "config.json")
    _, restored, latent_scale = cli._restore_3d(cfg, run_dir, torch.device("cpu"))
    assert isinstance(restored, DiT3D) and latent_scale == pytest.approx(scale)
    out = tmp_path / "samples"
    assert cli.main(["--device", "cpu", "sample", "--run-dir", str(run_dir), "--mode",
                     "volume3d", "--num-samples", "1", "--ddim-steps", "2", "--out-dir",
                     str(out)]) == 0
    assert (out / "volume0.nii.gz").exists()
    with pytest.raises(ValueError, match="ddpm_3d_ldm family"):
        experiments.run_experiment(config.preset_slice_cond_2d(""), device="cpu", dit=dit_cfg)


def test_spans_record_under_a_cpu_profiler_and_only_there():
    model = _model()
    x, t = torch.randn(LATENT), torch.tensor([1, 2])
    with torch.no_grad():
        model(x, t)
        assert spans("dit.") == [] or all(s.name in dit3d.SPANS for s in spans("dit."))
        with profile(activities=[ProfilerActivity.CPU]):
            model(x, t)
    depth = TINY["depth"]
    for name in dit3d.SPANS:
        got = spans(name)
        assert len(got) == depth and all(s.stream_ms == s.host_ms for s in got), name
    # the attention core lies inside the attention branch's span
    for msa, flash in zip(spans("dit.msa"), spans("dit.flash")):
        assert msa.t0_ns <= flash.t0_ns <= flash.t1_ns <= msa.t1_ns
