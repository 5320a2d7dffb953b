"""The 2D / 2.5D train and eval steps — ``make_diffusion_train_step`` (with
EMA and classifier-free-guidance dropout) and ``make_diffusion_eval_step`` —
against ``mrijax`` from converted-identical parameters, with ``t``, the noise
and the dropout mask drawn exactly as the JAX step draws them from each
step's key and handed to the port (the two frameworks' random streams
differ). float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.models import UNet2D as JUNet2D
from mrijax.train import state as jstate
from mrijax.train import steps as jsteps
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.io import unet2d_state_dict_from_flax
from mrijax_torch.models import UNet2D
from mrijax_torch.train import (
    CFG_NULL_Z,
    create_train_state,
    inference_params,
    make_diffusion_eval_step,
    make_diffusion_train_step,
    sample_timesteps,
)

T = 20
LR = 2e-4
EMA = 0.9
STEPS = 8
BATCH = 4
SIZE = 16
MULTS = (1, 2)
KW = dict(base_channels=8, channel_mults=MULTS, time_emb_dim=16)
VARIANTS = {"1ch": dict(in_channels=1, out_channels=1),
            "25d": dict(in_channels=12, out_channels=4)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def convert(tree):
    return unet2d_state_dict_from_flax(tree, channel_mults=MULTS)


def rel_l2(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    num = sum(float(((got[k].detach() - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / max(den, 1e-30)) ** 0.5


def make_batch(rng, name):
    out = VARIANTS[name]["out_channels"]
    batch = {"image": rng.uniform(-1, 1, size=(BATCH, SIZE, SIZE, out)).astype(np.float32),
             "z_pos": rng.uniform(0, 1, size=BATCH).astype(np.float32)}
    if name == "25d":
        batch["context"] = rng.uniform(-1, 1, size=(BATCH, SIZE, SIZE, 8)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def models():
    """Both variants' flax params (small normals on the init's tree, which
    ``eval_shape`` gives without running an initializer), and the betas."""
    rng = np.random.default_rng(0)
    out = {"betas": linear_beta_schedule(T)}
    for name, ch in VARIANTS.items():
        jm = JUNet2D(**ch, **KW)
        ctx = jnp.zeros((1, SIZE, SIZE, 8)) if name == "25d" else None
        tree = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, ch["out_channels"])),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), ctx))
        out[name] = (jm, jax.tree_util.tree_map(
            lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree))
    return out


def jax_draws(key, shape, cond_dropout):
    """t, noise and the dropout mask as the JAX step draws them from ``key``."""
    tkey, nkey = jax.random.split(key)
    t = np.array(jsteps.sample_timesteps(tkey, shape[0], T, 0))
    noise = np.array(jax.random.normal(nkey, shape, jnp.float32))
    drop = np.zeros(shape[0], bool)
    if cond_dropout > 0:
        drop = np.array(jax.random.bernoulli(jax.random.fold_in(key, 0x0CF6), cond_dropout,
                                             (shape[0],)))
    return t, noise, drop


def port_model(models, name, **kw):
    model = UNet2D(**VARIANTS[name], **KW, **kw)
    model.load_state_dict(convert(models[name][1]), strict=True)
    return model


@pytest.mark.parametrize("name,ema,cond_dropout", [
    ("1ch", False, 0.0), ("1ch", True, 0.5), ("25d", True, 0.0), ("25d", False, 0.5)])
def test_diffusion_train_trajectory_matches_jax(models, name, ema, cond_dropout):
    """8 coupled float32 Adam steps, 1-channel and 2.5D (with context), with
    and without EMA and guidance dropout. Tolerances of
    ``tests/test_trajectory_parity.py``: losses 1e-4 absolute, final
    parameters (and EMA) 1e-4 relative L2 — float32 reduction-order noise,
    amplified by Adam's normalisation."""
    jm, params0 = models[name]
    jdiff = JGaussianDiffusion(jsched.make_schedule(models["betas"]))
    jstep = jsteps.make_diffusion_train_step(jm, jdiff, donate=False,
                                             ema_decay=EMA if ema else None,
                                             cond_dropout=cond_dropout)
    rng = np.random.default_rng(10)
    batches = [make_batch(rng, name) for _ in range(STEPS)]
    keys = [jax.random.PRNGKey(200 + i) for i in range(STEPS)]

    jst = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, params0), LR, ema=ema)
    losses_j = []
    for b, key in zip(batches, keys):
        jst, loss = jstep(jst, jax.tree_util.tree_map(jnp.asarray, b), key)
        losses_j.append(float(loss))

    model = port_model(models, name)
    state = create_train_state(model, LR, ema=ema, device="cpu")
    step = make_diffusion_train_step(model, GaussianDiffusion(make_schedule(models["betas"])),
                                     ema_decay=EMA if ema else None, cond_dropout=cond_dropout)
    losses_t, dropped = [], 0
    for b, key in zip(batches, keys):
        t, noise, drop = jax_draws(key, b["image"].shape, cond_dropout)
        dropped += int(drop.sum())
        state, loss = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                           t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
                           drop=torch.from_numpy(drop))
        assert loss.dtype == torch.float32 and loss.dim() == 0 and not loss.requires_grad
        losses_t.append(float(loss))
    if cond_dropout:
        assert 0 < dropped < STEPS * BATCH   # the null token was used, not always
    assert state.step == STEPS == int(jst.step)
    np.testing.assert_allclose(losses_t, losses_j, rtol=0, atol=1e-4)
    assert rel_l2(dict(model.named_parameters()), convert(numpy_tree(jst.params))) < 1e-4
    if ema:
        assert rel_l2(state.ema_params, convert(numpy_tree(jst.ema_params))) < 1e-4
        assert inference_params(state) is state.ema_params


def test_cond_dropout_zero_draws_what_the_step_drew_before(models):
    """With a generator, the step draws t then the noise; ``cond_dropout=0``
    draws nothing more, so it equals a step handed those two draws, and
    leaves the generator where they leave it. A positive ``cond_dropout``
    draws its mask after them: with an all-False mask given, it is the
    plain step bitwise; with an all-True mask, every z is the null token."""
    diff = GaussianDiffusion(make_schedule(models["betas"]))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(np.random.default_rng(11),
                                                           "1ch").items()}

    def one_step(cond_dropout, generator=None, **kw):
        model = port_model(models, "1ch")
        state = create_train_state(model, LR, device="cpu")
        step = make_diffusion_train_step(model, diff, cond_dropout=cond_dropout)
        return float(step(state, batch, generator, **kw)[1]), model

    g = torch.Generator().manual_seed(3)
    drawn, _ = one_step(0.0, g)
    h = torch.Generator().manual_seed(3)
    t = sample_timesteps(h, BATCH, T)
    noise = torch.randn(batch["image"].shape, generator=h)
    given, _ = one_step(0.0, t=t, noise=noise)
    assert drawn == given
    assert torch.equal(g.get_state(), h.get_state())
    kept, _ = one_step(0.7, t=t, noise=noise, drop=torch.zeros(BATCH, dtype=torch.bool))
    assert kept == given
    nulled, _ = one_step(0.7, t=t, noise=noise, drop=torch.ones(BATCH, dtype=torch.bool))
    null_batch = dict(batch, z_pos=torch.full((BATCH,), CFG_NULL_Z))
    model = port_model(models, "1ch")
    state = create_train_state(model, LR, device="cpu")
    want = make_diffusion_train_step(model, diff)(state, null_batch, t=t, noise=noise)[1]
    assert nulled == float(want)
    # drawn with the generator, the mask comes after t and the noise
    g = torch.Generator().manual_seed(3)
    one_step(0.7, g)
    h = torch.Generator().manual_seed(3)
    sample_timesteps(h, BATCH, T)
    torch.randn(batch["image"].shape, generator=h)
    torch.rand(BATCH, generator=h)
    assert torch.equal(g.get_state(), h.get_state())
    with pytest.raises(ValueError, match="generator"):
        one_step(0.7, t=t, noise=noise)


def test_diffusion_eval_step_matches_jax(models):
    """The eval step on given parameters, with the JAX eval step's own t and
    noise injected (1e-5 absolute); with a generator it is reproducible."""
    jm, params0 = models["25d"]
    jdiff = JGaussianDiffusion(jsched.make_schedule(models["betas"]))
    batch = make_batch(np.random.default_rng(12), "25d")
    key = jax.random.PRNGKey(13)
    want = jsteps.make_diffusion_eval_step(jm, jdiff)(
        jax.tree_util.tree_map(jnp.asarray, params0),
        jax.tree_util.tree_map(jnp.asarray, batch), key)
    t, noise, _ = jax_draws(key, batch["image"].shape, 0.0)
    model = port_model(models, "25d")
    eval_step = make_diffusion_eval_step(model, GaussianDiffusion(make_schedule(models["betas"])))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = {k: v.detach() for k, v in model.named_parameters()}
    got = eval_step(params, tbatch, t=torch.from_numpy(t).long(),
                    noise=torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    a = eval_step(params, tbatch, torch.Generator().manual_seed(1))
    b = eval_step(params, tbatch, torch.Generator().manual_seed(1))
    assert float(a) == float(b)
    zeroed = {k: torch.zeros_like(v) for k, v in params.items()}
    assert float(eval_step(zeroed, tbatch, t=torch.from_numpy(t).long(),
                           noise=torch.from_numpy(noise))) != float(got)
    with pytest.raises(ValueError, match="generator"):
        eval_step(params, tbatch)
