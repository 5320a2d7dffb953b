"""The port's training slice — ``p_losses``, train state, the cached-latent,
latent-diffusion and VAE steps — against ``mrijax`` from converted-identical
parameters, with latents, timesteps and noise injected explicitly (the two
frameworks' random streams differ). float32 on the CPU; the JAX model's flash
attention takes its chunked XLA route there, the port's its plain versions."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.models import UNet3D as JUNet3D
from mrijax.models import VAE3D as JVAE3D
from mrijax.train import state as jstate
from mrijax.train import steps as jsteps
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.io import (
    train_state_from_flax,
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)
from mrijax_torch.models import UNet3D, VAE3D
from mrijax_torch.train import (
    EarlyStopper,
    PlateauScheduler,
    apply_if_finite,
    create_train_state,
    ema_update,
    estimate_latent_scale,
    estimate_latent_scale_from_latents,
    fixed_validation_timesteps,
    get_learning_rate,
    inference_params,
    make_cached_latent_eval_step,
    make_cached_latent_train_step,
    make_latent_diffusion_eval_step,
    make_latent_diffusion_train_step,
    make_vae_eval_step,
    make_vae_train_step,
    sample_timesteps,
    set_learning_rate,
    vae_loss,
)

T = 16
LR = 1e-4
EMA = 0.9
SCALE = 0.8
UNET_KW = dict(in_channels=4, base_channels=16, channel_mults=(1, 2),
               time_emb_dim=32, num_heads=2)
VAE_KW = dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4)
LATENT = (2, 8, 8, 8, 4)
convert_unet = functools.partial(unet3d_state_dict_from_flax,
                                 channel_mults=UNET_KW["channel_mults"])


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def rel_l2(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    num = sum(float(((got[k].detach() - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / max(den, 1e-30)) ** 0.5


# --------------------------------------------------------------- diffusion


@pytest.mark.parametrize("loss_type", ["mse", "min_snr"])
def test_p_losses_matches_jax(loss_type):
    """Same x, t, noise and the same stand-in model on both sides; 1e-6."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(4, 3, 4, 5, 2)).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    t = np.asarray([1, 7, 12, 15], np.int32)   # SNR on both sides of gamma = 5
    betas = cosine_beta_schedule(T)
    jd = JGaussianDiffusion(jsched.make_schedule(betas), loss_type=loss_type)
    td = GaussianDiffusion(make_schedule(betas), loss_type=loss_type)
    want = jd.p_losses(lambda xx, tt: 0.3 * xx + 0.01 * tt.reshape(-1, 1, 1, 1, 1),
                       jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
    got = td.p_losses(lambda xx, tt: 0.3 * xx + 0.01 * tt.reshape(-1, 1, 1, 1, 1),
                      torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_p_losses_rejects_an_unknown_loss_and_to_keeps_the_fields():
    td = GaussianDiffusion(make_schedule(cosine_beta_schedule(T)), loss_type="huber",
                           min_snr_gamma=3.0)
    z = torch.zeros(1, 2, 2, 2, 1)
    with pytest.raises(ValueError, match="unknown loss_type"):
        td.p_losses(lambda x, t: x, z, torch.tensor([1]), z)
    assert td.to("cpu") is td
    moved = GaussianDiffusion(td.schedule, "min_snr", 3.0).to("meta")
    assert moved.loss_type == "min_snr" and moved.min_snr_gamma == 3.0
    assert moved.schedule.betas.device.type == "meta"


# -------------------------------------------------- cached-latent trajectory


@pytest.fixture(scope="module")
def coupled():
    """A small UNet3D with bottleneck attention in both frameworks from one
    flax init (jitted: one compile, the same bits as the eager init), the JAX
    cached-latent step with EMA (jitted once), and 25 batches whose t and
    noise are drawn exactly as the JAX step draws them from each step's key,
    so that the port can be handed the same. The 25 draws are one jitted
    call; the first step's key and draws are held to the eager ones, bit for
    bit."""
    jm = JUNet3D(**UNET_KW)
    params0 = numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros(LATENT),
                                          jnp.zeros((2,), jnp.int32)))
    betas = cosine_beta_schedule(T)
    jdiff = JGaussianDiffusion(jsched.make_schedule(betas), loss_type="min_snr")
    jstep = jsteps.make_cached_latent_train_step(jm, jdiff, donate=False, ema_decay=EMA)

    def draw(key):
        tkey, nkey = jax.random.split(key)
        return (jsteps.sample_timesteps(tkey, LATENT[0], T, 1),
                jax.random.normal(nkey, LATENT, jnp.float32))

    keys = np.array(jax.jit(jax.vmap(jax.random.PRNGKey))(jnp.arange(100, 125)))
    ts, noises = map(np.array, jax.jit(jax.vmap(draw))(keys))
    key0 = jax.random.PRNGKey(100)
    np.testing.assert_array_equal(keys[0], np.asarray(key0))
    for got, want in zip((ts[0], noises[0]), draw(key0)):
        np.testing.assert_array_equal(got, np.asarray(want))
    rng = np.random.default_rng(21)
    batches = [{"key": keys[i], "latent": rng.normal(size=LATENT).astype(np.float32),
                "t": ts[i], "noise": noises[i]} for i in range(25)]
    return dict(jm=jm, params0=params0, jstep=jstep, batches=batches,
                diffusion=GaussianDiffusion(make_schedule(betas), loss_type="min_snr"))


def run_jax(coupled, state, batches):
    losses = []
    for b in batches:
        state, loss = coupled["jstep"](state, {"latent": jnp.asarray(b["latent"])},
                                       b["key"], SCALE)
        losses.append(float(loss))
    return state, np.asarray(losses)


@pytest.fixture(scope="module")
def jax_run(coupled):
    """The JAX side of the 25 coupled steps, run once for the module: the
    states after steps 4, 8 and 25 and each step's loss."""
    state = jstate.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, coupled["params0"]), LR, ema=True)
    states, losses = {}, []
    for first, last in ((0, 4), (4, 8), (8, 25)):
        state, part = run_jax(coupled, state, coupled["batches"][first:last])
        states[last] = state
        losses.append(part)
    return dict(states=states, losses=np.concatenate(losses))


def run_port(unet, state, diffusion, batches, **step_kw):
    step = make_cached_latent_train_step(unet, diffusion, **step_kw)
    losses = []
    for b in batches:
        state, loss = step(state, {"latent": torch.from_numpy(b["latent"])}, None, SCALE,
                           t=torch.from_numpy(b["t"]).long(),
                           noise=torch.from_numpy(b["noise"]))
        assert loss.dtype == torch.float32 and loss.dim() == 0 and not loss.requires_grad
        losses.append(float(loss))
    return state, np.asarray(losses)


def port_unet(coupled, **kw):
    unet = UNet3D(**UNET_KW, **kw)
    unet.load_state_dict(convert_unet(coupled["params0"]), strict=True)
    return unet


def test_cached_latent_trajectory_matches_jax(coupled, jax_run):
    """25 coupled float32 Adam steps through ``make_cached_latent_train_step``
    in both packages, with the EMA shadow. Tolerances of
    ``tests/test_trajectory_parity.py``: losses 1e-4 absolute, final
    parameters 1e-4 relative L2 (float32 reduction-order noise, amplified by
    Adam's normalisation across steps; measured 1.3e-6 and 1.0e-6). With
    ``remat_levels=(0,)`` the port's trajectory must equal its own without
    remat to 1e-6: recomputing a block repeats the same float32 operations."""
    jfinal, losses_j = jax_run["states"][25], jax_run["losses"]

    unet = port_unet(coupled)
    state = create_train_state(unet, LR, ema=True, device="cpu")
    state, losses_t = run_port(unet, state, coupled["diffusion"], coupled["batches"],
                               ema_decay=EMA)
    assert state.step == 25 == int(jfinal.step)
    np.testing.assert_allclose(losses_t, losses_j, rtol=0, atol=1e-4)
    assert losses_t[-5:].mean() < losses_t[:5].mean()   # a real trajectory: the loss fell
    want = convert_unet(numpy_tree(jfinal.params))
    rel = rel_l2(dict(unet.named_parameters()), want)
    assert rel < 1e-4, f"final-parameter drift after 25 steps: {rel:.2e}"
    rel_ema = rel_l2(state.ema_params, convert_unet(numpy_tree(jfinal.ema_params)))
    assert rel_ema < 1e-4, f"EMA drift after 25 steps: {rel_ema:.2e}"
    # the shadow is a distinct copy that lags the parameters
    assert rel_l2(state.ema_params, {k: v.detach() for k, v in unet.named_parameters()}) > 0

    remat = port_unet(coupled, remat_levels=(0,))
    assert remat.state_dict().keys() == unet.state_dict().keys()
    rstate = create_train_state(remat, LR, device="cpu")
    rstate, losses_r = run_port(remat, rstate, coupled["diffusion"], coupled["batches"])
    np.testing.assert_allclose(losses_r, losses_t, rtol=0, atol=1e-6)
    assert rel_l2(dict(remat.named_parameters()),
                  {k: v.detach() for k, v in unet.named_parameters()}) < 1e-6


def test_train_state_from_flax_continues_a_run(coupled, jax_run):
    """Both packages go on from the same mid-run state: 4 JAX steps, the flax
    state's numpy pieces carried over by ``train_state_from_flax``, then 4
    more steps on each side. Same tolerances as the full trajectory."""
    rest = coupled["batches"][4:8]
    jmid = jax_run["states"][4]
    adam = jmid.opt_state.inner_state[0]
    unet = UNet3D(**UNET_KW)
    state = train_state_from_flax(
        unet, convert_unet, params=numpy_tree(jmid.params), mu=numpy_tree(adam.mu),
        nu=numpy_tree(adam.nu), count=int(adam.count),
        learning_rate=jstate.get_learning_rate(jmid),
        ema_params=numpy_tree(jmid.ema_params), device="cpu")
    assert state.step == 4 and get_learning_rate(state) == pytest.approx(LR)
    moments = state.optimizer.state[unet.in_conv.weight]
    assert float(moments["step"]) == 4.0
    assert moments["exp_avg"].stride() == unet.in_conv.weight.stride()

    jfinal, losses_j = jax_run["states"][8], jax_run["losses"][4:8]
    state, losses_t = run_port(unet, state, coupled["diffusion"], rest, ema_decay=EMA)
    assert state.step == 8
    np.testing.assert_allclose(losses_t, losses_j, rtol=0, atol=1e-4)
    assert rel_l2(dict(unet.named_parameters()),
                  convert_unet(numpy_tree(jfinal.params))) < 1e-4
    assert rel_l2(state.ema_params, convert_unet(numpy_tree(jfinal.ema_params))) < 1e-4


def test_step_draws_from_the_generator_and_eval_uses_given_params(coupled):
    """With a generator the step draws t ~ U[t_min, T) and the noise itself,
    reproducibly; the eval step runs the model on the parameters it is given."""
    losses = []
    for _ in range(2):
        unet = port_unet(coupled)
        state = create_train_state(unet, LR, ema=True, device="cpu")
        step = make_cached_latent_train_step(unet, coupled["diffusion"], ema_decay=EMA)
        gen = torch.Generator().manual_seed(3)
        batch = {"latent": torch.from_numpy(coupled["batches"][0]["latent"])}
        state, a = step(state, batch, gen, SCALE)
        state, b = step(state, batch, gen, SCALE)
        losses.append((float(a), float(b)))
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]
    t = sample_timesteps(torch.Generator().manual_seed(0), 1000, T, 1)
    assert int(t.min()) == 1 and int(t.max()) == T - 1

    eval_step = make_cached_latent_eval_step(unet, coupled["diffusion"])
    noise = torch.from_numpy(coupled["batches"][1]["noise"])
    own = {k: v.detach() for k, v in unet.named_parameters()}
    with_own = eval_step(own, batch, None, SCALE, 5, noise=noise)
    with_ema = eval_step(inference_params(state), batch, None, SCALE, 5, noise=noise)
    assert inference_params(state) is state.ema_params
    jd = JGaussianDiffusion(jsched.make_schedule(cosine_beta_schedule(T)), loss_type="min_snr")
    jeval = jsteps.make_cached_latent_eval_step(coupled["jm"], jd)
    # the JAX eval step draws its noise from its key: draw the same and inject it
    key = jax.random.PRNGKey(5)
    jnoise = jax.random.normal(key, LATENT, jnp.float32)
    want = jeval(jax.tree_util.tree_map(jnp.asarray, coupled["params0"]),
                 {"latent": jnp.asarray(batch["latent"].numpy())}, key, SCALE, 5)
    fresh = port_unet(coupled)
    got = make_cached_latent_eval_step(fresh, coupled["diffusion"])(
        dict(fresh.named_parameters()), batch, None, SCALE, 5,
        noise=torch.from_numpy(np.array(jnoise)))
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    assert float(with_own) != float(with_ema)
    with pytest.raises(ValueError, match="generator"):
        step(state, batch, None, SCALE)
    with pytest.raises(ValueError, match="another model"):
        make_cached_latent_train_step(fresh, coupled["diffusion"])(state, batch, gen, SCALE)


def test_apply_if_finite_skips_the_whole_update_on_a_nan_batch(coupled):
    """A NaN batch leaves parameters, Adam moments and step count untouched
    and still reports its loss; the EMA update still runs after it; the next
    good batch updates as if the bad one had not been."""
    good, other = coupled["batches"][0], coupled["batches"][1]
    bad = dict(good, latent=np.full(LATENT, np.nan, np.float32))

    unet = port_unet(coupled)
    state = create_train_state(unet, LR, ema=True, device="cpu")
    state, _ = run_port(unet, state, coupled["diffusion"], [good], nan_guard=True,
                        ema_decay=EMA)
    params = {k: v.detach().clone() for k, v in unet.named_parameters()}
    shadow = {k: v.clone() for k, v in state.ema_params.items()}
    moments = {k: {n: t.clone() for n, t in state.optimizer.state[p].items()}
               for k, p in unet.named_parameters()}
    state, losses = run_port(unet, state, coupled["diffusion"], [bad], nan_guard=True,
                             ema_decay=EMA)
    assert np.isnan(losses[0]) and state.step == 1
    for k, p in unet.named_parameters():
        torch.testing.assert_close(p.detach(), params[k], rtol=0, atol=0)
        for n, t in state.optimizer.state[p].items():
            torch.testing.assert_close(t, moments[k][n], rtol=0, atol=0)
        torch.testing.assert_close(state.ema_params[k], EMA * shadow[k] + (1 - EMA) * params[k])
    state, _ = run_port(unet, state, coupled["diffusion"], [other], nan_guard=True,
                        ema_decay=EMA)
    assert state.step == 2

    clean = port_unet(coupled)
    cstate = create_train_state(clean, LR, device="cpu")
    cstate, _ = run_port(clean, cstate, coupled["diffusion"], [good, other])
    for (k, p), q in zip(unet.named_parameters(), clean.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)

    # without the guard the same batch poisons the parameters
    state, _ = run_port(unet, state, coupled["diffusion"], [bad])
    assert not bool(torch.isfinite(unet.in_conv.weight).all())
    assert apply_if_finite(state, torch.tensor(float("nan"))) is state


# ------------------------------------------------------- state, host side


def test_ema_update_and_learning_rate_accessors():
    lin = torch.nn.Linear(2, 2)
    state = create_train_state(lin, 3e-4, ema=True, device="cpu")
    assert state.step == 0 and get_learning_rate(state) == pytest.approx(3e-4)
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert state.ema_params["weight"].data_ptr() != lin.weight.data_ptr()
    before = state.ema_params["weight"].clone()
    with torch.no_grad():
        lin.weight.add_(1.0)
    assert ema_update(state, 0.75) is state
    torch.testing.assert_close(state.ema_params["weight"], before + 0.25)
    assert set_learning_rate(state, 1e-5) is state
    assert get_learning_rate(state) == pytest.approx(1e-5)
    plain = create_train_state(lin, 3e-4, device="cpu")
    assert plain.ema_params is None and ema_update(plain, 0.5) is plain
    assert inference_params(plain)["weight"].data_ptr() == lin.weight.data_ptr()
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(lin, 3e-4)   # the default device is the card


def test_plateau_scheduler_and_early_stopper_match_jax():
    """The host-side arithmetic, value for value: ``num_bad > patience`` in
    the scheduler, ``>= patience`` in the stopper."""
    losses = [1.0, 0.9, 0.95, 0.91, 0.9, 0.93, 0.92, 0.89, 0.9, 0.9, 0.9, 0.9, 0.9, 0.8]
    for kw in (dict(), dict(patience=1, factor=0.1, min_lr=5e-5)):
        js, ts = jstate.PlateauScheduler(**kw), PlateauScheduler(**kw)
        jlr = tlr = 1e-3
        for v in losses:
            jlr, tlr = js.update(v, jlr), ts.update(v, tlr)
            assert (jlr, js.best, js.num_bad) == (tlr, ts.best, ts.num_bad)
        assert tlr < 1e-3
    for patience in (4, 2):
        js, ts = jstate.EarlyStopper(patience=patience), EarlyStopper(patience=patience)
        stops = []
        for v in losses:
            a, b = js.update(v), ts.update(v)
            assert (a, js.best, js.num_bad, js.improved) == (b, ts.best, ts.num_bad, ts.improved)
            stops.append(b)
        assert any(stops)


def test_latent_scale_estimates_and_validation_grid_match_jax():
    rng = np.random.default_rng(22)
    batches = [rng.normal(size=(2, 4, 4, 4, 3)).astype(np.float32) * s for s in (0.5, 2.0)]
    want = jsteps.estimate_latent_scale_from_latents(batches)
    got = estimate_latent_scale_from_latents([torch.from_numpy(b) for b in batches])
    assert got == pytest.approx(want, rel=1e-6)
    assert estimate_latent_scale_from_latents([]) == 1.0
    np.testing.assert_array_equal(fixed_validation_timesteps(400),
                                  np.asarray(jsteps.fixed_validation_timesteps(400)))


# ---------------------------------------------------------------------- VAE


@pytest.fixture(scope="module")
def vae_pair():
    jm = JVAE3D(**VAE_KW)
    x = np.random.default_rng(23).normal(size=(4, 8, 8, 8, 2)).astype(np.float32)
    params = numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                         jax.random.PRNGKey(2)))

    def port():
        vae = VAE3D(**VAE_KW)
        vae.load_state_dict(vae3d_state_dict_from_flax(params, VAE_KW["num_down"]))
        return vae

    return dict(jm=jm, params=params, x=x, port=port)


def test_vae_step_matches_jax(vae_pair):
    """One stage-1 step on both sides. The JAX step draws its ε from its key
    inside ``reparameterize``; the test draws the same ε and injects it.
    Losses 1e-5 (measured 4.8e-7); parameters after the Adam step 1e-4 relative
    L2 (measured 3.9e-6); the latent scale estimate 1e-5 relative."""
    p = vae_pair
    key = jax.random.PRNGKey(7)
    jparams = jax.tree_util.tree_map(jnp.asarray, p["params"])
    mu = p["jm"].apply(jparams, jnp.asarray(p["x"]), method="encode_to_latent")
    eps = np.array(jax.random.normal(key, mu.shape, mu.dtype))
    jstep = jsteps.make_vae_train_step(p["jm"], kl_weight=1e-3, donate=False)
    jfinal, jm_ = jstep(jstate.create_train_state(jparams, LR), {"volume": jnp.asarray(p["x"])}, key)

    vae = p["port"]()
    batch = {"volume": torch.from_numpy(p["x"])}
    evals = make_vae_eval_step(vae, kl_weight=1e-3)(
        dict(vae.named_parameters()), batch, eps=torch.from_numpy(eps))
    state = create_train_state(vae, LR, device="cpu")
    state, metrics = make_vae_train_step(vae, kl_weight=1e-3)(
        state, batch, eps=torch.from_numpy(eps))
    for name in ("loss", "recon", "kl"):
        np.testing.assert_allclose(float(metrics[name]), float(jm_[name]), atol=1e-5)
        np.testing.assert_allclose(float(evals[name]), float(jm_[name]), atol=1e-5)
    assert state.step == 1
    want = vae3d_state_dict_from_flax(numpy_tree(jfinal.params), VAE_KW["num_down"])
    assert rel_l2(dict(vae.named_parameters()), want) < 1e-4

    got_scale = estimate_latent_scale(p["port"](), [batch["volume"][:2], batch["volume"][2:]])
    want_scale = jsteps.estimate_latent_scale(
        p["jm"], jparams, [jnp.asarray(p["x"][:2]), jnp.asarray(p["x"][2:])])
    assert got_scale == pytest.approx(want_scale, rel=1e-5)


def test_vae_grad_accum_equals_the_full_batch_gradient(vae_pair):
    """``grad_accum=2`` on strided microbatches (row r → microbatch r % 2, of ε
    too) gives the full-batch gradient: ``vae_loss`` is a mean over its batch.
    Gradients 1e-6 absolute; losses 1e-6."""
    p = vae_pair
    batch = {"volume": torch.from_numpy(p["x"])}
    eps = torch.from_numpy(np.random.default_rng(24).normal(size=(4, 4, 4, 4, 4))
                           .astype(np.float32))
    grads, metrics = [], []
    for accum in (1, 2):
        vae = p["port"]()
        state = create_train_state(vae, LR, device="cpu")
        state, m = make_vae_train_step(vae, grad_accum=accum)(state, batch, eps=eps)
        assert state.step == 1
        grads.append([q.grad.clone() for q in vae.parameters()])
        metrics.append(m)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    for name in ("loss", "recon", "kl"):
        torch.testing.assert_close(metrics[0][name], metrics[1][name], atol=1e-6, rtol=0)
    # the oracle built by hand: mean of the two microbatch losses
    vae = p["port"]()
    by_hand = []
    for a in range(2):
        recon, mu, logvar = vae(batch["volume"][a::2], eps=eps[a::2])
        by_hand.append(vae_loss(recon, batch["volume"][a::2], mu, logvar, 1e-4)[0])
    torch.testing.assert_close(metrics[1]["loss"], torch.stack(by_hand).mean().detach())
    with pytest.raises(ValueError, match="not divisible"):
        make_vae_train_step(vae, grad_accum=3)(create_train_state(vae, LR, device="cpu"),
                                               batch, eps=eps)


def test_latent_diffusion_step_equals_cached_step_on_encoded_latents(coupled, vae_pair):
    """Frozen-VAE encode per step against the cached-latent step fed the same
    encode: identical (the VAE is used under no_grad and gets no gradient)."""
    vae = vae_pair["port"]()
    batch = {"volume": torch.from_numpy(vae_pair["x"][:2])}
    with torch.no_grad():
        latent = vae.encode_to_latent(batch["volume"])
    assert tuple(latent.shape) == (2, 4, 4, 4, 4)
    b = coupled["batches"][0]
    t = torch.from_numpy(b["t"]).long()
    noise = torch.from_numpy(b["noise"][:, :4, :4, :4])
    results = []
    for encode in (True, False):
        unet = port_unet(coupled)
        state = create_train_state(unet, LR, device="cpu")
        if encode:
            step = make_latent_diffusion_train_step(unet, vae, coupled["diffusion"])
            state, loss = step(state, batch, None, SCALE, t=t, noise=noise)
            ev = make_latent_diffusion_eval_step(unet, vae, coupled["diffusion"])(
                dict(unet.named_parameters()), batch, None, SCALE, 5, noise=noise)
        else:
            step = make_cached_latent_train_step(unet, coupled["diffusion"])
            state, loss = step(state, {"latent": latent}, None, SCALE, t=t, noise=noise)
            ev = make_cached_latent_eval_step(unet, coupled["diffusion"])(
                dict(unet.named_parameters()), {"latent": latent}, None, SCALE, 5, noise=noise)
        results.append((loss, ev, [q.detach().clone() for q in unet.parameters()]))
    assert all(q.grad is None for q in vae.parameters())
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=0, atol=0)
    for a, c in zip(results[0][2], results[1][2]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
