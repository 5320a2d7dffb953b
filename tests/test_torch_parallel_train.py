"""Data parallelism and FSDP of the port's train steps, the trainer's
preemption vote across processes, and ``run_experiment`` over two processes.

Each multi-process case runs real gloo groups (``tests/_torch_mp_worker.py``)
and is held against the port in one process at the global batch — the same
rows, the same draws (drawn at the global size, so a rank's share is the
one-process run's rows) — and, for the bare step, against the JAX package on
a 2-device CPU mesh with ``t`` and the noise drawn from its keys. Parameters
after several steps are compared under SGD, not Adam: Adam's normalisation
amplifies the float32 noise of a reassociated all-reduce where gradients are
near zero (``tests/test_multidevice_equivalence.py``).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_mp_worker import launch
from mrijax.diffusion import GaussianDiffusion as JGaussianDiffusion
from mrijax.diffusion import schedules as jsched
from mrijax.models import UNet2D as JUNet2D
from mrijax.parallel import fsdp as jfsdp
from mrijax.parallel import make_mesh as jmake_mesh
from mrijax.parallel import shard_batch as jshard_batch
from mrijax.train import state as jstate
from mrijax.train import steps as jsteps
from mrijax_torch import config
from mrijax_torch.data import synthetic
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.io import unet2d_state_dict_from_flax
from mrijax_torch.io.checkpoint import CheckpointManager
from mrijax_torch.models import UNet2D
from mrijax_torch.parallel import fsdp_spec
from mrijax_torch.train import create_train_state, make_diffusion_train_step
from mrijax_torch.train.state import TrainState

T = 20
LR = 0.05
STEPS = 3
BATCH = 4
SIZE = 16
MULTS = (1, 2)
MODEL_KW = dict(in_channels=1, out_channels=1, base_channels=8, channel_mults=MULTS,
                time_emb_dim=16)
ATOL = 1e-5


def jax_draws(key, shape):
    """t and the noise as the JAX step draws them from ``key``."""
    tkey, nkey = jax.random.split(key)
    return (np.array(jsteps.sample_timesteps(tkey, shape[0], T, 0)),
            np.array(jax.random.normal(nkey, shape, jnp.float32)))


@pytest.fixture(scope="module")
def setup():
    """Flax params (small normals on the init's tree), the port's state dict,
    the global batches, keys and their draws."""
    rng = np.random.default_rng(0)
    jm = JUNet2D(**MODEL_KW)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)),
                                          jnp.zeros((1,), jnp.int32), jnp.zeros((1,))))
    params = jax.tree_util.tree_map(
        lambda leaf: (0.1 * rng.normal(size=leaf.shape)).astype(np.float32), tree)
    batches = [{"image": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32),
                "z_pos": rng.uniform(0, 1, BATCH).astype(np.float32)} for _ in range(STEPS)]
    keys = [jax.random.PRNGKey(300 + i) for i in range(STEPS)]
    draws = [jax_draws(k, (BATCH, SIZE, SIZE, 1)) for k in keys]
    state_dict = {k: v.contiguous() for k, v in
                  unet2d_state_dict_from_flax(params, channel_mults=MULTS).items()}
    inputs = {"model_kw": MODEL_KW, "state_dict": state_dict, "betas": linear_beta_schedule(T),
              "lr": LR, "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                                    for b in batches],
              "ts": [torch.from_numpy(t).long() for t, _ in draws],
              "noises": [torch.from_numpy(n) for _, n in draws]}
    return jm, params, batches, keys, inputs


def one_process_sgd(inputs):
    """The port in this process at the global batch: losses and parameters."""
    model = UNet2D(**MODEL_KW)
    model.load_state_dict(inputs["state_dict"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR), 0, None)
    step = make_diffusion_train_step(model, GaussianDiffusion(make_schedule(inputs["betas"])))
    losses = []
    for b, t, n in zip(inputs["batches"], inputs["ts"], inputs["noises"]):
        state, loss = step(state, b, t=t, noise=n)
        losses.append(float(loss))
    return losses, {k: v.detach() for k, v in model.state_dict().items()}


def assert_params_close(got, want, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=atol, rtol=0, msg=k)


def test_data_parallel_step_matches_one_process_and_jax(setup, tmp_path):
    """Two processes of the data-parallel 2D step under SGD against the port
    at the global batch and against the JAX step on a 2-device mesh: losses
    of each step and parameters after 3 steps at 1e-5. Then one nan-guarded
    step in which only the last rank's rows hold a NaN: both ranks see the
    global NaN loss and both skip the update."""
    jm, params, batches, keys, inputs = setup
    mesh = jmake_mesh(("data",), devices=jax.devices()[:2])
    jdiff = JGaussianDiffusion(jsched.make_schedule(inputs["betas"]))
    jstep = jsteps.make_diffusion_train_step(jm, jdiff, donate=False)
    jst = jstate.TrainState.create(apply_fn=None, tx=optax.sgd(LR),
                                   params=jax.tree_util.tree_map(jnp.asarray, params))
    jlosses = []
    with mesh:
        for b, key in zip(batches, keys):
            jst, loss = jstep(jst, jshard_batch(mesh, b), key)
            jlosses.append(float(loss))
    jparams = {k: torch.from_numpy(np.array(v)) for k, v in unet2d_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jst.params), channel_mults=MULTS).items()}

    losses, one = one_process_sgd(inputs)
    np.testing.assert_allclose(losses, jlosses, atol=ATOL, rtol=0)
    assert_params_close(one, jparams)

    outs, _ = launch("dp_step", 2, tmp_path, inputs)
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, atol=ATOL, rtol=0)
        assert_params_close(out["params"], one)
        assert np.isnan(out["nan_loss"]) and out["nan_step_skipped"]
    assert_params_close(outs[1]["params"], outs[0]["params"], atol=0)


@pytest.mark.parametrize("shape,n,min_leaf", [
    ((64, 3, 3, 3, 32), 2, 2 ** 15), ((64, 3, 3, 3, 32), 4, 2 ** 15),
    ((3, 3, 3, 128, 256), 8, 2 ** 15), ((256,), 2, 2 ** 15), ((256,), 2, 16),
    ((7, 9, 11, 13), 2, 8), ((7, 9, 11, 13), 3, 8), ((6, 6), 3, 8), ((6, 6), 1, 8),
    ((), 2, 0), ((1024, 1024), 2, 2 ** 15), ((5, 1024, 3), 4, 16)])
def test_fsdp_spec_matches_jax(shape, n, min_leaf):
    """The largest dimension that n divides, leaves under ``min_leaf_elems``
    replicated — exactly the JAX ``PartitionSpec``, as a tuple."""
    assert fsdp_spec(shape, n, "data", min_leaf) == tuple(
        jfsdp.fsdp_spec(shape, n, "data", min_leaf))


def test_fsdp_equals_replicated_and_checkpoints_restore_in_one_process(setup, tmp_path):
    """Two processes, Adam and EMA: the same steps replicated and under FSDP
    (the conv weights sharded, the small leaves replicated) give the same
    losses, parameters and gathered EMA shadow. The FSDP checkpoint is
    written once (rank 0), restores into each rank's sharded state, and
    restores in one process into a plain state equal to the replicated
    run's."""
    *_, inputs = setup
    outs, _ = launch("fsdp", 2, tmp_path, {**inputs, "min_leaf": 256})
    rep, fs = outs[0]["replicated"], outs[0]["fsdp"]
    assert outs[0]["sharded"] and outs[0]["sharded"] == outs[1]["sharded"]
    for name in outs[0]["sharded"]:
        full = inputs["state_dict"][name].shape
        assert sum(outs[0]["shard_shapes"][name]) < sum(full) or len(full) == 1
    np.testing.assert_allclose(fs["losses"], rep["losses"], atol=ATOL, rtol=0)
    assert_params_close(fs["params"], rep["params"])
    assert_params_close(fs["ema"], rep["ema"])
    assert_params_close(outs[1]["fsdp"]["params"], fs["params"], atol=0)
    assert outs[0]["written"] == [STEPS] and outs[1]["written"] == []
    assert outs[0]["restored_ema_equal"] and outs[1]["restored_ema_equal"]

    model = UNet2D(**MODEL_KW)
    state = create_train_state(model, LR, ema=True, device="cpu")
    _, extra = CheckpointManager(tmp_path / "ckpt").restore(state)
    assert extra == {"epoch": 0} and state.step == STEPS
    assert_params_close({k: v.detach() for k, v in model.state_dict().items()}, rep["params"])
    assert_params_close(state.ema_params, rep["ema"])
    # the moments are full tensors, like a replicated run's
    for p in model.parameters():
        assert state.optimizer.state[p]["exp_avg"].shape == p.shape


def test_trainer_preemption_vote_across_processes(setup, tmp_path):
    """SIGUSR1 reaches rank 1 alone while step 1 of epoch 0 runs. With the
    vote every 2 steps both ranks break after step 1 — the same consensus
    step —, rank 0 alone writes the preemption checkpoint, and the resumed
    run re-runs the epoch and finishes on both ranks with the same
    parameters."""
    *_, inputs = setup
    outs, _ = launch("trainer_preempt", 2, tmp_path, {
        **inputs, "batches": inputs["batches"] + inputs["batches"][:1]})
    for rank, out in enumerate(outs):
        assert out["preempted"] and out["global_step"] == 2
        assert out["resumed_from"] == 0 and out["final_step"] == 2 + 2 * 4
        assert out["epochs_run"] == 2
    assert outs[0]["writes"] == [2] and outs[1]["writes"] == []
    assert outs[0]["writes_resume"] == [6, 10] and outs[1]["writes_resume"] == []
    assert_params_close(outs[1]["params"], outs[0]["params"], atol=0)


TINY_2D = {"data.image_size": 16, "data.batch_size": 4, "data.val_fraction": 0.2,
           "data.subsample_fraction": None, "unet.base_channels": 8,
           "unet.channel_mults": (1, 2), "unet.time_emb_dim": 16, "unet.compute_dtype": "float32",
           "diffusion.timesteps": 20, "train.epochs": 1, "train.debug_fast": True,
           "train.debug_max_steps": 3, "train.learning_rate": 0.05, "train.ema_decay": 0.9}
TINY_3D = {
    "data.batch_size": 2, "data.latent_batch_size": 2, "data.patch_size": (8, 16, 16),
    "data.val_fraction": 0.34,
    "vae.base_channels": 8, "vae.num_down": 2, "vae.latent_channels": 4,
    "vae.compute_dtype": "float32", "vae.remat": False,
    "unet.in_channels": 4, "unet.out_channels": 4, "unet.base_channels": 8,
    "unet.channel_mults": (1, 2), "unet.time_emb_dim": 16, "unet.num_heads": 2,
    "unet.compute_dtype": "float32", "diffusion.timesteps": 10,
    "train.epochs": 1, "train.learning_rate": 0.05, "train.debug_fast": True,
    "train.debug_max_steps": 2, "train.ema_decay": 0.9, "train.cache_latents": True,
    "vae_train.epochs": 1, "vae_train.learning_rate": 0.05, "vae_train.debug_fast": True,
    "vae_train.debug_max_steps": 2,
}


@pytest.fixture(scope="module")
def brats_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    synthetic.write_synthetic_brats(root, num_subjects=6, shape=(32, 32, 20), seed=0)
    return root


def _params(result):
    return {k: v.detach() for k, v in result.state.model.state_dict().items()}


@pytest.mark.parametrize("family", ["slice_cond_2d", "ddpm_3d_ldm"])
def test_run_experiment_on_two_processes_equals_one(monkeypatch, tmp_path, brats_root, family):
    """``run_experiment`` of the 2D preset and of the 3D two-stage recipe
    (VAE, the latent cache that rank 0 packs, the latent scale over the
    gathered global batches, the cached-latent LDM) on two gloo processes
    against one process at the same global batch, Adam swapped for SGD on
    both sides: best validation losses and final parameters at 1e-5. Rank 0
    alone makes a metrics logger and writes checkpoints."""
    import mrijax_torch.train.state as train_state
    from mrijax_torch.obs import MetricsLogger
    from mrijax_torch.train import experiments

    preset = {"slice_cond_2d": config.preset_slice_cond_2d,
              "ddpm_3d_ldm": config.preset_ddpm_3d_ldm}[family]
    tiny = TINY_2D if family == "slice_cond_2d" else TINY_3D
    cfg = preset(str(brats_root), **tiny, **{"name": "mp",
                                              "train.checkpoint_dir": str(tmp_path / "mp")})
    outs, _ = launch("run_experiment", 2, tmp_path / "mp_run", {"config": cfg.to_dict()},
                     cwd=tmp_path)

    monkeypatch.setattr(train_state, "make_adam",
                        lambda params, lr: torch.optim.SGD(params, lr=lr))
    monkeypatch.chdir(tmp_path)
    one_cfg = preset(str(brats_root), **tiny, **{"name": "one",
                                                  "train.checkpoint_dir": str(tmp_path / "one")})
    result = experiments.run_experiment(one_cfg, device="cpu",
                                        logger=MetricsLogger("one", root=str(tmp_path / "r1")))
    stages = ((result[0], "vae"), (result[1], "ldm")) if family == "ddpm_3d_ldm" else (
        (result, None),)
    for out in outs:
        got = out["result"]
        if family == "ddpm_3d_ldm":
            assert got["latent_scale"] == pytest.approx(result[2], rel=1e-6)
        for res, key in stages:
            g = got[key] if key else got
            assert g["epochs_run"] == res.epochs_run
            assert g["best_val_loss"] == pytest.approx(res.best_val_loss, abs=ATOL)
            assert_params_close(g["params"], _params(res))
    assert outs[0]["loggers"] == 1 and outs[1]["loggers"] == 0
    assert outs[0]["writes"] and outs[1]["writes"] == []
    assert (tmp_path / "mp" / family / "mp").is_dir()
