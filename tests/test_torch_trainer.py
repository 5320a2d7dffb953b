"""The port's ``Trainer`` against ``mrijax.train.Trainer``.

1. Scripted steps, one tiny state per framework: the train and val losses are
   functions of (epoch, step) carried in by the loaders, so both trainers see
   the same losses, and the scenarios of ``tests/test_preemption.py``
   (a straight run with plateau and early stop, a mid-epoch preemption, one
   on an epoch's last step, one at the early-stop boundary, a zero
   validation budget) each run once straight through and once resumed by a
   new trainer on the same directory. Both frameworks must give the same
   learning rate, train and val loss after every epoch (read from their
   metrics logs), the same ``epochs_run``, ``stopped_early`` and
   ``preempted``, the same extras in every checkpoint (the JAX side read
   with ``restore_host``) and the same best step. The losses are binary
   fractions and the learning rate 2⁻⁶, so "the same" is exact.
2. A narrow ``UNet3D`` with the cached-latent step on the CPU: straight for 3
   epochs, and again as 2 epochs + resume or as a mid-epoch preemption +
   resume, from a fresh state each time: parameters and EMA bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrijax.io import CheckpointManager as JCheckpointManager
from mrijax.obs import MetricsLogger as JMetricsLogger
from mrijax.obs import reset_termination as jreset_termination
from mrijax.obs.signals import _handler as jhandler
from mrijax.train import Trainer as JTrainer
from mrijax.train import create_train_state as jcreate_train_state
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.io import CheckpointManager
from mrijax_torch.models import UNet3D
from mrijax_torch.obs import MetricsLogger, reset_termination
from mrijax_torch.obs.signals import _handler
from mrijax_torch.train import (
    Trainer,
    create_train_state,
    fixed_validation_timesteps,
    make_cached_latent_eval_step,
    make_cached_latent_train_step,
)
from mrijax_torch.train.trainer import step_seed

LR = 2.0 ** -6
STEPS = 4
# val loss by epoch: improves twice, then stalls — plateau (patience 1) halves
# the rate after epoch 3, early stop (patience 3) ends the run after epoch 4
VAL = [1.0, 0.5, 0.75, 0.625, 0.875, 0.5625, 0.6875, 0.8125]


def train_loss(epoch, i):
    return 2.0 - epoch * 0.125 - i * 0.03125


def val_loss(epoch, i):
    return VAL[epoch] + i * 0.0625


class ScriptLoader:
    """Batches that carry (epoch, index); ``preempt`` = {(epoch, index)} flags
    the termination handler while that batch is handed out, (epoch, "edge")
    after the epoch's last batch."""

    def __init__(self, n, handler, preempt=()):
        self.n, self.handler, self.preempt = n, handler, set(preempt)
        self.batch_size = 2
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if (self.epoch, i) in self.preempt:
                self.handler(10, None)
            yield {"epoch": self.epoch, "i": i}
        if (self.epoch, "edge") in self.preempt:
            self.handler(10, None)


class JaxSide:
    handler = staticmethod(jhandler)
    reset = staticmethod(jreset_termination)
    Trainer, Manager, Logger = JTrainer, JCheckpointManager, JMetricsLogger

    def __init__(self):
        import flax.linen as nn

        model = nn.Dense(1)
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
        x = jnp.ones((2, 4))

        @jax.jit
        def update(state):
            grads = jax.grad(lambda p: jnp.mean(model.apply(p, x) ** 2))(state.params)
            return state.apply_gradients(grads=grads)

        self.state = jcreate_train_state(params, LR)
        self.train_step = lambda state, batch, key: (
            update(state), jnp.float32(train_loss(batch["epoch"], batch["i"])))
        self.eval_step = lambda params, batch, key: jnp.float32(
            val_loss(batch["epoch"], batch["i"]))

    @staticmethod
    def extras(mgr, steps):
        return {s: mgr.restore_host(step=s)[1] for s in steps}


class TorchSide:
    handler = staticmethod(_handler)
    reset = staticmethod(reset_termination)
    Trainer, Manager, Logger = Trainer, CheckpointManager, MetricsLogger

    def __init__(self):
        torch.manual_seed(0)
        self.state = create_train_state(torch.nn.Linear(4, 1), LR, device="cpu")
        x = torch.ones(2, 4)

        def train_step(state, batch, generator):
            state.optimizer.zero_grad(set_to_none=True)
            state.model(x).square().mean().backward()
            state.optimizer.step()
            state.step += 1
            return state, torch.tensor(train_loss(batch["epoch"], batch["i"]))

        self.train_step = train_step
        self.eval_step = lambda params, batch, generator: torch.tensor(
            val_loss(batch["epoch"], batch["i"]))

    @staticmethod
    def extras(mgr, steps):
        return {s: mgr.restore_host(step=s)[1] for s in steps}


# name: (trainer options, preemption points of the first fit)
SCENARIOS = {
    "straight_plateau_early_stop": ({}, ()),
    "mid_epoch": ({}, [(1, 1)]),
    "last_step": ({}, [(1, STEPS - 1)]),
    "edge": ({}, [(2, "edge")]),
    "early_stop_boundary": ({}, [(4, STEPS - 1)]),
    "val_budget_zero": ({"preempt_val_budget_s": 0.0}, [(1, STEPS - 1)]),
}


def run(side_cls, tmp_path, options, preempt):
    """First fit (preempted where the scenario says), then, where it was
    preempted, a resume by a new trainer and manager on the same directory."""
    side = side_cls()
    side.reset()
    logger = side.Logger("trainer", run_name="run", root=str(tmp_path / "runs"))
    saved = []
    results = []
    state = side.state
    for phase in range(2):
        mgr = side.Manager(tmp_path / "ck", max_to_keep=100)
        save = mgr.save

        def spy(step, *args, _save=save, **kw):
            saved.append(step)
            return _save(step, *args, **kw)

        mgr.save = spy
        trainer = side.Trainer(
            train_step=side.train_step, eval_step=side.eval_step,
            train_loader=ScriptLoader(STEPS, side.handler, preempt if phase == 0 else ()),
            val_loader=ScriptLoader(2, side.handler),
            logger=logger, checkpoint_manager=mgr, epochs=len(VAL), seed=3,
            plateau_patience=1, early_stop_patience=3, **options)
        res = trainer.fit(state)
        side.reset()
        results.append((res.epochs_run, res.stopped_early, res.preempted, res.best_val_loss,
                        trainer.start_epoch, trainer.global_step))
        state = res.state
        if phase == 0 and not res.preempted:
            break
    best = mgr.best_step
    extras = side.extras(mgr, saved)
    mgr.close()
    logger.finish()
    metrics = [(m["key"], m["value"], m["step"]) for m in logger.read_metrics()
               if m["key"] in ("lr", "train_loss", "val_loss")]
    return {"results": results, "saved": saved, "best": best, "extras": extras,
            "metrics": metrics}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_trainer_matches_jax_on_scripted_steps(scenario, tmp_path):
    options, preempt = SCENARIOS[scenario]
    got = run(TorchSide, tmp_path / "torch", options, preempt)
    want = run(JaxSide, tmp_path / "jax", options, preempt)
    assert got == want
    # what each scenario is about, so that a change to the script cannot
    # quietly turn it into another
    results, extras, saved = got["results"], got["extras"], got["saved"]
    lrs = [v for k, v, _ in got["metrics"] if k == "lr"]
    if scenario == "straight_plateau_early_stop":
        assert results[0][:3] == (5, True, False)
        assert lrs == [LR] * 3 + [LR / 2] * 2
        return
    assert results[0][2], "the first fit was preempted"
    preempted_save = extras[saved[results[0][0] - 1]]   # the save of the last epoch run
    if scenario == "mid_epoch":
        assert not preempted_save["epoch_complete"] and results[1][4] == 1  # run again
    elif scenario in ("last_step", "val_budget_zero"):
        assert preempted_save["epoch_complete"] and results[1][4] == 2
    elif scenario == "edge":
        assert preempted_save["epoch_complete"] and results[1][4] == 3
    elif scenario == "early_stop_boundary":
        assert results[0][:3] == (5, True, True) and results[1][:3] == (0, True, False)
    if scenario == "val_budget_zero":
        assert results[0][3] == VAL[0] + 0.03125   # only epoch 0's validation was seen
        return
    # the resumed run's last reading of every epoch is the straight run's
    straight = run(TorchSide, tmp_path / "straight", {}, ())

    def last_by_epoch(metrics):
        return {(k, e): v for k, v, e in metrics}

    assert last_by_epoch(got["metrics"]) == last_by_epoch(straight["metrics"])


# ------------------------------------------------------------ narrow UNet3D

LATENT = (2, 4, 4, 4, 4)


class LatentLoader:
    """In-memory latents; flags the termination handler while the batch of
    an (epoch, index) in ``preempt`` is handed out."""

    def __init__(self, batches, preempt=()):
        self.batches, self.preempt = batches, set(preempt)
        self.batch_size = batches[0]["latent"].shape[0]
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if (self.epoch, i) in self.preempt:
                _handler(10, None)
            yield b


def unet_state(seed):
    torch.manual_seed(seed)
    unet = UNet3D(in_channels=4, base_channels=8, channel_mults=(1, 2), time_emb_dim=16,
                  num_heads=2, use_attention=True)
    return create_train_state(unet, 1e-3, ema=True, device="cpu")


def unet_fit(state, ckpt_dir, epochs, preempt=(), **attrs):
    """The cached-latent step through the trainer; ``attrs`` set trainer
    attributes before ``fit`` (an in-memory continuation sets
    ``start_epoch`` and ``global_step`` as a resume would)."""
    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(20)), loss_type="min_snr")
    step = make_cached_latent_train_step(state.model, diffusion, t_min=1, ema_decay=0.9)
    evaluate = make_cached_latent_eval_step(state.model, diffusion)
    t_grid = fixed_validation_timesteps(20, 8)
    rng = np.random.default_rng(0)
    batches = [{"latent": torch.from_numpy(rng.normal(size=LATENT).astype(np.float32))}
               for _ in range(3)]

    def train_step(state, batch, generator):
        return step(state, batch, generator, 0.8)

    def eval_step(params, batch, generator, batch_index=0):
        return evaluate(params, batch, generator, 0.8, t_grid[batch_index % len(t_grid)])

    trainer = Trainer(train_step=train_step, eval_step=eval_step,
                      train_loader=LatentLoader(batches[:2], preempt),
                      val_loader=LatentLoader(batches[2:]),
                      checkpoint_manager=ckpt_dir and CheckpointManager(ckpt_dir, max_to_keep=2),
                      epochs=epochs, seed=11, resume=ckpt_dir is not None)
    for name, value in attrs.items():
        setattr(trainer, name, value)
    res = trainer.fit(state)
    reset_termination()
    return res


def snapshot(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [e.clone() for e in state.ema_params.values()])


def assert_bitwise(a, b):
    assert a.step == b.step
    for x, y in zip(snapshot(a), snapshot(b), strict=True):
        assert torch.equal(x, y)


def test_unet3d_two_epochs_then_resume_is_bitwise_the_straight_run(tmp_path):
    """Resumed from disk into weights made from another seed, so that all of
    the state must come from the checkpoint."""
    reset_termination()
    straight = unet_fit(unet_state(0), tmp_path / "a", 3)
    assert straight.epochs_run == 3 and not straight.preempted
    first = unet_fit(unet_state(0), tmp_path / "b", 2)
    assert first.epochs_run == 2
    resumed = unet_fit(unet_state(1), tmp_path / "b", 3)
    assert resumed.epochs_run == 1 and resumed.state.step == 6
    assert_bitwise(resumed.state, straight.state)


def test_unet3d_mid_epoch_resume_is_bitwise_the_in_memory_continuation(tmp_path):
    """A preemption at epoch 1, step 0 checkpoints the state after that step
    (epoch_complete False); the resume re-runs epoch 1 in full, so it applies
    one update more than a straight run (the JAX package's semantics). It
    must equal, bit for bit, the preempted state carried on in memory through
    the same epoch."""
    reset_termination()
    preempted = unet_fit(unet_state(0), tmp_path / "b", 3, preempt={(1, 0)})
    assert preempted.preempted and preempted.epochs_run == 2 and preempted.state.step == 3
    _, extra = CheckpointManager(tmp_path / "b").restore_host()
    assert extra["epoch"] == 1 and not extra["epoch_complete"] and extra["global_step"] == 3
    resumed = unet_fit(unet_state(1), tmp_path / "b", 3)
    assert resumed.epochs_run == 2 and resumed.state.step == 7
    carried = unet_fit(preempted.state, None, 3, start_epoch=1, global_step=3)
    assert_bitwise(resumed.state, carried.state)


def test_step_seeds_depend_only_on_their_four_integers():
    seeds = {step_seed(s, stream, e, i) for s in (0, 1) for stream in (0, 1)
             for e in range(3) for i in range(3)}
    assert len(seeds) == 36
    assert step_seed(3, 0, 2, 1) == step_seed(3, 0, 2, 1)
    a = torch.Generator().manual_seed(step_seed(3, 0, 2, 1))
    b = torch.Generator().manual_seed(step_seed(3, 0, 2, 1))
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def test_fit_refuses_several_processes(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    side = TorchSide()
    trainer = Trainer(train_step=side.train_step, eval_step=side.eval_step,
                      train_loader=ScriptLoader(STEPS, _handler),
                      val_loader=ScriptLoader(2, _handler), epochs=1)
    with pytest.raises(NotImplementedError, match="one process"):
        trainer.fit(side.state)
