"""Generic epoch driver: the training runtime shared by all model families.

Counterpart of ``mrijax/train/trainer.py``, behaviour for behaviour:

* epoch loop over an injected ``train_step`` whose losses stay on the device
  and are fetched once per epoch with one ``torch.stack(...).cpu()`` (no
  per-step host synchronisation),
* validation each epoch on ``inference_params(state)`` (the EMA shadow when
  tracked) + plateau LR + early stopping (factor 0.5 / patience 3, stop
  patience 4),
* checkpointing of the FULL train state with best-by-val policy and true
  resume (epoch, scheduler counters); the step RNG needs no persistence,
  because every generator is seeded from (seed, stream, epoch, step), so a
  resumed run draws exactly what the uninterrupted run would have,
* preemption handling: polls the SIGUSR1/SIGTERM flag between steps and
  epochs, checkpoints and finalizes before exit; an epoch interrupted
  mid-way is re-run on resume rather than silently counted as trained,
* steps/s + epoch time + device memory telemetry to the metrics logger,
* DEBUG_FAST smoke mode (step-capped epochs).

``train_step(state, batch, generator) → (state, loss_or_metrics)`` and
``eval_step(params, batch, generator[, batch_index=i]) → loss`` are injected;
a generator lives on the device of the state's parameters. One process: the
multi-process consensus on preemption comes with the parallel port, and
``fit`` refuses a ``torch.distributed`` group of more than one process.
"""

import inspect
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from mrijax_torch.obs import MetricsLogger, StepTimer, device_memory_stats, should_terminate
from mrijax_torch.train.state import (
    EarlyStopper,
    PlateauScheduler,
    get_learning_rate,
    inference_params,
    set_learning_rate,
)
from mrijax_torch.train.steps import _device_of

TRAIN_STREAM, VAL_STREAM = 0, 1


@dataclass
class TrainerResult:
    state: object
    best_val_loss: float
    epochs_run: int
    stopped_early: bool
    preempted: bool


def step_seed(seed: int, stream: int, epoch: int, step: int) -> int:
    """The seed of one step's generator: a pure function of the four integers
    (numpy's ``SeedSequence`` mixes them), so draws do not depend on what ran
    before — the counterpart of the JAX package's ``fold_in`` chain."""
    return int(np.random.SeedSequence([seed, stream, epoch, step]).generate_state(1, np.uint64)[0])


class Trainer:
    def __init__(
        self,
        *,
        train_step: Callable,
        eval_step: Callable,
        train_loader,
        val_loader,
        logger: Optional[MetricsLogger] = None,
        checkpoint_manager=None,
        epochs: int = 20,
        plateau_factor: float = 0.5,
        plateau_patience: int = 3,
        early_stop_patience: int = 4,
        log_every_steps: int = 500,
        debug_max_steps: Optional[int] = None,
        seed: int = 0,
        metric_prefix: str = "",
        checkpoint_extra: Optional[Callable[[], dict]] = None,
        resume: bool = True,
        preempt_val_budget_s: float = 120.0,
    ):
        self.train_step = train_step
        self.eval_step = eval_step
        # eval_step may take a per-epoch batch index (fixed-timestep val
        # grids must realign every epoch)
        self._eval_takes_index = "batch_index" in inspect.signature(
            eval_step
        ).parameters
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger
        self.ckpt = checkpoint_manager
        self.epochs = epochs
        self.scheduler = PlateauScheduler(plateau_factor, plateau_patience)
        self.stopper = EarlyStopper(early_stop_patience)
        self.log_every_steps = log_every_steps
        self.debug_max_steps = debug_max_steps
        self.seed = seed
        self.prefix = metric_prefix
        self.checkpoint_extra = checkpoint_extra or (lambda: {})
        self.resume = resume
        # wall-clock cap on the validation pass a fully-trained preempted
        # epoch runs inside the SIGUSR1 grace window (SLURM kills 600 s
        # after the signal); the checkpoint save that follows must always
        # fit in what remains
        self.preempt_val_budget_s = preempt_val_budget_s
        self.start_epoch = 0
        self.global_step = 0
        self.resumed_stopped_early = False

    # ------------------------------------------------------------- resume
    def try_resume(self, state):
        """Restore the latest checkpoint into ``state`` if one exists."""
        if self.ckpt is None or self.ckpt.latest_step is None:
            return state
        state, extra = self.ckpt.restore(state)
        extra = extra or {}
        epoch = int(extra.get("epoch", -1))
        # an epoch interrupted mid-way (preemption checkpoint) is re-run in
        # full — its remaining batches were never trained; per-(epoch, step)
        # seeds and the seeded permutation make the re-run deterministic
        self.start_epoch = epoch + 1 if extra.get("epoch_complete", True) else epoch
        self.global_step = int(extra.get("global_step", 0))
        self.scheduler.best = float(extra.get("sched_best", float("inf")))
        self.scheduler.num_bad = int(extra.get("sched_num_bad", 0))
        self.stopper.best = float(extra.get("stop_best", float("inf")))
        self.stopper.num_bad = int(extra.get("stop_num_bad", 0))
        # a preemption can land at the same epoch boundary where early stop
        # triggered — the preempted break wins the exit, so the stop
        # decision must survive in the checkpoint or resume would train
        # epochs the uninterrupted run never ran
        self.resumed_stopped_early = bool(extra.get("stopped_early", False))
        print(
            f"[trainer] resumed from step {self.ckpt.latest_step} "
            f"(epoch {self.start_epoch}, global_step {self.global_step})"
        )
        return state

    def _log(self, key: str, value: float, step: int):
        if self.logger is not None:
            self.logger.log_metric(self.prefix + key, value, step)

    # --------------------------------------------------------------- loop
    def fit(self, state) -> TrainerResult:
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "the trainer runs one process: the multi-process preemption "
                "vote comes with the parallel port")
        if self.resume:
            state = self.try_resume(state)
        if self.resumed_stopped_early:
            print("[trainer] resumed a run that had already early-stopped; "
                  "nothing to train")
            return TrainerResult(
                state=state,
                best_val_loss=self.stopper.best,
                epochs_run=0,
                stopped_early=True,
                preempted=False,
            )
        # one generator per stream on the parameters' device, reseeded every
        # step from (seed, stream, epoch, step): streams stay independent,
        # and resume reproduces the uninterrupted run's draws without
        # persisting RNG state
        device = _device_of(state.model)
        gen_train = torch.Generator(device=device)
        gen_val = torch.Generator(device=device)
        preempted = False
        stopped_early = False
        epoch = self.start_epoch - 1

        # how many train batches an epoch runs (loader length capped by
        # debug_max_steps). None when the loader is an unsized iterable —
        # then any in-loop break is conservatively treated as mid-epoch.
        try:
            steps_per_epoch = len(self.train_loader)
        except TypeError:
            steps_per_epoch = None
        if self.debug_max_steps is not None:
            steps_per_epoch = (
                self.debug_max_steps if steps_per_epoch is None
                else min(steps_per_epoch, self.debug_max_steps)
            )

        for epoch in range(self.start_epoch, self.epochs):
            # True only when the preemption poll BREAKS the step loop with
            # steps still untrained. A preemption noticed AFTER the epoch's
            # last step (or at the epoch boundary) leaves the epoch fully
            # trained, and marking it incomplete would make resume re-run
            # (and double-apply) its gradient steps.
            mid_epoch = False
            self.train_loader.set_epoch(epoch)
            timer = StepTimer()
            losses = []
            t_epoch = time.time()
            for i, batch in enumerate(self.train_loader):
                if self.debug_max_steps is not None and i >= self.debug_max_steps:
                    break
                timer.start()
                gen_train.manual_seed(step_seed(self.seed, TRAIN_STREAM, epoch, i))
                state, loss = self.train_step(state, batch, gen_train)
                if isinstance(loss, dict):  # e.g. VAE step returns metrics
                    loss = loss["loss"]
                timer.stop()  # no sync: losses are fetched once, below
                losses.append(torch.as_tensor(loss))  # device scalar
                self.global_step += 1
                if (i + 1) % self.log_every_steps == 0:
                    self._log("train_loss_step", float(loss), self.global_step)
                # the preemption poll of the one process: the host-local flag
                if should_terminate():
                    preempted = True
                    # a flag that fires on the epoch's LAST step leaves no
                    # untrained remainder — that epoch is complete, exactly
                    # like an edge-detected preemption
                    mid_epoch = (steps_per_epoch is None
                                 or (i + 1) < steps_per_epoch)
                    break

            if not losses:
                raise RuntimeError(
                    "train loader yielded zero batches — dataset too small "
                    f"for batch_size={self.train_loader.batch_size} with "
                    "drop_last; reduce the batch size or add data"
                )
            train_loss = _mean(losses)
            # the loss fetch above waited for every queued step; stretch the
            # timer to the true dispatch→completion wall so steps/s counts
            # device execution, not just dispatch
            timer.finalize()
            epoch_time = time.time() - t_epoch
            preempted = preempted or should_terminate()

            val_losses = []
            # A MID-epoch preemption spends the bounded SIGUSR1 grace
            # window on the checkpoint, not on a validation pass — resume
            # re-runs that whole epoch anyway, validation included. A
            # preemption that left the epoch FULLY trained runs the
            # validation normally: skipping it would permanently drop that
            # epoch's scheduler/early-stop/best updates (resume continues at
            # epoch+1), diverging the LR and best-checkpoint trajectory from
            # the uninterrupted run.
            val_iter = () if mid_epoch else self.val_loader
            if hasattr(val_iter, "set_epoch"):
                val_iter.set_epoch(epoch)
            # the grace-window validation is wall-clock-capped: a val pass
            # longer than the window would get the job killed BEFORE the
            # checkpoint save below, losing the epoch's training. Under the
            # cap each loss is read as it comes, so the clock sees finished
            # work, not queued work.
            val_deadline = (
                time.perf_counter() + self.preempt_val_budget_s
                if (preempted and not mid_epoch) else None
            )
            val_abandoned = False
            for i, batch in enumerate(val_iter):
                if self.debug_max_steps is not None and i >= self.debug_max_steps:
                    break
                if val_deadline is not None and time.perf_counter() > val_deadline:
                    # a partial mean is biased toward the early batches;
                    # discard so schedulers never act on it
                    val_losses = []
                    val_abandoned = True
                    print("[trainer] preemption grace budget exhausted; "
                          "abandoning validation to checkpoint")
                    break
                gen_val.manual_seed(step_seed(self.seed, VAL_STREAM, epoch, i))
                if self._eval_takes_index:
                    vl = self.eval_step(_params_of(state), batch, gen_val, batch_index=i)
                else:
                    vl = self.eval_step(_params_of(state), batch, gen_val)
                if isinstance(vl, dict):
                    vl = vl["loss"]
                val_losses.append(torch.tensor(float(vl)) if val_deadline is not None
                                  else torch.as_tensor(vl))
            # Validation skipped by the mid-epoch grace window must not
            # drive LR/early-stop/best-checkpoint decisions — a low train
            # loss would overwrite best/ with a never-validated state. A
            # complete epoch's validation ran exactly as the uninterrupted
            # run's would (including the always-empty-val-loader case, where
            # the train-loss fallback is the run's only consistent signal),
            # so its updates are trusted even under preemption — unless the
            # grace budget abandoned it.
            trust_val = not mid_epoch and not val_abandoned
            val_loss = _mean(val_losses) if val_losses else train_loss

            lr = get_learning_rate(state)
            new_lr = self.scheduler.update(val_loss, lr) if trust_val else lr
            if new_lr != lr:
                state = set_learning_rate(state, new_lr)
                print(f"[trainer] plateau: lr {lr:.2e} -> {new_lr:.2e}")

            self._log("train_loss", train_loss, epoch)
            self._log("val_loss", val_loss, epoch)
            self._log("lr", new_lr, epoch)
            self._log("steps_per_s", timer.steps_per_s, epoch)
            self._log("epoch_time_s", epoch_time, epoch)
            mem = device_memory_stats(device)
            self._log("peak_mem_gib", mem["peak_bytes_in_use_gib"], epoch)
            print(
                f"[trainer] epoch {epoch}: train {train_loss:.4f} "
                f"val {val_loss:.4f} ({timer.steps_per_s:.2f} steps/s)"
            )

            stop = self.stopper.update(val_loss) if trust_val else False
            if self.ckpt is not None:
                extra = {
                    "epoch": epoch,
                    # False only when the step loop BROKE mid-epoch: resume
                    # re-runs such an epoch instead of counting its
                    # untrained remainder. An edge-detected preemption keeps
                    # epoch_complete=True so resume continues at epoch+1 and
                    # reproduces the uninterrupted run exactly.
                    "epoch_complete": not mid_epoch,
                    "global_step": self.global_step,
                    "val_loss": val_loss,
                    "sched_best": self.scheduler.best,
                    "sched_num_bad": self.scheduler.num_bad,
                    "stop_best": self.stopper.best,
                    "stop_num_bad": self.stopper.num_bad,
                    # early stop decided at this boundary must survive a
                    # simultaneous preemption (the preempted break exits
                    # first): resume sees it and trains nothing further
                    "stopped_early": bool(stop),
                    **self.checkpoint_extra(),
                }
                self.ckpt.save(
                    self.global_step, state, extra,
                    metrics={"val_loss": val_loss} if trust_val else {},
                )
            if stop:
                # set BEFORE the preempted break: a preemption landing at
                # the same boundary must not mask the stop decision (the
                # checkpoint above already persisted it for resume)
                stopped_early = True
                print(f"[trainer] early stop at epoch {epoch}")
            if preempted:
                print("[trainer] termination requested; stopping cleanly")
                break
            if stop:
                break

        if self.ckpt is not None:
            self.ckpt.wait()
        return TrainerResult(
            state=state,
            best_val_loss=self.stopper.best,
            epochs_run=epoch - self.start_epoch + 1,
            stopped_early=stopped_early,
            preempted=preempted,
        )


def _mean(losses) -> float:
    """Mean of 0-d losses in float64 after ONE transfer to the host: the
    JAX package's ``np.mean`` over the fetched float32 values."""
    return float(np.mean(torch.stack(losses).float().cpu().numpy().astype(np.float64)))


# Validation parameters: the EMA shadow when tracked — best-by-val, plateau
# LR and early stopping judge the weights that sampling and eval will use.
_params_of = inference_params
