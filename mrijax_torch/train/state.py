"""Train state, plateau LR scheduling, early stopping.

Counterpart of ``mrijax/train/state.py``. The optimizer is
``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8: its update
lr·m̂/(√v̂ + eps) is optax.adam's formula. The learning rate lives in the
optimizer's param group, so the host-side ``PlateauScheduler`` changes it
between epochs without touching anything else.

Precision: the models compute in their ``dtype`` (bf16 on the card) from
parameters held in float32 (``param_dtype=torch.float32``); those master
parameters, their ``.grad``, the Adam moments, the EMA shadow and the losses
are float32, so no loss scaling is needed.

A JAX train state is immutable and every step returns a new one. Here the
model and the optimizer are updated in place, which saves a copy of every
parameter and moment per step; ``TrainState`` is the handle that the step
functions take and give back. Under ``mrijax_torch.parallel.fsdp`` the
optimizer and the EMA shadow hold this rank's slices (``fsdp`` is then the
layout) and the model a gathered copy of the full parameters.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from mrijax_torch._device import require_device


@dataclass
class TrainState:
    """Model, optimizer, number of optimizer updates applied, the optional
    EMA shadow of the model's parameters (by parameter name), and the FSDP
    layout where the state is sharded (``parallel.fsdp.shard_train_state``)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    fsdp: Optional[object] = None


def make_adam(params, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(
    model: torch.nn.Module, learning_rate: float, *, ema: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> TrainState:
    """Move ``model`` to ``device`` and bind a fresh Adam to its parameters.
    With ``ema`` the shadow starts as a distinct copy of the parameters."""
    model = model.to(require_device(device))
    shadow = None
    if ema:
        shadow = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model, make_adam(model.parameters(), learning_rate), 0, shadow)


def optimized_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The tensors the optimizer updates, by parameter name: the model's
    parameters, or this rank's slices of them under FSDP."""
    if state.fsdp is not None:
        return state.fsdp.shards()
    return dict(state.model.named_parameters())


@torch.no_grad()
def ema_update(state: TrainState, decay: float) -> TrainState:
    """shadow ← decay·shadow + (1−decay)·params, in place; a state without a
    shadow is left as it is."""
    if state.ema_params is None:
        return state
    params = optimized_params(state)
    shadow = list(state.ema_params.values())
    current = [params[name].detach().to(e.dtype)
               for name, e in state.ema_params.items()]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, current, alpha=1.0 - decay)
    return state


def inference_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The parameters to sample or evaluate with, by name: the EMA shadow when
    tracked, else the model's own. ``torch.func.functional_call(model, params,
    args)`` runs the model on them. Under FSDP the shadow's slices are
    gathered: every rank of the data axis must call this together."""
    if state.ema_params is not None:
        if state.fsdp is not None:
            return state.fsdp.full_ema(state.ema_params)
        return state.ema_params
    return {name: p.detach() for name, p in state.model.named_parameters()}


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


@dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode=min): factor 0.5, patience 3."""

    factor: float = 0.5
    patience: int = 3
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad: int = 0

    def update(self, val_loss: float, lr: float) -> float:
        if val_loss < self.best:
            self.best = val_loss
            self.num_bad = 0
            return lr
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr


@dataclass
class EarlyStopper:
    """Early stopping on validation loss, patience 4."""

    patience: int = 4
    best: float = float("inf")
    num_bad: int = 0
    improved: bool = False

    def update(self, val_loss: float) -> bool:
        """Returns True when training should stop."""
        self.improved = val_loss < self.best
        if self.improved:
            self.best = val_loss
            self.num_bad = 0
            return False
        self.num_bad += 1
        return self.num_bad >= self.patience
