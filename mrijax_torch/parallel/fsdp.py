"""Fully-sharded (ZeRO-style) train state over the mesh's data axis.

Counterpart of ``mrijax/parallel/fsdp.py``. In the JAX package FSDP is a
layout: every large leaf of the train state gets a sharding along its largest
divisible dimension and XLA inserts the collectives. Here the collectives
are written out, on ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
(one of each per sharded parameter and step):

* ``fsdp_spec`` — the JAX function, ported exactly: the largest dimension
  that the axis size divides is sharded, leaves under ``min_leaf_elems``
  elements (or with no divisible dimension) stay replicated;
* ``shard_train_state`` keeps on each rank only its slice of every sharded
  parameter, of its Adam moments and of its EMA shadow (the optimizer is
  rebuilt over the slices);
* a step of ``mrijax_torch.train.steps`` on such a state reduce-scatters the
  gradients of the sharded parameters into the slices after the backward
  (dividing by the axis size), all-reduces those of the replicated small
  leaves, runs Adam and the EMA on the slices and all-gathers the updated
  slices into the module, so the module holds the full parameters before
  every forward. The step reads the layout from the state
  (``TrainState.fsdp``), so the step of a replicated run is the step of a
  sharded one.

The module's parameters are a gathered working copy, current after every
step, so eval, encoding and saving read them without a collective; gathering
the EMA shadow (``inference_params``) and the Adam moments (a checkpoint) is
a collective that every rank enters. A checkpoint holds full tensors: the
file is the one a replicated run writes, and either restores in the other.
On an axis of size 1 every leaf is replicated and a step is the replicated
step.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mrijax_torch.parallel.mesh import all_reduce_mean, axis_index, axis_size, gather_rows

__all__ = ["fsdp_spec", "FsdpLayout", "shard_train_state"]

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def fsdp_spec(shape, n: int, axis: str = "data", min_leaf_elems: int = 2 ** 15) -> tuple:
    """The JAX ``PartitionSpec`` as a tuple: ``axis`` at the largest
    dimension of ``shape`` that ``n`` divides and ``None`` elsewhere, or
    ``()`` (replicated) for ``n <= 1``, a leaf under ``min_leaf_elems``
    elements, or no divisible dimension."""
    if n <= 1 or int(np.prod(shape or (1,))) < min_leaf_elems:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


@dataclass
class _Leaf:
    name: str
    param: torch.nn.Parameter   # the module's (full) parameter
    dim: Optional[int]          # sharded dimension, None = replicated
    shard: torch.Tensor         # what the optimizer updates: the slice (dim
                                # moved to the front) or, replicated, `param`


class FsdpLayout:
    """Which parameter is sharded along which dimension, and the collectives
    between full tensors and this rank's slices (kept with the sharded
    dimension moved to the front, contiguous)."""

    def __init__(self, mesh, model: torch.nn.Module, axis: str = "data",
                 min_leaf_elems: int = 2 ** 15):
        self.mesh, self.axis = mesh, axis
        self.n = axis_size(mesh, axis)
        self.index = axis_index(mesh, axis)
        self.group = mesh.get_group(axis)
        self.leaves: List[_Leaf] = []
        for name, p in model.named_parameters():
            spec = fsdp_spec(tuple(p.shape), self.n, axis, min_leaf_elems)
            dim = spec.index(axis) if spec else None
            shard = p if dim is None else self.slice(p.detach(), dim)
            self.leaves.append(_Leaf(name, p, dim, shard))

    # --------------------------------------------------------- slicing
    def slice(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        moved = full.movedim(dim, 0)
        per = moved.shape[0] // self.n
        return moved[self.index * per:(self.index + 1) * per].clone(
            memory_format=torch.contiguous_format)

    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_rows(shard, self.group, self.n).movedim(0, dim).contiguous()

    def shards(self) -> Dict[str, torch.Tensor]:
        """What Adam and the EMA act on, by parameter name."""
        return {leaf.name: leaf.shard for leaf in self.leaves}

    # ------------------------------------------------------- the step
    def reduce_gradients(self) -> None:
        """Sharded leaves: reduce-scatter the full gradient into the slice's
        ``.grad`` (÷ n) and drop the full one. Replicated leaves: all-reduce
        (÷ n) in one flat buffer."""
        small = []
        for leaf in self.leaves:
            g = leaf.param.grad
            if g is None:
                continue
            if leaf.dim is None:
                small.append(g)
                continue
            moved = g.movedim(leaf.dim, 0).contiguous()
            out = moved.new_empty((moved.shape[0] // self.n, *moved.shape[1:]))
            _reduce_scatter(out, moved, group=self.group)
            leaf.shard.grad = out.div_(self.n)
            leaf.param.grad = None
        if small:
            all_reduce_mean(small, self.group, self.n)

    @torch.no_grad()
    def gather_parameters(self) -> None:
        """The module's full parameters from the (updated) slices."""
        for leaf in self.leaves:
            if leaf.dim is not None:
                leaf.param.copy_(self.gather(leaf.shard, leaf.dim))

    # ------------------------------------------------ full <-> sharded
    def full_ema(self, ema: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {leaf.name: ema[leaf.name] if leaf.dim is None
                else self.gather(ema[leaf.name], leaf.dim) for leaf in self.leaves}

    def shard_ema(self, ema: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {leaf.name: ema[leaf.name] if leaf.dim is None
                else self.slice(ema[leaf.name], leaf.dim) for leaf in self.leaves}

    def _map_moments(self, sd: dict, fn) -> dict:
        state = {}
        for idx, s in sd["state"].items():
            leaf = self.leaves[int(idx)]
            state[idx] = {k: fn(v, leaf.dim) if (leaf.dim is not None and k != "step")
                          else v for k, v in s.items()}
        return {**sd, "state": state}

    def full_optimizer_state(self, sd: dict) -> dict:
        """An optimizer ``state_dict`` over the slices → the one of the full
        parameters (Adam moments gathered)."""
        return self._map_moments(sd, self.gather)

    def shard_optimizer_state(self, sd: dict) -> dict:
        return self._map_moments(sd, self.slice)

    @torch.no_grad()
    def reshard_parameters(self) -> None:
        """The slices from the module's full parameters (after a restore)."""
        for leaf in self.leaves:
            if leaf.dim is not None:
                leaf.shard.copy_(self.slice(leaf.param.detach(), leaf.dim))


def shard_train_state(mesh, state, axis: str = "data", min_leaf_elems: int = 2 ** 15):
    """Give ``state`` the fully-sharded layout, in place: the optimizer is
    rebuilt over the slices (its moments, if any, sliced), the EMA shadow
    sliced. Returns ``(state, layout)``; the state carries the layout
    (``state.fsdp``) into every train step of ``mrijax_torch.train.steps``."""
    from mrijax_torch.train.state import make_adam

    layout = FsdpLayout(mesh, state.model, axis, min_leaf_elems)
    old = state.optimizer.state_dict()
    state.optimizer = make_adam([leaf.shard for leaf in layout.leaves],
                                old["param_groups"][0]["lr"])
    if old["state"]:
        state.optimizer.load_state_dict(layout.shard_optimizer_state(old))
    if state.ema_params is not None:
        state.ema_params = layout.shard_ema(state.ema_params)
    state.fsdp = layout
    return state, layout
