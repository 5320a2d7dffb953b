"""Checkpointing with full train-state resume, and a portable weight export.

Counterpart of ``mrijax/io/checkpoint.py``. A checkpoint is the full training
snapshot, written with ``torch.save``:

* ``model``     — the model's ``state_dict`` (float32 master parameters),
* ``optimizer`` — the optimizer's ``state_dict`` (Adam moments, step counts
  and the learning rate, which the plateau scheduler lowers),
* ``ema``       — the EMA shadow by parameter name, or ``None``,
* ``step``      — the number of optimizer updates applied,
* ``extra``     — host-side scalars (epoch, best val loss, early-stop and
  plateau counters, latent scale), so a preempted run continues exactly where
  it stopped.

Policies, as in the JAX package: keep the last ``max_to_keep`` steps (for
resume) and, apart from them, the single best-by-``best_key`` step in
``best/``, tracked in ``best.json`` (written atomically; a truncated file reads
as "no record"). Every file is written under a temporary name and renamed into
place, so a save killed midway is never what ``latest_step`` returns. Saves
are synchronous: ``wait`` and ``close`` have nothing to wait for.

Across processes every rank calls ``save`` (a sharded state gathers its full
tensors there, a collective), rank 0 alone writes, and the others wait at a
barrier behind the write, so the next ``latest_step`` or ``restore`` sees the
file on every rank. Whether a save is the new best is rank 0's view of
``best.json``, broadcast before anyone branches. The file does not depend on
the process count or on FSDP: a checkpoint of a d-process run restores in one
process and the other way round.

``save_params_npz`` / ``load_params_npz`` keep the JAX package's npz layout
(``arr_i`` plus a ``__keys__`` JSON entry), so weights exported by either
package load in the other (the flax tree then goes through
``mrijax_torch.io.flax_convert``).
"""

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from mrijax_torch.parallel.multihost import barrier, broadcast_from_host0, process_index
from mrijax_torch.train.steps import _device_of

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _payload(state) -> Dict[str, Any]:
    """What a checkpoint holds of a ``TrainState``: model, optimizer, EMA
    shadow and step — full tensors, gathered under FSDP."""
    optimizer, ema = state.optimizer.state_dict(), state.ema_params
    if state.fsdp is not None:
        optimizer = state.fsdp.full_optimizer_state(optimizer)
        ema = None if ema is None else state.fsdp.full_ema(ema)
    return {
        "model": state.model.state_dict(),
        "optimizer": optimizer,
        "ema": ema,
        "step": int(state.step),
    }


@torch.no_grad()
def load_state(state, payload: Mapping[str, Any]):
    """Load a checkpoint's payload (``restore_host``'s, or ``torch.load``'s)
    into ``state`` in place: every tensor is copied onto the device and into
    the dtype of the one it replaces; a sharded state takes its slices.
    Returns ``state``."""
    if (payload["ema"] is None) != (state.ema_params is None):
        raise ValueError("the checkpoint and the train state disagree on whether "
                         "an EMA shadow is tracked")
    layout = state.fsdp
    state.model.load_state_dict(payload["model"])
    optimizer, ema = payload["optimizer"], payload["ema"]
    if layout is not None:
        layout.reshard_parameters()
        optimizer = layout.shard_optimizer_state(optimizer)
    state.optimizer.load_state_dict(optimizer)
    if state.ema_params is not None:
        if ema.keys() != state.ema_params.keys():
            raise ValueError("the checkpoint's EMA shadow has other parameters "
                             "than the train state's")
        if layout is not None:
            ema = layout.shard_ema({k: v.to(state.ema_params[k].device) for k, v in ema.items()})
        for name, shadow in state.ema_params.items():
            shadow.copy_(ema[name])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    """(state, extra) checkpoints with two retention policies at once:

    * ``<dir>/<step>.pt``      — the last ``max_to_keep`` steps (for resume),
    * ``<dir>/best/<step>.pt`` — the single best-by-``best_key`` step (for
      inference and eval), tracked in ``<dir>/best.json``.
    """

    def __init__(
        self,
        directory,
        *,
        max_to_keep: int = 3,
        best_key: Optional[str] = "val_loss",
    ):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_key = best_key

    @staticmethod
    def _steps(base: Path) -> List[int]:
        """Finished checkpoints under ``base``, oldest first; temporary files
        of a save that did not finish are not among them."""
        if not base.is_dir():
            return []
        return sorted(int(m.group(1)) for p in base.iterdir()
                      if (m := _STEP_FILE.match(p.name)))

    def _best_record(self) -> dict:
        p = self.directory / "best.json"
        if p.exists():
            try:
                return json.loads(p.read_text())
            except json.JSONDecodeError:
                # a crash of an older writer may have left a truncated file;
                # treat as "no record" rather than poisoning every later save
                return {}
        return {}

    def save(self, step: int, state, extra: Optional[dict] = None,
             metrics: Optional[dict] = None):
        """Every rank calls it; rank 0 writes, the others wait for the write."""
        payload = {**_payload(state), "extra": _jsonify(extra or {})}
        if process_index() == 0:
            self._write(step, payload, metrics or {})
        else:
            # rank 0 decides on best.json; the broadcast pairs with its own
            self._is_best(metrics or {})
        barrier()

    def _is_best(self, metrics: dict) -> Optional[float]:
        """The metric if this save is the new best, on rank 0's view of
        ``best.json`` (broadcast, so every rank agrees), else None."""
        if not (self.best_key and self.best_key in metrics):
            return None
        val = float(metrics[self.best_key])
        prev = broadcast_from_host0(self._best_record().get("value", float("inf"))
                                    if process_index() == 0 else 0.0)
        return val if val < prev else None

    def _write(self, step: int, payload: dict, metrics: dict):
        path = self.directory / f"{step}.pt"
        tmp = path.with_name(path.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self._steps(self.directory)[:-self.max_to_keep]:
            (self.directory / f"{old}.pt").unlink()
        val = self._is_best(metrics)
        if val is not None:
            best = self.directory / "best"
            best.mkdir(exist_ok=True)
            target = best / f"{step}.pt"
            tmp = target.with_name(target.name + ".tmp")
            shutil.copyfile(path, tmp)
            os.replace(tmp, target)
            for old in self._steps(best):
                if old != step:
                    (best / f"{old}.pt").unlink()
            record = self.directory / "best.json"
            tmp = record.with_suffix(".json.tmp")
            tmp.write_text(json.dumps({"step": step, "value": val}))
            os.replace(tmp, record)

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps(self.directory)
        return steps[-1] if steps else None

    @property
    def best_step(self) -> Optional[int]:
        return self._best_record().get("step")

    def _path(self, step: Optional[int], best: bool) -> Path:
        if best and not self.best_key:
            raise ValueError("no best-checkpoint tracking configured")
        base = self.directory / "best" if best else self.directory
        if step is None:
            steps = self._steps(base)
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {base}")
            step = steps[-1]
        return base / f"{step}.pt"

    def restore(self, state, step: Optional[int] = None, *, best: bool = False):
        """Restore the latest (or ``step``'s, or with ``best=True`` the
        best-by-val) checkpoint into ``state`` in place, onto the device of
        its parameters. Returns ``(state, extra)``."""
        payload = torch.load(self._path(step, best), map_location=_device_of(state.model),
                             weights_only=True)
        return load_state(state, payload), payload["extra"]

    def restore_host(self, step: Optional[int] = None, *, best: bool = False):
        """``(payload, extra)`` with every tensor on the CPU
        (``map_location="cpu"``), whatever device the run trained on: for
        inspection, eval and moving a run to other hardware. ``payload``
        holds ``model``, ``optimizer``, ``ema`` and ``step``;
        ``load_state`` puts it into a train state."""
        payload = torch.load(self._path(step, best), map_location="cpu",
                             weights_only=True)
        extra = payload.pop("extra")
        return payload, extra

    def close(self):
        """Nothing is held open between saves."""


def _jsonify(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.floating, np.integer)):
            v = v.item()
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            v = v.tolist()
        out[k] = v
    return out


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a tree of nested mappings, keys sorted at every
    level: the order of ``jax.tree_util.tree_flatten_with_path`` on dicts."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def save_params_npz(path, params: Mapping, meta: Optional[dict] = None) -> None:
    """Portable single-file weight export: a tree of nested mappings (a flax
    parameter tree as numpy arrays, or a flat ``state_dict``) → npz, with the
    key paths (joined by ``/``) and an optional model config in a JSON entry."""
    arrays = {}
    keys = []
    for i, (kpath, leaf) in enumerate(_flatten(params)):
        keys.append("/".join(kpath))
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arrays[f"arr_{i}"] = np.asarray(leaf)
    arrays["__keys__"] = np.asarray(json.dumps({"keys": keys, "meta": meta or {}}))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_params_npz(path):
    """Returns (params_as_nested_dict, meta)."""
    with np.load(path, allow_pickle=False) as z:
        info = json.loads(str(z["__keys__"]))
        leaves = [z[f"arr_{i}"] for i in range(len(info["keys"]))]
    params: dict = {}
    for name, leaf in zip(info["keys"], leaves):
        node = params
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return params, info["meta"]
