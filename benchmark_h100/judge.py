"""The numbers that decide ``correct``, each compared with its limit.

Generation (the program's outputs are judged, the reference reads them only
to judge them):

* ``unet_rel_err``: at every checked step, the reference's ε for the
  program's own x_t (the state the program reached) at the reference's own
  timestep and slice positions, against the program's ε; the worst sample's
  ‖ε_program − ε_reference‖ / ‖ε_reference‖.
* ``ddim_rel_err``: the reference's DDIM update of the program's x_t with
  the program's ε, against the x the program went on with; worst sample.
* ``decode_rel_err``: the reference's decode of the program's final latent,
  against the program's volumes; worst volume.

Training (the reference follows the first three steps from the same
weights, batches, timesteps and noise):

* ``loss_gap``: the worst step's |L_program − L_reference| / |L_reference|;
* ``grad_gap``: the first gradient as Adam got it (its first moment after one
  step over 1 − β₁), the worst leaf's |‖g_program‖ − ‖g_reference‖| over the
  larger of ‖g_reference‖ of that leaf and of the median leaf;
* ``grad_diff`` and ``grad_median_diff``: the worst and the median leaf's
  ‖g_program − g_reference‖ in place of the gap of the norms; the worst over
  the leaves of more than one element (a one-element leaf, such as the bias
  of a one-channel output convolution, is one sum over every output of the
  batch, where bfloat16's correlated error survives the cancellation);
* ``update_gap``: the gap of the norms for the change of the parameters over
  the three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move under Adam by round-off
  alone).

A fused q, k, v projection (``*.qkv.*``) counts as three leaves, its q, k
and v rows: the key's bias gets no gradient under the softmax and would
otherwise hide in the leaf. A mix's ``limits`` name the numbers its cells
compare. A number that is not finite fails its limit.
"""

import math
from typing import Dict, Iterable

import torch


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's ‖got − want‖ / ‖want‖ (rows: the first axis)."""
    g = got.detach().double().flatten(1)
    w = want.detach().double().flatten(1).to(g.device)
    num = (g - w).norm(dim=1)
    den = w.norm(dim=1).clamp_min(1e-30)
    return float((num / den).max())


def leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every leaf in float64, a fused q, k, v projection split in three."""
    out = {}
    for k, v in tensors.items():
        v = v.detach().double()
        if ".qkv." in k:
            for part, rows in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}[{part}]"] = rows
        else:
            out[k] = v
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of every leaf."""
    return {k: float(v.norm()) for k, v in leaves(tensors).items()}


def _median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves=None) -> Dict[str, float]:
    """Each leaf's |‖got‖ − ‖want‖| / max(‖want‖, the median leaf's)."""
    keys = list(want) if leaves is None else list(leaves)
    floor = _median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30) for k in keys}


def norm_gap(got: Dict[str, float], want: Dict[str, float], leaves=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, want, leaves).values())


def moved_leaves(grad_ref: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient is at least ``share`` of the median leaf's."""
    floor = share * _median(grad_ref.values())
    return [k for k, v in grad_ref.items() if v >= floor]


def leaf_diffs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's ‖got − want‖ over the larger of ‖want‖ of that leaf and of
    the median leaf."""
    diff = leaf_norms({k: got[k].detach().double() - want[k].detach().double() for k in want})
    norms = leaf_norms(want)
    floor = _median(norms.values())
    return {k: diff[k] / max(norms[k], floor, 1e-30) for k in norms}


def train_numbers(losses_p, losses_r, grad_p: Dict[str, torch.Tensor],
                  grad_r: Dict[str, torch.Tensor], delta_p: Dict[str, float],
                  delta_r: Dict[str, float]) -> Dict[str, float]:
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_p, losses_r)]
    norms_r = leaf_norms(grad_r)
    diffs = leaf_diffs(grad_p, grad_r)
    many = [k for k, v in leaves(grad_r).items() if v.numel() > 1]
    return {"loss_gap": max(loss), "grad_gap": norm_gap(leaf_norms(grad_p), norms_r),
            "grad_diff": max(diffs[k] for k in many),
            "grad_median_diff": _median(diffs.values()),
            "update_gap": norm_gap(delta_p, delta_r, moved_leaves(norms_r))}


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit read, finite and at most its limit."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= limit
               for k, limit in limits.items())
