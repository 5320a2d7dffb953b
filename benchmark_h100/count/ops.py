"""The frozen operation and byte counts of the benchmark.

The rules are those of ``mrijax_torch/bench.py::forward_flops`` (its
``_axis_pairs``, ``_conv_flops`` and ``_layer_flops``), copied here so that
the yardstick does not move with the program:

* a convolution: 2 per multiply-add of every (output position, tap) pair
  whose input position lies inside the input; a transposed one: every
  (input position, tap) pair whose output position lies inside the output;
  1 per output element for the bias;
* a linear layer: 2 per multiply-add, 1 per output element for the bias;
* an attention block: 4·B·N·N·C for the two products over N tokens of C
  channels (4·B·H·N·N·Dh);
* elementwise work (GroupNorm, SiLU, adds, softmax) is not counted as
  operations.

The plain reference (``benchmark_h100.reference``) reports every layer it
runs to the ``Tally`` that ``counting()`` makes active, so a count is that of
the model's own arithmetic, whatever implements it, and nothing recomputed.
Run the reference on the meta device to count without computing.

Besides operations the tally keeps, for the rooflines, the elements of
every GroupNorm+SiLU input and the (B, N, C) of every attention block.
"""

import contextlib
from contextvars import ContextVar
from typing import Iterator, List, Optional, Sequence, Tuple


def axis_pairs(n_in: int, n_out: int, k: int, stride: int, pad: int, dil: int,
               transposed: bool) -> int:
    """Along one axis, the (position, tap) pairs of a convolution that meet
    the input: for a convolution (output, tap) pairs whose input position
    lies inside the input, for a transposed one (input, tap) pairs whose
    output position lies inside the output."""
    if transposed:
        return sum(1 for i in range(n_in) for j in range(k)
                   if 0 <= i * stride - pad + j * dil < n_out)
    return sum(1 for o in range(n_out) for j in range(k)
               if 0 <= o * stride - pad + j * dil < n_in)


def conv_flops(batch: int, sp_in: Sequence[int], sp_out: Sequence[int], c_in: int,
               c_out: int, kernel: int, stride: int, pad: int, transposed: bool,
               bias: bool) -> int:
    pairs = 1
    for n_in, n_out in zip(sp_in, sp_out):
        pairs *= axis_pairs(n_in, n_out, kernel, stride, pad, 1, transposed)
    out_numel = batch * c_out
    for n in sp_out:
        out_numel *= n
    return 2 * batch * pairs * c_in * c_out + (out_numel if bias else 0)


def linear_flops(rows: int, c_in: int, c_out: int, bias: bool) -> int:
    return 2 * rows * c_in * c_out + (rows * c_out if bias else 0)


def attention_flops(batch: int, tokens: int, channels: int) -> int:
    return 4 * batch * tokens * tokens * channels


class Tally:
    """Operations, GroupNorm+SiLU input elements, attention shapes."""

    def __init__(self):
        self.total_flops = 0
        self.gn_silu_elements = 0
        self.attention: List[Tuple[int, int, int]] = []   # (B, N, C) a block


_ACTIVE: ContextVar[Optional[Tally]] = ContextVar("tally", default=None)


@contextlib.contextmanager
def counting() -> Iterator[Tally]:
    """Make a fresh ``Tally`` the one the reference reports to."""
    tally = Tally()
    token = _ACTIVE.set(tally)
    try:
        yield tally
    finally:
        _ACTIVE.reset(token)


def add_conv(x_shape, y_shape, w_shape, stride: int, pad: int, transposed: bool,
             bias: bool) -> None:
    """A channels-first convolution (B, C, *spatial) → (B, C', *spatial')."""
    tally = _ACTIVE.get()
    if tally is None:
        return
    k = w_shape[-1]
    tally.total_flops += conv_flops(x_shape[0], x_shape[2:], y_shape[2:], x_shape[1],
                                    y_shape[1], k, stride, pad, transposed, bias)


def add_linear(rows: int, c_in: int, c_out: int, bias: bool) -> None:
    tally = _ACTIVE.get()
    if tally is not None:
        tally.total_flops += linear_flops(rows, c_in, c_out, bias)


def add_attention(batch: int, tokens: int, channels: int) -> None:
    tally = _ACTIVE.get()
    if tally is not None:
        tally.total_flops += attention_flops(batch, tokens, channels)
        tally.attention.append((batch, tokens, channels))


def add_gn_silu(elements: int) -> None:
    tally = _ACTIVE.get()
    if tally is not None:
        tally.gn_silu_elements += elements
