"""Sequence-parallel attention over the mesh's ``model`` axis.

Counterpart of ``mrijax/parallel/sequence.py``. The bottleneck attention's
token axis (N = D·H·W) is split over the ``model`` axis: each of its d ranks
computes N/d query rows against all N keys, so the quadratic work divides by
d while everything around the attention stays data parallel.

Layout contract (the JAX module's): activations enter and leave batch-split
over ``data`` and REPLICATED over ``model`` — the ranks of a ``model`` group
hold the same rows, run the same convolutions and get the same gradients;
nothing is scaled by the size of either axis. Each rank

* forward: takes its chunk of q, runs ``flash_attn_fwd`` on (N/d × N) and
  all-gathers the output chunks along N over ``model``;
* backward: runs ``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq`` on its
  chunk (with the chunk's lse and Δ), all-gathers the dQ chunks and sums
  dK and dV over ``model``.

The kernels take q of N/d rows against k, v of N rows (``Nk ≠ N``); on the
CPU their plain versions run, as everywhere in the port.
"""

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.parallel.mesh import axis_index, axis_size, gather_rows


def _gather_tokens(chunk: torch.Tensor, d: int, group) -> torch.Tensor:
    """(B, N/d, H, Dh) chunks of the group's ranks → (B, N, H, Dh), in rank
    order."""
    b, c, h, dh = chunk.shape
    out = gather_rows(chunk, group, d)
    return out.view(d, b, c, h, dh).permute(1, 0, 2, 3, 4).reshape(b, d * c, h, dh)


class _SequenceParallelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis):
        d, i = axis_size(mesh, axis), axis_index(mesh, axis)
        n = q.shape[1]
        if n % d:
            raise ValueError(f"token axis {n} not divisible by mesh axis {axis}={d}")
        c = n // d
        group = mesh.get_group(axis)  # of size 1 too: never the whole world
        q_chunk = q[:, i * c:(i + 1) * c]
        out_chunk, lse = fa.flash_attention_forward(q_chunk, k, v)
        ctx.save_for_backward(q_chunk, k, v, out_chunk, lse)
        ctx.chunk, ctx.index, ctx.d, ctx.group = c, i, d, group
        return _gather_tokens(out_chunk, d, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q_chunk, k, v, out_chunk, lse = ctx.saved_tensors
        c, i, d, group = ctx.chunk, ctx.index, ctx.d, ctx.group
        dq_chunk, dk, dv = fa.flash_attention_backward(
            q_chunk, k, v, out_chunk, lse, dout[:, i * c:(i + 1) * c])
        dq = _gather_tokens(dq_chunk, d, group)
        dist.all_reduce(dk, group=group)
        dist.all_reduce(dv, group=group)
        return dq, dk, dv, None, None


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                mesh, axis: str = "model") -> torch.Tensor:
    """Multi-head attention with the token-axis work split over ``axis``.

    q, k, v: (B, N, H, Dh), this rank's rows of the batch (the loader split
    them over ``data``, so, unlike the JAX function, this one takes no batch
    axis) and the same on every rank of ``axis``. Returns (B, N, H, Dh) in
    the same layout. N must be divisible by the ``axis`` size.
    Differentiable.
    """
    return _SequenceParallelAttention.apply(q, k, v, mesh, axis)
