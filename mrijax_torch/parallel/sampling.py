"""Data-parallel sampling over the mesh's ``data`` axis.

Counterpart of ``mrijax/parallel/sampling.py``. Sampling is embarrassingly
parallel over the batch: rank i of the axis denoises its shard with a
generator made only from ``(seed, i)``, and one all-gather along the batch
puts the global batch on every rank.

Determinism contract (the JAX one, ``tests/test_sharded_sampling.py``): the
global result equals the concatenation of the d single-process runs
``sample_fn(params, shard_generator(seed, i), ...)`` for i = 0..d−1. A
sample archive is reproducible from (seed, shard count) whatever hardware
made it; it depends on the shard count, as the JAX package's does on its
mesh size. ``mesh=None`` is a world of one: shard 0's generator, no
collective.
"""

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from mrijax_torch.parallel.mesh import axis_index, axis_size, gather_rows


def shard_generator(seed: int, shard: int,
                    device: Union[str, torch.device] = "cuda") -> torch.Generator:
    """The generator of shard ``shard``: seeded from
    ``numpy.random.SeedSequence((seed, shard))`` alone, as
    ``evals.harness.call_generator(seed, shard)`` is."""
    state = np.random.SeedSequence((seed, shard)).generate_state(2, np.uint32)
    value = (int(state[0]) << 31) ^ int(state[1])  # 63 bits: a valid manual_seed
    return torch.Generator(device=device).manual_seed(value)


def sharded_sample(
    mesh,
    sample_fn: Callable[..., torch.Tensor],
    params: Any,
    seed: int,
    num_samples: int,
    *,
    cond: Optional[Any] = None,
    axis: str = "data",
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Run a batched sampler data-parallel over ``mesh[axis]``.

    sample_fn:
      * without ``cond``: ``sample_fn(params, generator, local_batch: int)``;
      * with ``cond`` (a tensor, or a tuple of tensors or None, whose leading
        axis is ``num_samples``): ``sample_fn(params, generator, cond_local)``
        with this rank's contiguous shard of every tensor.

    ``generator`` lives on ``device``. Returns the global batch (leading axis
    ``num_samples``) on every rank of the axis.
    """
    d, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if num_samples % d:
        raise ValueError(
            f"num_samples {num_samples} is not divisible by mesh axis "
            f"'{axis}' of size {d}; round up to a multiple of {d} "
            f"(or start fewer processes)")
    local = num_samples // d
    gen = shard_generator(seed, i, device)
    if cond is None:
        out = sample_fn(params, gen, local)
    else:
        def shard(x):   # None stays None, as a pytree leaf would
            return None if x is None else x[i * local:(i + 1) * local]
        cond_local = tuple(map(shard, cond)) if isinstance(cond, tuple) else shard(cond)
        out = sample_fn(params, gen, cond_local)
    return out if d == 1 else gather_rows(out, mesh.get_group(axis), d)
