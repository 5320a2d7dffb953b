"""Parallelism across processes on ``torch.distributed``: NCCL on the card
(one GPU a process), gloo on the CPU.

Counterpart of ``mrijax/parallel``: ``multihost`` (process-group start-up,
host-scalar agreement), ``mesh`` (named axes over the ranks, this rank's
rows), ``fsdp`` (the fully-sharded train state), ``sampling`` (data-parallel
sampling) and ``sequence`` (sequence-parallel bottleneck attention). The
data-parallel train steps are ``mrijax_torch.train.steps``'s factories with
``mesh=``.
"""

from mrijax_torch.parallel.multihost import (
    all_processes_agree,
    any_process_flagged,
    barrier,
    broadcast_from_host0,
    global_mean,
    initialize,
    is_distributed,
    process_count,
    process_index,
    shutdown,
)
from mrijax_torch.parallel.mesh import (
    all_reduce_mean,
    axis_index,
    axis_size,
    local_rows,
    make_mesh,
    shard_batch,
)
from mrijax_torch.parallel.fsdp import (
    FsdpLayout,
    fsdp_spec,
    shard_train_state,
)
from mrijax_torch.parallel.sampling import shard_generator, sharded_sample
from mrijax_torch.parallel.sequence import sequence_parallel_attention

__all__ = [
    "all_processes_agree", "any_process_flagged", "barrier", "broadcast_from_host0",
    "global_mean", "initialize", "is_distributed", "process_count", "process_index",
    "shutdown", "all_reduce_mean", "axis_index", "axis_size", "local_rows", "make_mesh",
    "shard_batch", "FsdpLayout", "fsdp_spec", "shard_train_state",
    "shard_generator", "sharded_sample", "sequence_parallel_attention",
]
