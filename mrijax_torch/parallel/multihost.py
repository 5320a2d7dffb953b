"""Process-group start-up and host-scalar agreement across processes.

Counterpart of ``mrijax/parallel/multihost.py`` on ``torch.distributed``.
``initialize`` makes the default process group: NCCL when the device is the
card (one GPU a process, chosen by ``LOCAL_RANK`` before the group is made),
gloo when it is the CPU. The rendezvous comes from, in this order, the
explicit arguments (``tcp://host:port``, ``host:port`` or ``file://path``),
torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT``, and SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS`` /
``SLURM_LOCALID`` (with ``MASTER_ADDR`` / ``MASTER_PORT`` for the address).

The semantics are those ``tests/test_multihost.py`` pins for the JAX
package: ``initialize`` is idempotent, a bare single-process run is a no-op,
and a failed or missing rendezvous is loud once ``required`` is set or a
rank, an address or a count above 1 was given — a job that believes it is
one process while others run would train the full data set on every rank
and clobber the shared run directory. Host 0 wins a broadcast; "agree"
means all processes, "flagged" means any. Without a process group (or with
one process) every helper returns its argument.
"""

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

Device = Union[str, torch.device]


def is_distributed() -> bool:
    """True when a process group of more than one process is up."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def collective_device() -> torch.device:
    """Where the default group's tensors live: this process's card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _init_method(address: Optional[str]) -> Optional[str]:
    if address is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        return f"tcp://{host}:{port}" if host and port else None
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               required: bool = False,
               device: Device = "cuda") -> None:
    """Make the default process group, once.

    Missing arguments are taken from torchrun's variables, then SLURM's.
    With no rendezvous found: a no-op for a bare single-process run, an error
    when ``required`` (the caller detected a multi-process job), or when an
    address, a rank or more than one process was asked for. ``device`` picks
    the backend: "cuda" → NCCL, after ``torch.cuda.set_device(LOCAL_RANK)``
    (else the rank modulo the visible cards), so that every "cuda" default of
    the port resolves to this process's card; "cpu" → gloo.
    """
    if dist.is_initialized():
        return
    explicit = (required or coordinator_address is not None or process_id is not None
                or num_processes not in (None, 1))
    rank = process_id if process_id is not None else _env_int("RANK", "SLURM_PROCID")
    world = (num_processes if num_processes is not None
             else _env_int("WORLD_SIZE", "SLURM_NTASKS"))
    init_method = _init_method(coordinator_address)
    if rank is None or world is None or init_method is None:
        missing = [name for name, v in (("process id", rank), ("process count", world),
                                        ("coordinator address", init_method)) if v is None]
        if explicit:
            raise RuntimeError(
                "multi-process start-up asked for, but no " + ", ".join(missing)
                + " was given or found in RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT "
                "(torchrun) or SLURM_PROCID/SLURM_NTASKS")
        print("[multihost] single-process mode (no rendezvous configured)")
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL process group asked for, but "
                               "torch.cuda.is_available() is False; pass device='cpu'")
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID")
        local = rank % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world, device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)


def shutdown() -> None:
    """Destroy the default process group if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def broadcast_from_host0(value: float) -> float:
    """Host 0's scalar on every process, all 64 bits of it (a float64
    broadcast: the best-checkpoint choice compares at Python float
    precision, so a rounding on the wire could split the ranks' branches)."""
    if not is_distributed():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=collective_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def _reduce_flag(flag: bool, op) -> bool:
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=collective_device())
    dist.all_reduce(t, op=op)
    return bool(t.item())


def all_processes_agree(flag: bool) -> bool:
    """True only if EVERY process raised the flag."""
    if not is_distributed():
        return bool(flag)
    return _reduce_flag(flag, dist.ReduceOp.MIN)


def any_process_flagged(flag: bool) -> bool:
    """True if ANY process raised the flag (a SIGUSR1 delivered to one host
    must stop all of them, at the same step)."""
    if not is_distributed():
        return bool(flag)
    return _reduce_flag(flag, dist.ReduceOp.MAX)


def global_mean(total: float, count: float) -> float:
    """Σ total / Σ count over the processes, as one float64 all-reduce of
    ``[total, count]`` (the reference's weighted loss mean, never a mean of
    per-process means)."""
    if not is_distributed():
        return float(total) / float(count)
    t = torch.tensor([float(total), float(count)], dtype=torch.float64,
                     device=collective_device())
    dist.all_reduce(t)
    return float(t[0] / t[1])
