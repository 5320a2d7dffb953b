"""``mrijax_torch.parallel.multihost`` and ``.mesh``, and the loader's
per-process rows, against the semantics the JAX package pins
(``tests/test_multihost.py``, ``mrijax/data/loader.py``).

The multi-process cases run real gloo groups of fresh processes
(``tests/_torch_mp_worker.py``, ``file://`` rendezvous under ``tmp_path``);
the single-process and loader cases run here.
"""

import argparse

import numpy as np
import pytest
import torch

import jax

from _torch_mp_worker import launch
from mrijax.data import loader as jloader
from mrijax_torch import cli, parallel
from mrijax_torch.data import loader
from mrijax_torch.parallel import multihost

RENDEZVOUS_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                   "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "MRIJAX_MULTIHOST")


@pytest.fixture
def no_cluster(monkeypatch):
    for var in RENDEZVOUS_VARS:
        monkeypatch.delenv(var, raising=False)


def test_single_process_is_a_noop_and_passes_values_through(no_cluster):
    multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.broadcast_from_host0(3.25) == 3.25
    assert multihost.all_processes_agree(True) is True
    assert multihost.all_processes_agree(False) is False
    assert multihost.any_process_flagged(True) is True
    assert multihost.any_process_flagged(False) is False
    assert multihost.global_mean(3.0, 4.0) == 0.75
    multihost.barrier()


def test_a_requested_rendezvous_that_is_missing_is_loud(no_cluster, monkeypatch):
    """Any explicit rendezvous argument, or ``required`` (a job detected from
    the environment), makes a missing rendezvous an error; an explicit single
    process and a bare run stay quiet — the semantics of the JAX package's
    ``initialize``."""
    for kwargs in (dict(coordinator_address="10.0.0.1:1234"), dict(process_id=1),
                   dict(num_processes=4), dict(required=True)):
        with pytest.raises(RuntimeError, match="multi-process start-up"):
            multihost.initialize(device="cpu", **kwargs)
    multihost.initialize(num_processes=1, device="cpu")
    multihost.initialize(device="cpu")
    # SLURM names the count and the rank but not the address
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "2")
    with pytest.raises(RuntimeError, match="coordinator address"):
        multihost.initialize(required=True, device="cpu")
    assert not torch.distributed.is_initialized()


def test_cli_multihost_mode_predicate(no_cluster, monkeypatch):
    """The one predicate that gates the rendezvous and rank 0's writes
    (``tests/test_multihost.py::test_cli_multihost_mode_predicate``)."""

    def ns(**kw):
        return argparse.Namespace(**{**dict(coordinator=None, num_processes=None,
                                            process_id=None), **kw})

    assert cli._multihost_mode(ns()) is False
    assert cli._multihost_mode(ns(coordinator="h:1")) is True
    assert cli._multihost_mode(ns(num_processes=2)) is True
    assert cli._multihost_mode(ns(process_id=0)) is True
    assert cli._multihost_mode(ns(num_processes=1)) is False
    monkeypatch.setenv("MRIJAX_MULTIHOST", "1")
    assert cli._multihost_mode(ns()) is True
    monkeypatch.delenv("MRIJAX_MULTIHOST")
    for var in ("SLURM_NTASKS", "WORLD_SIZE"):   # SLURM, torchrun
        for value, want in (("4", True), ("1", False), ("not-a-number", False)):
            monkeypatch.setenv(var, value)
            assert cli._multihost_mode(ns()) is want
        monkeypatch.delenv(var)


VOTES = [[True, True], [True, False], [False, False], [False, True]]


def test_consensus_and_broadcast_across_two_processes(tmp_path):
    """Two gloo processes: agree = all, flagged = any, host 0's value wins the
    broadcast with all 64 bits (a sub-float32 difference survives), and the
    weighted mean is Σ total / Σ count."""
    probe = 1.0 + 2.0 ** -40
    outs, _ = launch("multihost", 2, tmp_path, {
        "votes": VOTES, "values": [[probe, 123.0], [7.5, -1.0]]})
    for rank, out in enumerate(outs):
        assert (out["index"], out["count"]) == (rank, 2)
        assert out["agree"] == [all(v) for v in VOTES]
        assert out["flagged"] == [any(v) for v in VOTES]
        assert out["broadcast"] == [probe, 7.5]
        assert out["broadcast"][0] != float(np.float32(probe))
        assert out["mean"] == (1.0 + 2.0) / (2.0 + 3.0)


def test_mesh_groups_rows_and_divisibility(tmp_path):
    """A 2 × 2 ("data", "model") mesh on 4 processes: rank r sits at
    (r // 2, r % 2); the ``model`` group of a rank holds the ranks of its
    data row; rows follow the data index; the divisibility message is the
    JAX one's, on the global batch."""
    outs, _ = launch("mesh", 4, tmp_path, {})
    for rank, out in enumerate(outs):
        i, j = rank // 2, rank % 2
        assert (out["data"], out["model"], out["sizes"]) == (i, j, (2, 2))
        assert out["groups"]["model"] == [2 * i, 2 * i + 1]
        assert out["groups"]["data"] == [j, 2 + j]
        assert out["rows"] == list(range(4 * i, 4 * i + 4))
        assert out["batch"] == {"x": list(range(3 * i, 3 * i + 3)), "s": 3}
        assert "global batch dim 5 is not divisible by mesh axis 'data' of size 2" in out["error"]
        assert out["flat"] == (4, rank)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((1,), i, np.int64)}


@pytest.mark.parametrize("count,n,batch,drop_last", [
    (2, 10, 4, False), (2, 10, 4, True), (4, 11, 8, False), (3, 7, 6, False)])
def test_loader_rows_match_the_jax_loader(monkeypatch, count, n, batch, drop_last):
    """Every process's rows of every batch, the trimmed ragged tail and
    ``len`` — against the JAX ``BatchLoader``'s ``_global_batches`` and
    ``_local_rows`` under the same patched process count and index."""
    data = _Items(n)
    for index in range(count):
        monkeypatch.setattr(jax, "process_count", lambda: count)
        monkeypatch.setattr(jax, "process_index", lambda: index)
        monkeypatch.setattr(loader, "process_count", lambda: count)
        monkeypatch.setattr(loader, "process_index", lambda: index)
        jl = jloader.BatchLoader(data, batch, shuffle=True, drop_last=drop_last, seed=5,
                                 device_put=False, prefetch=0)
        pl = loader.BatchLoader(data, batch, shuffle=True, drop_last=drop_last, seed=5,
                                device_put=False, prefetch=0)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want = [jl._local_rows(c).tolist() for c in jl._global_batches()]
            got = [b["x"][:, 0].tolist() for b in pl]
            assert got == want and len(pl) == len(jl) == len(want)
    monkeypatch.setattr(loader, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="not divisible by the 3 processes"):
        loader.BatchLoader(data, 4, device_put=False)
    # shard=False: every process loads the whole batch
    assert len(loader.BatchLoader(data, 4, device_put=False, shard=False)._local_rows(
        np.arange(4))) == 4


def test_parallel_exports():
    for name in ("initialize", "make_mesh", "shard_batch", "fsdp_spec", "shard_train_state",
                 "sharded_sample", "sequence_parallel_attention",
                 "broadcast_from_host0", "all_processes_agree", "any_process_flagged"):
        assert callable(getattr(parallel, name))
