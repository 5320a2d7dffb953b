"""Kind ``train_cached_latent_ddp``: ``train_cached_latent`` over ``ranks``
processes, one card each, as a data-parallel mesh
(``make_cached_latent_train_step(..., mesh=make_mesh(("data",)))``).

Rank 0 is the harness's own process; it starts ranks 1 … ranks − 1 as
children (this file run as a script, on card r), which die with it
(``PR_SET_PDEATHSIG``). They meet through a ``tcp://localhost`` rendezvous
(NCCL on the cards, gloo on the CPU) under a timeout of ``TIMEOUT_S``.
Every rank makes the weights and its own pool from the seed and draws the
same global batch of ``batch`` rows from the traffic stream; rank r takes
rows ``r·b … r·b + b − 1`` (b = batch / ranks) and the global batch's t and
noise, which the step cuts to its rows. The step all-reduces the gradients
and the loss, so every rank applies the same update.

Rank 0 decides: before each step it broadcasts one integer (``STEP``), after
the window ``BARRIER`` (a barrier on every rank, so that the window ends
when the last rank's step has), and at release ``STOP``. The children
follow every step rank 0 takes: set-up's first three, the window's, the
traced segment's. The energy is the sum of every card's NVML counter;
``train_samples_per_s`` counts the global batch; the operation counts are
one rank's (batch b), so ``mfu.train`` is a share of one card's peak. The
judge follows rank 0's state against the reference at the global batch.
"""

import argparse
import ctypes
import json
import os
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from mrijax_torch.parallel.mesh import make_mesh
from mrijax_torch.train.steps import make_cached_latent_train_step

from benchmark_h100 import seeding
from benchmark_h100.count import ops
from benchmark_h100.kinds.train_cached_latent import TrainCachedLatent
from benchmark_h100.reference import nets

STEP, BARRIER, STOP = 1, 2, 3
TIMEOUT_S = 60
# the checkout whose packages rank 0 imported; the children import the same
# (through PYTHONPATH)
IMPORT_ROOT = Path(ops.__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In a child before it runs: SIGKILL when the parent exits (Linux)."""
    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainCachedLatentDDP(TrainCachedLatent):
    def __init__(self, config, mix, seed, device, trace=False, energy=None, rank=0,
                 port=None):
        super().__init__(config, mix, seed, device, trace, energy)
        self.rank, self.world = rank, mix["ranks"]
        if mix["batch"] % self.world:
            raise ValueError(f"batch {mix['batch']} does not divide over {self.world} ranks")
        self.local = mix["batch"] // self.world
        self.port, self.children, self.energies = port, [], []

    # ------------------------------------------------------------ processes

    def _spawn(self) -> None:
        if self.device.type == "cuda":
            if torch.cuda.device_count() < self.world:
                raise RuntimeError(f"{self.world} ranks need {self.world} cards, "
                                   f"{torch.cuda.device_count()} found")
            # build the kernels once, before the children would each build them
            from mrijax_torch.kernels import _build
            _build.build_all()
        self.port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(IMPORT_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        if sys.pycache_prefix:
            env["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
        args = [json.dumps(self.config), json.dumps(self.mix), str(self.seed),
                self.device.type, str(self.port)]
        for r in range(1, self.world):
            self.children.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), *args], env=env,
                cwd=str(IMPORT_ROOT), stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno(),
                preexec_fn=_die_with_parent))

    def _join(self) -> None:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{self.port}",
            rank=self.rank, world_size=self.world, timeout=timedelta(seconds=TIMEOUT_S),
            **({"device_id": self.device} if cuda else {}))
        self.mesh = make_mesh(("data",))
        self.flag = torch.zeros(1, dtype=torch.int32, device=self.device)

    def _command(self, cmd: int = 0) -> int:
        """Rank 0 sends ``cmd``; a child receives rank 0's."""
        if self.rank == 0:
            self.flag.fill_(cmd)
        dist.broadcast(self.flag, 0)
        return cmd if self.rank == 0 else int(self.flag.item())

    def _barrier(self) -> None:
        _sync(self.device)
        dist.barrier(**({"device_ids": [self.device.index]} if self.device.type == "cuda"
                        else {}))
        _sync(self.device)

    # ---------------------------------------------------------------- kind

    def setup(self) -> None:
        if self.rank == 0:
            self._spawn()
            if self.energy is not None:
                from benchmark_h100.nvml import Nvml
                self.energies = [self.energy] + [Nvml(r) for r in range(1, self.world)]
        self._join()
        self.mark("process group")
        super().setup()

    def _energy(self):
        if not self.energies:
            return None
        return sum(e.energy_j() for e in self.energies)

    def make_step(self, diffusion):
        self.t_min = self.config["diffusion"]["t_min"]
        return make_cached_latent_train_step(self.net, diffusion, t_min=self.t_min,
                                             nan_guard=self.config["train"]["nan_guard"],
                                             mesh=self.mesh)

    def call(self, b: dict):
        if self.rank == 0:
            self._command(STEP)
        elif self._command() != STEP:
            raise RuntimeError("rank 0 sent no step where set-up takes one")
        return self._step(b)

    def _step(self, b: dict):
        rows = b["idx"][self.rank * self.local:(self.rank + 1) * self.local]
        return self.step_fn(self.state, {"latent": self.pool[rows]}, None, self.latent_scale,
                            t=b["t"], noise=b["noise"])

    def window(self, seconds: float, min_calls: int = 0) -> dict:
        host_s, losses = [], []
        _sync(self.device)
        e0 = self._energy()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(losses) < min_calls:
            b = self.next_batch()
            h0 = time.perf_counter()
            _, loss = self.call(b)
            host_s.append(time.perf_counter() - h0)
            losses.append(loss)
        self._command(BARRIER)
        self._barrier()
        t1 = time.perf_counter()
        e1 = self._energy()
        steps = len(losses)
        failed = 0 if not losses else int((~torch.isfinite(torch.stack(losses))).sum())
        return {"seconds": t1 - t0, "samples": steps * self.batch, "steps": steps,
                "attempted": steps, "failed": failed, "step_host_s": host_s,
                "energy_j": None if e0 is None else e1 - e0}

    def serve(self) -> None:
        """A child's loop: rank 0's commands until ``STOP``."""
        while True:
            cmd = self._command()
            if cmd == STOP:
                return
            if cmd == BARRIER:
                self._barrier()
            else:
                self._step(self.next_batch())

    def release(self) -> None:
        if self.rank == 0:
            self._command(STOP)
        super().release()
        dist.destroy_process_group()
        if self.rank == 0:
            codes = [child.wait(timeout=TIMEOUT_S) for child in self.children]
            if any(codes):
                raise RuntimeError(f"ranks 1-{self.world - 1} exited with {codes}")

    def counts(self) -> dict:
        """One rank's forward: batch / ranks rows."""
        meta = seeding.make_weights(self.net_spec, 0, 0, "meta")
        with ops.counting() as unit:
            nets.unet3d(meta, self.config["unet"],
                        torch.empty((self.local, *self.sample_shape), device="meta"),
                        torch.zeros(self.local, dtype=torch.long, device="meta"))
        return {"forward": unit}


KIND = TrainCachedLatentDDP


def _child(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("config")
    ap.add_argument("mix")
    ap.add_argument("seed", type=int)
    ap.add_argument("device")
    ap.add_argument("port", type=int)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    device = torch.device("cuda", a.rank) if a.device == "cuda" else torch.device("cpu")
    traffic = KIND(json.loads(a.config), json.loads(a.mix), a.seed, device, rank=a.rank,
                   port=a.port)
    traffic.setup()
    traffic.serve()
    traffic.release()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
