"""One rank of a multi-process test of ``mrijax_torch.parallel``.

    python tests/_torch_mp_worker.py CASE RANK WORLD DIR

joins a gloo group of WORLD processes through ``file://DIR/rendezvous``,
reads the case's inputs from ``DIR/in.pt`` (written by the test), runs case
CASE and writes what it found to ``DIR/out<RANK>.pt``. It imports torch,
numpy and ``mrijax_torch`` only; the tests compute the JAX side in their own
process. ``launch`` (used by the tests) starts the WORLD ranks with one
thread each and a time limit of their own, so that a hung rendezvous fails
one test rather than the whole run.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_TIMEOUT_S = 120


def launch(case: str, world: int, directory: Path, inputs: dict, timeout: float = LAUNCH_TIMEOUT_S,
           cwd=None):
    """Run ``case`` on ``world`` fresh processes; returns their outputs by rank.
    Raises with every rank's error output when one fails or the time runs out."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, directory / "in.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_PROCID", "SLURM_NTASKS", "MRIJAX_MULTIHOST"):
        env.pop(var, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1])] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world),
                               str(directory)], cwd=cwd or directory, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"case {case}: ranks did not finish within {timeout} s")
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"case {case}: ranks {failed} failed\n" + "\n".join(
            f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
    return [torch.load(directory / f"out{r}.pt", weights_only=False) for r in range(world)], logs


# ------------------------------------------------------------------- cases


def case_multihost(rank, world, inp, directory):
    """The consensus and broadcast helpers across real processes."""
    from mrijax_torch import parallel

    votes = inp["votes"]   # (scenarios, world) booleans
    out = {"agree": [parallel.all_processes_agree(bool(v[rank])) for v in votes],
           "flagged": [parallel.any_process_flagged(bool(v[rank])) for v in votes],
           "broadcast": [parallel.broadcast_from_host0(float(x[rank])) for x in inp["values"]],
           "mean": parallel.global_mean(float(rank + 1), float(rank + 2)),
           "index": parallel.process_index(), "count": parallel.process_count()}
    parallel.barrier()
    return out


def case_mesh(rank, world, inp, directory):
    """A 2 × 2 ("data", "model") mesh: coordinates, groups and rows."""
    from mrijax_torch.parallel import axis_index, axis_size, local_rows, make_mesh, shard_batch

    mesh = make_mesh(("data", "model"), (2, 2))
    out = {"data": axis_index(mesh, "data"), "model": axis_index(mesh, "model"),
           "sizes": (axis_size(mesh, "data"), axis_size(mesh, "model")),
           "groups": {a: dist.get_process_group_ranks(mesh.get_group(a))
                      for a in ("data", "model")},
           "rows": local_rows(mesh, torch.arange(8)).tolist(),
           "batch": {k: v.tolist() for k, v in
                     shard_batch(mesh, {"x": torch.arange(6), "s": torch.tensor(3)}).items()}}
    try:
        shard_batch(mesh, torch.arange(5))
    except ValueError as e:
        out["error"] = str(e)
    flat = make_mesh(("data",))
    out["flat"] = (axis_size(flat, "data"), axis_index(flat, "data"))
    return out


def _unet2d(inp):
    from mrijax_torch.models import UNet2D

    model = UNet2D(**inp["model_kw"])
    model.load_state_dict(inp["state_dict"])
    return model


def _diffusion(inp):
    from mrijax_torch.diffusion import GaussianDiffusion, make_schedule

    return GaussianDiffusion(make_schedule(inp["betas"]))


def _sgd_state(model, lr):
    from mrijax_torch.train.state import TrainState

    return TrainState(model, torch.optim.SGD(model.parameters(), lr=lr), 0, None)


def case_dp_step(rank, world, inp, directory):
    """Data-parallel 2D train steps under SGD from the global batches and
    draws; then one nan-guarded step where only this rank's rows of one rank
    are non-finite."""
    from mrijax_torch.parallel import make_mesh, shard_batch
    from mrijax_torch.train import make_diffusion_train_step

    mesh = make_mesh(("data",))
    model = _unet2d(inp)
    state = _sgd_state(model, inp["lr"])
    step = make_diffusion_train_step(model, _diffusion(inp), mesh=mesh, nan_guard=True)
    losses = []
    for batch, t, noise in zip(inp["batches"], inp["ts"], inp["noises"]):
        state, loss = step(state, shard_batch(mesh, batch), t=t, noise=noise)
        losses.append(float(loss))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bad = shard_batch(mesh, {k: v.clone() for k, v in inp["batches"][0].items()})
    if rank == world - 1:
        bad["image"][0, 0, 0, 0] = float("nan")
    state, loss = step(state, bad, t=inp["ts"][0], noise=inp["noises"][0])
    unchanged = all(torch.equal(params[k], v) for k, v in model.state_dict().items())
    return {"losses": losses, "params": params, "nan_loss": float(loss),
            "nan_step_skipped": unchanged and state.step == len(inp["batches"])}


def case_fsdp(rank, world, inp, directory):
    """The same Adam + EMA steps replicated and under FSDP; then an FSDP
    checkpoint that rank 0 alone writes."""
    from mrijax_torch.io.checkpoint import CheckpointManager
    from mrijax_torch.parallel import make_mesh, shard_batch, shard_train_state
    from mrijax_torch.train import create_train_state, inference_params, make_diffusion_train_step

    mesh = make_mesh(("data",))
    out = {}
    for tag in ("replicated", "fsdp"):
        model = _unet2d(inp)
        state = create_train_state(model, inp["lr"], ema=True, device="cpu")
        step = make_diffusion_train_step(model, _diffusion(inp), mesh=mesh, ema_decay=0.9)
        if tag == "fsdp":
            state, layout = shard_train_state(mesh, state, min_leaf_elems=inp["min_leaf"])
            out["sharded"] = sorted(leaf.name for leaf in layout.leaves if leaf.dim is not None)
            out["shard_shapes"] = {leaf.name: list(leaf.shard.shape) for leaf in layout.leaves}
        losses = []
        for batch, t, noise in zip(inp["batches"], inp["ts"], inp["noises"]):
            state, loss = step(state, shard_batch(mesh, batch), t=t, noise=noise)
            losses.append(float(loss))
        ema = inference_params(state)
        out[tag] = {"losses": losses,
                    "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                    "ema": {k: v.clone() for k, v in ema.items()}}
        if tag == "fsdp":
            written = []
            mgr = CheckpointManager(directory / "ckpt")
            original = mgr._write
            mgr._write = lambda *a: written.append(a[0]) or original(*a)
            mgr.save(state.step, state, {"epoch": 0}, metrics={"val_loss": 1.0})
            out["written"] = written
            # and it restores into the sharded state of every rank
            state2 = create_train_state(_unet2d(inp), inp["lr"], ema=True, device="cpu")
            state2, _ = shard_train_state(mesh, state2, min_leaf_elems=inp["min_leaf"])
            mgr.restore(state2)
            out["restored_ema_equal"] = all(
                torch.equal(a, b) for a, b in zip(inference_params(state2).values(),
                                                   ema.values()))
    return out


def case_trainer_preempt(rank, world, inp, directory):
    """Two ranks train; SIGUSR1 reaches rank 1 alone at (epoch 0, step 1).
    Both stop at the same consensus step; rank 0 alone writes; then the run
    resumes."""
    from mrijax_torch.io.checkpoint import CheckpointManager
    from mrijax_torch.obs import install_signal_handlers, reset_termination
    from mrijax_torch.parallel import make_mesh, shard_batch
    from mrijax_torch.train import (
        Trainer,
        create_train_state,
        make_diffusion_eval_step,
        make_diffusion_train_step,
    )

    install_signal_handlers()
    mesh = make_mesh(("data",))
    batches = inp["batches"]

    class Loader:
        batch_size = batches[0]["image"].shape[0]

        def __init__(self, items, signal_at=None):
            self.items, self.signal_at, self.epoch = items, signal_at, 0

        def set_epoch(self, epoch):
            self.epoch = epoch

        def __len__(self):
            return len(self.items)

        def __iter__(self):
            for i, b in enumerate(self.items):
                if (self.epoch, i) == self.signal_at and rank == 1:
                    os.kill(os.getpid(), signal.SIGUSR1)
                yield shard_batch(mesh, b)

    def fit(signal_at):
        model = _unet2d(inp)
        state = create_train_state(model, inp["lr"], device="cpu")
        mgr = CheckpointManager(directory / "ckpt")
        writes = []
        original = mgr._write
        mgr._write = lambda *a: writes.append(a[0]) or original(*a)
        trainer = Trainer(train_step=make_diffusion_train_step(model, _diffusion(inp), mesh=mesh),
                          eval_step=make_diffusion_eval_step(model, _diffusion(inp), mesh=mesh),
                          train_loader=Loader(batches, signal_at), val_loader=Loader(batches[:1]),
                          checkpoint_manager=mgr, epochs=2, preempt_sync_every=2, seed=3)
        result = trainer.fit(state)
        reset_termination()
        return result, trainer, writes, model

    first, trainer, writes1, _ = fit((0, 1))
    out = {"preempted": first.preempted, "global_step": trainer.global_step,
           "writes": writes1}
    second, trainer, writes2, model = fit(None)
    out.update(resumed_from=trainer.start_epoch, final_step=trainer.global_step,
               writes_resume=writes2, epochs_run=second.epochs_run,
               params={k: v.detach().clone() for k, v in model.state_dict().items()})
    return out


def case_run_experiment(rank, world, inp, directory):
    """``run_experiment`` on this rank, counting the checkpoint writes and
    metrics loggers it makes (the tests patch Adam to SGD on both sides, so
    that parameters compare at float32 noise)."""
    from mrijax_torch import config
    import mrijax_torch.io.checkpoint as checkpoint_io
    import mrijax_torch.train.state as train_state
    from mrijax_torch.train import experiments

    train_state.make_adam = lambda params, lr: torch.optim.SGD(params, lr=lr)
    writes, loggers = [], []
    write = checkpoint_io.CheckpointManager._write
    checkpoint_io.CheckpointManager._write = (
        lambda self, step, *a: writes.append(step) or write(self, step, *a))
    logger_cls = experiments.MetricsLogger
    experiments.MetricsLogger = lambda *a, **kw: loggers.append(a) or logger_cls(*a, **kw)
    cfg = config.ExperimentConfig.from_dict(inp["config"])
    result = experiments.run_experiment(cfg, device="cpu")
    return {"writes": writes, "loggers": len(loggers), "result": _summary(result)}


def _summary(result):
    if isinstance(result, tuple):
        vae, ldm, scale = result
        return {"vae": _summary(vae), "ldm": _summary(ldm), "latent_scale": scale}
    return {"best_val_loss": result.best_val_loss, "epochs_run": result.epochs_run,
            "params": {k: v.detach().clone() for k, v in result.state.model.state_dict().items()}}


def case_sequence(rank, world, inp, directory):
    """``sequence_parallel_attention`` on a ("data", "model") mesh: output and
    gradients; and, where given, a dp × sp 3D train step under SGD."""
    from mrijax_torch.parallel import make_mesh, sequence_parallel_attention, shard_batch

    mesh = make_mesh(("data", "model"), inp["mesh_shape"])
    out = {}
    if "q" in inp:
        q, k, v = (inp[n].clone().requires_grad_() for n in ("q", "k", "v"))
        o = sequence_parallel_attention(q, k, v, mesh=mesh)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), inp["dout"])
        out.update(out=o.detach(), dq=dq, dk=dk, dv=dv)
    if "unet_kw" in inp:
        from mrijax_torch.models import UNet3D
        from mrijax_torch.train import make_cached_latent_train_step

        unet = UNet3D(**inp["unet_kw"], sp_axis="model", mesh=mesh)
        unet.load_state_dict(inp["unet_state"])
        state = _sgd_state(unet, inp["lr"])
        step = make_cached_latent_train_step(unet, _diffusion(inp), mesh=mesh)
        losses = []
        for batch, t, noise in zip(inp["batches"], inp["ts"], inp["noises"]):
            state, loss = step(state, shard_batch(mesh, batch), None, 1.0, t=t, noise=noise)
            losses.append(float(loss))
        out.update(losses=losses,
                   params={k: v.detach().clone() for k, v in unet.state_dict().items()})
    return out


def case_sharded_sample(rank, world, inp, directory):
    """``sample_2d`` and ``generate_pseudo3d_real_context`` data-parallel;
    ``sharded_sample`` refusing a count the axis does not divide."""
    from mrijax_torch.generate import sample_2d
    from mrijax_torch.models import UNet2D
    from mrijax_torch.parallel import make_mesh, sharded_sample

    mesh = make_mesh(("data",))
    model = _unet2d(inp)
    out = {"grid": sample_2d(model, _diffusion(inp), num_samples=inp["num"],
                             image_size=inp["size"], ddim_steps=inp["steps"], mesh=mesh,
                             seed=inp["seed"], device="cpu")}
    if "ctx_kw" in inp:
        from mrijax_torch.generate import generate_pseudo3d_real_context

        model25 = UNet2D(**inp["ctx_kw"])
        model25.load_state_dict(inp["ctx_state"])
        out["real_context"] = generate_pseudo3d_real_context(
            model25, _diffusion(inp), Slices(inp["slices"]), 0, ddim_steps=inp["steps"],
            mesh=mesh, seed=inp["seed"], device="cpu")
    try:
        sharded_sample(mesh, lambda p, g, n: torch.zeros(n), None, 0, 3, device="cpu")
    except ValueError as e:
        out["error"] = str(e)
    return out


def case_cli(rank, world, inp, directory):
    """``mrijax_torch.cli.main`` of each argv in turn on this rank (the group
    is up already, as under torchrun); what each printed."""
    import contextlib
    import io

    from mrijax_torch import cli

    printed = []
    for argv in inp["argvs"]:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(argv)
        printed.append((rc, text.getvalue()))
    return {"printed": printed}


class Slices:
    """A subject's slices as the 2.5D generators read a dataset: one volume,
    ``slice_tuples`` and items with ``context`` and ``z_pos``."""

    def __init__(self, items):
        self.items = items
        self.volume_paths = ["v0"]
        self.slice_tuples = [("v0", z) for z in range(len(items["z_pos"]))]

    def __getitem__(self, i):
        return {"context": self.items["context"][i].numpy(),
                "z_pos": float(self.items["z_pos"][i]),
                "image": self.items["context"][i][..., :4].numpy()}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def main():
    case, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    from mrijax_torch import parallel

    parallel.initialize(f"file://{directory / 'rendezvous'}", world, rank, required=True,
                        device="cpu")
    inputs = torch.load(directory / "in.pt", weights_only=False)
    np.random.seed(rank)
    out = CASES[case](rank, world, inputs, directory)
    torch.save(out, directory / f"out{rank}.pt")
    parallel.shutdown()


if __name__ == "__main__":
    main()
