"""Entry points of the port: the flagship forward and a multi-device dry run.

Counterpart of ``__graft_entry__.py``:

* ``entry(device="cuda")`` returns ``(fn, (params, latent, t))``: the
  flagship latent-diffusion ``UNet3D`` (16 latent channels, base 128, mults
  (1, 2, 4), bottleneck attention with 4 heads of 128, bf16 compute, float32
  parameters, flash attention) at the flagship latent (1, 32, 40, 40, 16) of
  ``ddpm_3d_ldm``. ``fn(params, latent, t)`` runs the forward through
  ``torch.func.functional_call`` with the weights as an argument, as the JAX
  ``fn`` takes its parameter tree. One call launches ``gn_silu_stats`` and
  ``gn_silu_apply`` 29 times each and ``flash_attn_fwd`` once.
* ``dryrun_multichip(n, device="cuda")`` runs one full two-stage training
  step and the rest of the JAX dry run on ``n`` processes (NCCL, one card
  each, or gloo on the CPU) and checks every rank against a run on one
  device in its own process.

    python -m mrijax_torch.graft_entry                  # every visible card
    python -m mrijax_torch.graft_entry --device cpu -n 8  # the JAX self-test

Weights come from an explicit seed (default 0), drawn by the modules' own
initialisers on the CPU and then moved, so a seed gives the same weights on
every device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch
from torch.func import functional_call

from mrijax_torch._device import require_device

Device = Union[str, torch.device]

FLAGSHIP_UNET = dict(in_channels=16, base_channels=128, channel_mults=(1, 2, 4),
                     use_attention=True, num_heads=4)
FLAGSHIP_LATENT = (1, 32, 40, 40, 16)   # (B, D, H, W, C) of a 128×160×160 patch
RANK_TIMEOUT_S = 600                    # a rank that runs longer has hung


def _seeded(build, seed: int) -> torch.nn.Module:
    """``build()`` with its parameters drawn from a torch RNG seeded with
    ``seed``; the caller's RNG state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def entry(device: Device = "cuda", seed: int = 0):
    """``(fn, (params, latent, t))``: the flagship UNet3D forward with the
    weights as its first argument, on ``device`` (which must exist: no move
    to the CPU unasked). ``params`` maps parameter names to tensors, as
    ``model.named_parameters()`` names them; ``latent`` is bf16 zeros of
    ``FLAGSHIP_LATENT`` and ``t`` int64 zeros of shape (1,)."""
    from mrijax_torch.models import UNet3D

    dev = require_device(device)
    model = _seeded(lambda: UNet3D(**FLAGSHIP_UNET, use_flash_attention=True,
                                   dtype=torch.bfloat16, param_dtype=torch.float32), seed)
    model = model.to(dev).eval()
    params = {name: p.detach() for name, p in model.named_parameters()}
    latent = torch.zeros(FLAGSHIP_LATENT, dtype=torch.bfloat16, device=dev)
    t = torch.zeros((1,), dtype=torch.int64, device=dev)

    def fn(params: Dict[str, torch.Tensor], latent: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
        return functional_call(model, params, (latent, t))

    return fn, (params, latent, t)


# ------------------------------------------------------------------ dry run


def _check(ok: bool, message: str) -> None:
    """The dry run's checks: an ``AssertionError`` that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(message)


def _rel_l2(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    num = den = 0.0
    for name, b in want.items():
        a = got[name].detach().double().cpu()
        b = b.detach().double().cpu()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def _params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def _dryrun_rank(rank: int, world: int, device: str, directory: Path) -> dict:
    """One rank of ``dryrun_multichip``: the JAX dry run's checks, each
    against the same computation on this process's device without a mesh.
    Raises on the first miss; returns what it measured."""
    from mrijax_torch import parallel
    from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
    from mrijax_torch.models import UNet3D, VAE3D
    from mrijax_torch.parallel import make_mesh, shard_batch, shard_generator, sharded_sample
    from mrijax_torch.train import (
        create_train_state,
        make_cached_latent_train_step,
        make_latent_diffusion_train_step,
    )

    # float32 comparisons stay float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(f"file://{directory / 'rendezvous'}", world, rank, required=True,
                        device=device)
    dev = require_device(device)
    sp = 2 if world % 2 == 0 and world >= 4 else 1
    dp = world // sp
    mesh = make_mesh(("data", "model"), (dp, sp))

    # the JAX dry run's tiny two-stage config: 4-modality volumes → VAE
    # latents → diffusion UNet
    vae = _seeded(lambda: VAE3D(in_channels=4, base_channels=8, num_down=2,
                                latent_channels=4), 1).to(dev)
    unet_kw = dict(in_channels=4, base_channels=8, channel_mults=(1, 2), use_attention=True,
                   use_flash_attention=False, num_heads=2, time_emb_dim=16)
    initial = _seeded(lambda: UNet3D(**unet_kw), 0).state_dict()

    def unet(sharded: bool) -> torch.nn.Module:
        """The UNet from the initial weights; ``sharded``: its attention
        sequence-parallel over the ``model`` axis where that has 2 ranks."""
        kw = dict(sp_axis="model", mesh=mesh) if sharded and sp > 1 else {}
        model = UNet3D(**unet_kw, **kw)
        model.load_state_dict(initial)
        return model

    diffusion = GaussianDiffusion(make_schedule(cosine_beta_schedule(10)), loss_type="min_snr")
    rng = np.random.default_rng(0)
    out = {"mesh": [dp, sp]}

    # three stage-2 steps from volumes, data × sequence parallel, against the
    # same steps on one device: loss and parameters after EVERY step (a
    # divergence compounds through Adam's moments)
    state = create_train_state(unet(True), 1e-4, device=dev)
    state1 = create_train_state(unet(False), 1e-4, device=dev)
    step = make_latent_diffusion_train_step(state.model, vae, diffusion, mesh=mesh)
    step1 = make_latent_diffusion_train_step(state1.model, vae, diffusion)
    out["losses"], out["losses_one_device"], out["rel_l2"] = [], [], []
    for i in range(3):
        batch = {"volume": torch.from_numpy(
            rng.normal(size=(dp, 16, 16, 16, 4)).astype(np.float32))}
        state, loss = step(state, shard_batch(mesh, batch),
                           torch.Generator(device=dev).manual_seed(2 + i), 1.0)
        state1, loss1 = step1(state1, batch, torch.Generator(device=dev).manual_seed(2 + i), 1.0)
        loss, loss1 = float(loss), float(loss1)
        _check(bool(np.isfinite(loss)), f"non-finite loss {loss} at step {i}")
        _check(abs(loss - loss1) < 1e-5,
               f"step {i}: multi-device loss {loss} != single-device {loss1}")
        rel = _rel_l2(_params(state.model), _params(state1.model))
        _check(rel < 5e-5, f"step {i}: param drift vs single-device: rel L2 {rel:.2e}")
        out["losses"].append(loss)
        out["losses_one_device"].append(loss1)
        out["rel_l2"].append(rel)
    trained = _params(state1.model)
    del state, step, step1

    # the shipped stage-2 path: one cached-latent step
    lat_batch = {"latent": torch.from_numpy(
        rng.normal(size=(dp, 8, 8, 8, 4)).astype(np.float32))}
    cs = create_train_state(unet(True), 1e-4, device=dev)
    cs1 = create_train_state(unet(False), 1e-4, device=dev)
    cs, closs = make_cached_latent_train_step(cs.model, diffusion, mesh=mesh)(
        cs, shard_batch(mesh, lat_batch), torch.Generator(device=dev).manual_seed(11), 1.3)
    cs1, closs1 = make_cached_latent_train_step(cs1.model, diffusion)(
        cs1, lat_batch, torch.Generator(device=dev).manual_seed(11), 1.3)
    closs, closs1 = float(closs), float(closs1)
    _check(abs(closs - closs1) < 1e-5, f"cached-latent loss {closs} != single-device {closs1}")
    crel = _rel_l2(_params(cs.model), _params(cs1.model))
    _check(crel < 1e-5, f"cached-latent param drift: rel L2 {crel:.2e}")
    out.update(cached_loss=closs, cached_loss_one_device=closs1, cached_rel_l2=crel)
    del cs

    # the same cached-latent step with the state fully sharded over "data"
    fstate, layout = parallel.shard_train_state(
        mesh, create_train_state(unet(True), 1e-4, device=dev), min_leaf_elems=256)
    big = max(layout.leaves, key=lambda leaf: leaf.param.numel())

    def expect_layout(when: str) -> None:
        """The largest leaf is sharded along a dimension the data axis
        divides, and the optimizer holds the slice (with one rank on the
        axis, FSDP shards nothing and the leaf is whole)."""
        if dp == 1:
            _check(big.dim is None and big.shard is big.param, f"FSDP sharded a leaf {when}")
            return
        _check(big.dim is not None, f"FSDP left the largest leaf replicated {when}")
        _check(big.shard.shape[0] * dp == big.param.shape[big.dim], f"FSDP layout {when}")
        held = [p for group in fstate.optimizer.param_groups for p in group["params"]]
        _check(any(p is big.shard for p in held), f"the optimizer lost the slice {when}")
        for moment in fstate.optimizer.state.get(big.shard, {}).values():
            _check(moment.dim() == 0 or moment.shape == big.shard.shape,
                   f"an Adam moment of the largest leaf is not its slice {when}")

    expect_layout("before the step")
    fstate, floss = make_cached_latent_train_step(fstate.model, diffusion, mesh=mesh)(
        fstate, shard_batch(mesh, lat_batch), torch.Generator(device=dev).manual_seed(11), 1.3)
    floss = float(floss)
    expect_layout("after the step")
    _check(abs(floss - closs1) < 1e-5, f"fsdp loss {floss} != replicated {closs1}")
    frel = _rel_l2(_params(fstate.model), _params(cs1.model))
    _check(frel < 5e-4, f"fsdp param drift vs replicated: rel L2 {frel:.2e}")
    out.update(fsdp_loss=floss, fsdp_rel_l2=frel, fsdp_largest_leaf=big.name,
               fsdp_sharded_dim=big.dim)
    del fstate, layout, cs1

    # data-parallel sampling equals the concatenation of the per-shard calls
    sampler = unet(False).to(dev).eval()

    @torch.no_grad()
    def sample_fn(params, generator, local_n):
        def model_fn(x, t):
            return functional_call(sampler, params, (x, t))
        return diffusion.ddim_sample(model_fn, (local_n, 8, 8, 8, 4), generator, num_steps=3)

    got = sharded_sample(mesh, sample_fn, trained, 21, dp, device=dev)
    want = torch.cat([sample_fn(trained, shard_generator(21, i, device=dev), 1)
                      for i in range(dp)])
    serr = float((got - want).abs().max())
    _check(serr < 1e-5, f"sharded_sample != concat of local samples ({serr:.2e})")
    out["sharded_sample_max_abs_err"] = serr
    parallel.barrier()
    parallel.shutdown()
    return out


def _launch(n: int, device: str, directory: Path):
    """Start the ``n`` ranks, each a fresh process with a ``file://``
    rendezvous in ``directory`` (on the card rank r takes card r); return
    their results by rank. Raises with every rank's output when one fails or
    ``RANK_TIMEOUT_S`` seconds pass (a hung rendezvous fails instead of
    hanging)."""
    env = {**os.environ}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "MRIJAX_MULTIHOST"):
        env.pop(var, None)
    if device == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1])]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # each rank writes to a file of its own: a pipe that nobody reads while
    # another rank is awaited could fill and stall a collective
    logs = [directory / f"rank{r}.log" for r in range(n)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mrijax_torch.graft_entry", "--device", device,
                     "-n", str(n), "--rank", str(r), "--dir", str(directory)],
                    env={**env, "LOCAL_RANK": str(r)} if device == "cuda" else env,
                    cwd=directory, stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"dryrun_multichip({n}): the ranks did not finish "
                             f"within {RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"dryrun_multichip({n}): ranks {failed} failed\n" + "\n".join(
            f"--- rank {r}\n{log.read_text()[-4000:]}" for r, log in enumerate(logs)))
    return [json.loads((directory / f"rank{r}.json").read_text()) for r in range(n)]


def dryrun_multichip(n_devices: int, device: Device = "cuda") -> dict:
    """One full two-stage training step and the rest of the JAX dry run on
    ``n_devices`` processes; returns rank 0's measurements.

    The processes form a ``("data", "model")`` mesh: (n/2, 2) when n is even
    and at least 4 (the bottleneck attention's token axis split over
    ``model``, through the flash kernels), else (n, 1), pure data
    parallelism. ``device="cuda"`` starts one process per card over NCCL
    (``n`` must not exceed the visible cards), ``"cpu"`` ``n`` gloo
    processes; each has ``RANK_TIMEOUT_S`` seconds. The config is the JAX dry run's:
    VAE3D(4, base 8, 2 downsamplings, 4 latent channels), UNet3D(4, base 8,
    mults (1, 2), attention with 2 heads, time 16), cosine T = 10, min-SNR.

    Every rank checks, against the same computation without a mesh on its own
    device, with the JAX bars: 3 steps of ``make_latent_diffusion_train_step``
    (loss within 1e-5, parameter rel-L2 below 5e-5 after every step); one
    cached-latent step (1e-5, 1e-5); the same step under
    ``shard_train_state(min_leaf_elems=256)`` (the largest leaf sharded
    before and after, loss 1e-5, rel-L2 5e-4; on a data axis of one rank
    FSDP shards nothing, and the leaf is checked whole); ``sharded_sample``
    against the concatenation of the per-shard calls (1e-5).

    In torch every rank is its own process, so what the JAX dry run checks
    in its "2-proc DCN" sub-check — real processes meeting at a rendezvous —
    is the main check here, at every ``n``. On one card it is a world of one.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        require_device(dev)
        have = torch.cuda.device_count()
        _check(n_devices <= have, f"need {n_devices} devices, have {have}")
    elif dev.type != "cpu":
        raise ValueError(f"dryrun_multichip runs on 'cuda' or 'cpu', not {device!r}")
    with tempfile.TemporaryDirectory(prefix="mrijax_torch_dryrun_") as tmp:
        ranks = _launch(n_devices, dev.type, Path(tmp))
    losses = {tuple(r["losses"]) for r in ranks}
    _check(len(losses) == 1, f"the ranks disagree on the losses: {sorted(losses)}")
    r = ranks[0]
    dp, sp = r["mesh"]
    print(f"dryrun_multichip({n_devices}, {dev.type}): mesh=(data={dp}, model={sp}) "
          f"3-step loss={r['losses'][-1]:.4f} == single-device "
          f"{r['losses_one_device'][-1]:.4f} (param rel-L2 {max(r['rel_l2']):.2e}); "
          f"cached-latent step OK (rel-L2 {r['cached_rel_l2']:.2e}); FSDP step OK "
          f"(rel-L2 {r['fsdp_rel_l2']:.2e}, layout held); sharded_sample == local concat "
          f"(max err {r['sharded_sample_max_abs_err']:.2e}) OK; {n_devices} processes "
          f"({'NCCL' if dev.type == 'cuda' else 'gloo'})")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multi-device dry run of the port "
                                             "(the JAX __graft_entry__ self-test).")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-n", type=int, default=None,
                    help="processes (default: every visible card; 8 on the CPU)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:   # one rank, started by _launch
        if args.device == "cpu":
            torch.set_num_threads(1)
        out = _dryrun_rank(args.rank, args.n, args.device, Path(args.dir))
        (Path(args.dir) / f"rank{args.rank}.json").write_text(json.dumps(out))
        return 0
    n = args.n
    if n is None:
        n = 8 if args.device == "cpu" else torch.cuda.device_count()
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
