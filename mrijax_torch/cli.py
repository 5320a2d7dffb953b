"""Command-line entry points: ``python -m mrijax_torch.cli <subcommand>``.

Counterpart of ``mrijax/cli.py``, with its 14 subcommands and their options:

  train       --preset slice_cond_2d|ddpm_25d|ddpm_3d_ldm --root-dir ...
              [--config cfg.json] [--set train.epochs=3 ...]
  sample      --run-dir checkpoints/<family>/<name> [--mode grid|sweep|
              pseudo3d-real|pseudo3d-hybrid|volume3d|diagnostics] [--ddim-steps N]
  eval / eval-multi / eval-seg / convert-features
              matched-condition FID/KID/SSIM/LPIPS/PR of a 2D run, a JSON list
              of runs, Dice/HD95 of label maps, backbone weights → npz
  export / export-aot / serve
              best weights → npz; the sampling programs → ``.pt2``
              (``torch.export``); a generation loop over both
  import-torch  reference PyTorch checkpoints → a run directory
  preprocess  --root-dir ... --output-dir ... [--family 2d|25d|3d]
  split       --src ... --out-root ... [--mode symlink|copy|move] [--dry-run]
  doctor      environment diagnostics (read-only)
  info        --run-dir ...   (print config + checkpoint inventory)

The top-level ``--device {cuda,cpu}`` (default ``cuda``, before the
subcommand) takes the place of the JAX CLI's ``--platform`` and
``--compile-cache``: the port compiles nothing but its kernels, into
``mrijax_torch/_build/``. A subcommand that runs a model or packs slices on
the device (``train``, ``sample``, ``eval``, ``eval-multi``, ``export-aot``,
``serve``, ``preprocess --family 2d|25d``) exits non-zero where CUDA is asked
for and absent; it never moves to the CPU unasked. The others only read and
write files on the host.

Across processes: ``train --coordinator/--num-processes/--process-id``,
``MRIJAX_MULTIHOST=1``, torchrun's ``WORLD_SIZE > 1`` or ``SLURM_NTASKS > 1``
make the run one rank of a job (``_multihost_mode``) and start the process
group (``parallel.initialize(required=True)``);
rank 0 alone makes the run directory and writes ``config.json`` and the
metrics, the other ranks log into a ``NullLogger``. ``sample --data-parallel``
and ``eval --data-parallel`` split the sampling batch over the data axis of
the group (``torchrun`` starts it); in one process without torchrun they run
as a world of one, which draws what the plain call draws. Rank 0 writes
their outputs.

Randomness: ``sample`` draws from one ``torch.Generator`` on the device;
``serve``'s batch ``b`` from another; both are seeded from
``numpy.random.SeedSequence((seed, b))`` (``evals.harness.call_generator``),
``sample`` with ``b = 0``. So ``sample --mode grid`` equals ``serve``'s first
batch of the same run, seed and steps.

Every training run writes ``config.json`` next to its checkpoints so
``sample``/``info``/``eval``/``export`` rebuild exactly the trained model.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

def _parse_set(values):
    out = {}
    for item in values or []:
        k, _, v = item.partition("=")
        if not _:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass  # keep string
        out[k] = v
    return out


def _multihost_mode(args) -> bool:
    """True when this run is meant as one rank of a multi-process job: any
    rendezvous flag, ``MRIJAX_MULTIHOST=1``, torchrun's ``WORLD_SIZE > 1`` or
    a multi-task SLURM allocation. ``--num-processes 1`` alone is a plain
    single-process run."""
    if args.coordinator or args.process_id is not None:
        return True
    if args.num_processes and int(args.num_processes) > 1:
        return True
    if os.environ.get("MRIJAX_MULTIHOST"):
        return True
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def _data_parallel_mesh(args):
    """The data axis of ``--data-parallel``: over the process group, which
    torchrun's variables start here (idempotent); None without a group."""
    import torch.distributed as dist

    from mrijax_torch.parallel import initialize, make_mesh

    if not args.data_parallel:
        return None
    initialize(device=args.device)
    if not dist.is_initialized():
        print("[cli] data-parallel: one process, a world of one")
        return None
    mesh = make_mesh(("data",))
    print(f"[cli] data-parallel sampling over {mesh.size()} processes")
    return mesh


def _is_host0() -> bool:
    from mrijax_torch.parallel import process_index

    return process_index() == 0


def _device(args) -> torch.device:
    """``--device`` resolved; where CUDA is asked for and absent, exit with
    ``require_device``'s message."""
    from mrijax_torch._device import require_device

    try:
        return require_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[cli] {e} (the top-level --device cpu)") from e


def _generator(seed: int, dev: torch.device, batch: int = 0) -> torch.Generator:
    from mrijax_torch.evals.harness import call_generator

    return call_generator(seed, batch, device=dev)


def cmd_train(args):
    import torch.distributed as dist

    from mrijax_torch.config import PRESETS, ExperimentConfig, _apply_overrides
    from mrijax_torch.obs import MetricsLogger, NullLogger, run_with_energy
    from mrijax_torch.obs.energy import NvmlPowerSensor
    from mrijax_torch.parallel import initialize, process_count, process_index, shutdown
    from mrijax_torch.train.experiments import run_experiment

    # the rendezvous first: under NCCL it picks this rank's card, which every
    # "cuda" below then resolves to
    started_group = False
    if _multihost_mode(args):
        _device(args)  # the CUDA check's message before any rendezvous
        started_group = not dist.is_initialized()
        initialize(coordinator_address=args.coordinator, num_processes=args.num_processes,
                   process_id=args.process_id, required=True, device=args.device)
        print(f"[cli] multihost: process {process_index()}/{process_count()}")
    if args.config:
        cfg = ExperimentConfig.from_json(args.config)
    else:
        if args.preset not in PRESETS:
            raise SystemExit(f"unknown preset {args.preset!r}; options: {list(PRESETS)}")
        cfg = PRESETS[args.preset](args.root_dir or "")
    if args.root_dir:
        cfg.data.root_dir = args.root_dir
    if args.name:
        cfg.name = args.name
    _apply_overrides(cfg, _parse_set(args.set))
    dev = _device(args)

    run_dir = Path(cfg.train.checkpoint_dir) / cfg.family / cfg.name
    host0 = _is_host0()
    if host0:
        run_dir.mkdir(parents=True, exist_ok=True)
        cfg.to_json(run_dir / "config.json")
        print(f"[cli] training {cfg.family}/{cfg.name} -> {run_dir}")
    # the reference wraps train() in the Perun profiler and logs the energy
    # summary post-run (helpers/perun_utils.py:132-148); on the card the
    # power and energy come from NVML
    sensor = None
    if dev.type == "cuda":
        sensor = NvmlPowerSensor(dev.index if dev.index is not None
                                 else torch.cuda.current_device())
    logger = MetricsLogger(cfg.family, run_name=cfg.name) if host0 else NullLogger()
    try:
        result = run_with_energy(
            lambda: run_experiment(cfg, device=dev, logger=logger), logger=logger,
            sensor=sensor,
        )
    finally:
        logger.finish()
        if started_group:
            shutdown()
    if isinstance(result, tuple):  # 3D two-stage: (vae, ldm, scale)
        vae_res, ldm_res, scale = result
        print(
            f"[cli] done: vae best_val={vae_res.best_val_loss:.5f} "
            f"({vae_res.epochs_run} epochs), ldm best_val="
            f"{ldm_res.best_val_loss:.5f} ({ldm_res.epochs_run} epochs), "
            f"latent_scale={scale:.4f}"
        )
    else:
        print(
            f"[cli] done: best_val={result.best_val_loss:.5f} "
            f"epochs={result.epochs_run} early_stop={result.stopped_early} "
            f"preempted={result.preempted}"
        )
    return 0


def _load_run(run_dir):
    """(cfg, run_dir) of a training run directory."""
    from mrijax_torch.config import ExperimentConfig

    run_dir = Path(run_dir)
    cfg = ExperimentConfig.from_json(run_dir / "config.json")
    return cfg, run_dir


def _restore_model(run_dir, model, train_cfg, dev):
    """``model`` on ``dev`` holding the best (else latest) checkpoint's
    inference weights (the EMA shadow where tracked); returns ``(model,
    extra)``."""
    from mrijax_torch.evals.multi import _restore_params
    from mrijax_torch.train.state import create_train_state, inference_params

    state = create_train_state(model, train_cfg.learning_rate,
                               ema=train_cfg.ema_decay is not None, device=dev)
    state, extra = _restore_params(run_dir, state)
    params = inference_params(state)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            p.copy_(params[name])
    return state.model.eval(), extra


def _restore_2d(cfg, run_dir, dev):
    from mrijax_torch.train.experiments import build_unet2d

    return _restore_model(run_dir, build_unet2d(cfg.unet), cfg.train, dev)


def _dit_config(run_dir):
    """The run's ``dit.json`` (a DiT denoiser in stage 2), or None."""
    from mrijax_torch.config import DiTConfig

    path = Path(run_dir) / "dit.json"
    return DiTConfig.from_json(path) if path.exists() else None


def _restore_3d(cfg, run_dir, dev):
    """(vae, denoiser, latent_scale) of a 3D run directory (``vae/``,
    ``ldm/``): the denoiser is the UNet3D of the config, or the DiT of the
    run's ``dit.json``."""
    from mrijax_torch.train.experiments import build_denoiser3d, build_vae3d

    vae, _ = _restore_model(run_dir / "vae", build_vae3d(cfg.vae), cfg.vae_train, dev)
    unet, extra = _restore_model(run_dir / "ldm", build_denoiser3d(cfg, _dit_config(run_dir)),
                                 cfg.train, dev)
    return vae, unet, float(extra.get("latent_scale", 1.0))


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def cmd_sample(args):
    from mrijax_torch import generate
    from mrijax_torch.data import nifti
    from mrijax_torch.io.images import save_grid_png, save_png, volume_midslice_panel
    from mrijax_torch.train.experiments import build_diffusion

    cfg, run_dir = _load_run(args.run_dir)
    _device(args)  # the CUDA check's message before any rendezvous
    mesh = _data_parallel_mesh(args)
    dev = _device(args)  # this rank's card once the group picked it
    if mesh is not None and args.mode == "pseudo3d-hybrid":
        print("[cli] note: pseudo3d-hybrid is sequential over slices "
              "(autoregressive); --data-parallel has no effect")
    out_dir = Path(args.out_dir or run_dir / "samples")
    host0 = _is_host0()
    if host0:
        out_dir.mkdir(parents=True, exist_ok=True)
    diffusion = build_diffusion(cfg.diffusion)
    gen = _generator(args.seed, dev)
    # with a mesh the shards' generators come from the seed (rank i: (seed, i))
    draws = (dict(generator=gen) if mesh is None
             else dict(generator=None, mesh=mesh, seed=args.seed))
    s = cfg.data.image_size

    if cfg.family in ("slice_cond_2d", "ddpm_25d"):
        model, _ = _restore_2d(cfg, run_dir, dev)
        ctx_ch = cfg.unet.in_channels - cfg.unet.out_channels
        if (args.guidance_scale is not None and ctx_ch > 0
                and args.mode in ("grid", "sweep")):
            raise SystemExit(
                "--guidance-scale with a 2.5D (context-conditioned) model "
                "applies to --mode pseudo3d-real|pseudo3d-hybrid (grid/sweep "
                "have no context to condition on)"
            )
        if args.mode == "grid":
            imgs = generate.sample_2d(
                model, diffusion, num_samples=args.num_samples, image_size=s,
                z_pos=args.z_pos, ddim_steps=args.ddim_steps,
                sampler=args.sampler, channels=cfg.unet.out_channels,
                guidance_scale=args.guidance_scale, device=dev, **draws,
            )
            if host0:
                save_grid_png(out_dir / "grid.png", _host(imgs)[..., :1])
                print(f"[cli] wrote {out_dir/'grid.png'}")
        elif args.mode == "sweep":
            vol = generate.sample_pseudo3d_sweep(
                model, diffusion, num_slices=args.num_slices, image_size=s,
                ddim_steps=args.ddim_steps, sampler=args.sampler,
                channels=cfg.unet.out_channels, guidance_scale=args.guidance_scale,
                device=dev, **draws,
            )
            vol = _host(vol)
            if host0:
                save_grid_png(out_dir / "sweep.png", vol[..., :1], nrow=16)
                nifti.save(out_dir / "sweep.nii.gz", vol[..., 0])
                print(f"[cli] wrote {out_dir/'sweep.png'} and .nii.gz")
        elif args.mode in ("pseudo3d-real", "pseudo3d-hybrid"):
            from mrijax_torch.data import MultiModalSliceDataset25D

            ds = MultiModalSliceDataset25D(cfg.data.root_dir, s, cfg.data.slice_radius)
            if args.mode == "pseudo3d-real":
                vol = generate.generate_pseudo3d_real_context(
                    model, diffusion, ds, args.subject, ddim_steps=args.ddim_steps,
                    sampler=args.sampler, guidance_scale=args.guidance_scale,
                    device=dev, **draws)
            else:  # sequential over slices: every rank runs it whole
                vol = generate.generate_pseudo3d_hybrid(
                    model, diffusion, ds, args.subject, generator=gen,
                    ddim_steps=args.ddim_steps, sampler=args.sampler,
                    guidance_scale=args.guidance_scale, device=dev)
            vol = _host(vol)
            if host0:
                for c in range(vol.shape[-1]):
                    save_grid_png(out_dir / f"{args.mode}_mod{c}.png", vol[..., c],
                                  nrow=16)
                nifti.save(out_dir / f"{args.mode}.nii.gz", vol)
                print(f"[cli] wrote {out_dir}/{args.mode}_mod*.png and .nii.gz")
        else:
            raise SystemExit(f"mode {args.mode!r} invalid for {cfg.family}")
    elif cfg.family == "ddpm_3d_ldm":
        if args.guidance_scale is not None:
            raise SystemExit(
                "--guidance-scale is not supported for the ddpm_3d_ldm "
                "family (unconditional latent sampling has no condition to "
                "guide on; the flag would be silently ignored)"
            )
        vae, unet, latent_scale = _restore_3d(cfg, run_dir, dev)

        if args.mode == "diagnostics":
            # VAE/LDM sanity suite on real volumes (reference show_model's
            # recon grid, latent stats, DDIM noising roundtrip, eps-MSE-by-t)
            from mrijax_torch.data import VolumeDataset3D

            ds = VolumeDataset3D(cfg.data.root_dir, cfg.data.patch_size, random_crop=False)
            real = torch.from_numpy(np.stack(
                [ds[i]["volume"] for i in range(min(2, len(ds)))])).to(dev)
            diag = generate.Vae3dDiagnostics(unet, vae, diffusion,
                                             latent_scale=latent_scale, device=dev)
            recon, l1 = diag.reconstruction(real)
            report = {
                "recon_l1": l1,
                "latent_stats": diag.latent_stats(real),
                "noising_roundtrip_l1": {
                    str(k): v for k, v in diag.noising_roundtrip(real, generator=gen).items()
                },
                "eps_mse_by_t": {
                    str(k): v for k, v in diag.eps_mse_by_t(real, generator=gen).items()
                },
            }
            (out_dir / "diagnostics.json").write_text(json.dumps(report, indent=2))
            save_png(out_dir / "recon_real.png", volume_midslice_panel(_host(real[0])))
            save_png(out_dir / "recon_vae.png", volume_midslice_panel(_host(recon[0])))
            print(json.dumps(report, indent=2))
            print(f"[cli] wrote {out_dir}/diagnostics.json + recon panels")
            return 0

        latent_shape = generate.latent_shape_for(
            vae, (*cfg.data.patch_size, cfg.vae.in_channels), device=dev)
        vols = _host(generate.generate_3d_volumes(
            unet, vae, diffusion, num_volumes=args.num_samples,
            latent_spatial=latent_shape[:-1], latent_channels=latent_shape[-1],
            latent_scale=latent_scale, ddim_steps=args.ddim_steps,
            sampler=args.sampler, device=dev, **draws,
        ))
        if host0:
            for i, v in enumerate(vols):
                save_png(out_dir / f"volume{i}_midslices.png", volume_midslice_panel(v))
                nifti.save(out_dir / f"volume{i}.nii.gz", v)
            print(f"[cli] wrote {len(vols)} volumes to {out_dir}")
    else:
        raise SystemExit(f"unknown family {cfg.family!r}")
    return 0


def cmd_eval(args):
    """Matched-condition eval of a trained 2D run on the volume-level test
    split (reference protocol, `slice_cond_2d_ddpm/metrics.py:232-523`)."""
    from mrijax_torch.data import (
        BatchLoader,
        MultiModalSliceDataset25D,
        SliceDataset2D,
        volume_split_indices,
    )
    from mrijax_torch.data.loader import _IndexView
    from mrijax_torch.evals import (
        FeatureExtractor,
        InceptionFeatureExtractor,
        LPIPSDistance,
        ResNet18FeatureExtractor,
        evaluate_conditional_2d,
    )
    from mrijax_torch.parallel import sharded_sample
    from mrijax_torch.train.experiments import build_diffusion

    cfg, run_dir = _load_run(args.run_dir)
    if cfg.family not in ("slice_cond_2d", "ddpm_25d"):
        raise SystemExit("eval supports slice_cond_2d and ddpm_25d runs")
    _device(args)  # the CUDA check's message before any rendezvous
    mesh = _data_parallel_mesh(args)
    dev = _device(args)  # this rank's card once the group picked it
    if mesh is not None and args.batch_size % mesh.size():
        raise SystemExit(f"--data-parallel needs --batch-size divisible by the "
                         f"{mesh.size()} processes")
    s = cfg.data.image_size
    model, _ = _restore_2d(cfg, run_dir, dev)
    diffusion = build_diffusion(cfg.diffusion).to(dev)
    is_25d = cfg.family == "ddpm_25d"

    # volume-level split (no slice leakage)
    if is_25d:
        ds = MultiModalSliceDataset25D(cfg.data.root_dir, s, cfg.data.slice_radius)
    else:
        ds = SliceDataset2D(cfg.data.root_dir, s, cfg.data.modality_suffix)
    train_v, val_v, test_v = volume_split_indices(len(ds.volume_paths), seed=42)
    vols = {"train": train_v, "val": val_v, "test": test_v,
            "all": list(range(len(ds.volume_paths)))}[args.split]
    if not vols:
        raise SystemExit(
            f"the {args.split!r} split is empty ({len(ds.volume_paths)} volumes "
            f"total) — use --split all or a larger dataset"
        )
    paths = {ds.volume_paths[i] for i in vols}
    keep = [i for i, (p, _) in enumerate(ds.slice_tuples) if p in paths]
    if len(keep) < 2:
        raise SystemExit(
            f"the {args.split!r} split has {len(keep)} slices — FID/KID need "
            "at least 2; use --split all or a larger dataset"
        )
    if mesh is not None and len(keep) < args.batch_size:
        raise SystemExit(
            f"the {args.split!r} split has {len(keep)} slices < batch-size "
            f"{args.batch_size} — use --split all, a smaller --batch-size, "
            "or drop --data-parallel")
    # every rank loads the whole batch (only the sampling is split); one
    # device keeps the ragged tail batch, a mesh drops it
    loader = BatchLoader(_IndexView(ds, keep), args.batch_size, shuffle=False,
                         drop_last=mesh is not None, prefetch=0, device=dev,
                         shard=False)

    def sample_fn(batch, generator):
        z = batch["z_pos"]
        if args.unconditional:
            # fixed z=0.5 regardless of the real batch's conditions
            z = torch.full_like(z, 0.5)
        context = batch["context"] if is_25d else None

        def local(_, gen, cond):
            zl, cl = cond

            def model_fn(x, t):
                return model(x, t, zl, cl)

            shape = (zl.shape[0], s, s, cfg.unet.out_channels)
            if args.ddim_steps:
                return diffusion.fast_sample(model_fn, shape, gen,
                                             num_steps=args.ddim_steps,
                                             sampler=args.sampler)
            return diffusion.p_sample_loop_auto(model_fn, shape, gen)

        if mesh is not None and z.shape[0] % mesh.size() == 0:
            # the batch's generator gives the seed of its shards' generators
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
            return sharded_sample(mesh, local, None, seed, z.shape[0],
                                  cond=(z, context), device=dev)
        return local(None, generator, (z, context))

    # pretrained extractors (npz from `convert-features`) give real
    # FID/KID/LPIPS/PR; without them the seeded-random extractor is used and
    # every metric carries the _rand suffix
    if args.inception_weights:
        fe = InceptionFeatureExtractor(weights_path=args.inception_weights, device=dev)
    else:
        fe = FeatureExtractor(device=dev)
    lpips = (LPIPSDistance(weights_path=args.lpips_weights, device=dev)
             if args.lpips_weights else None)
    pr_fe = (ResNet18FeatureExtractor(weights_path=args.resnet18_weights, device=dev)
             if args.resnet18_weights else None)

    out = Path(args.out or run_dir / "eval" / "metrics.json")
    # label the fakes-generation sampler in the report: --ddim-steps engages
    # a documented NON-protocol fast mode (DDIM/DPM strided); the reference
    # protocol is full-T ancestral only (`metrics.py:355`)
    T = cfg.diffusion.timesteps
    sampling_meta = {
        "sampler": (f"{args.sampler}-{args.ddim_steps}" if args.ddim_steps
                    else f"ancestral-T{T}"),
        "sampler_is_reference_protocol": not args.ddim_steps,
    }
    report = evaluate_conditional_2d(
        sample_fn, iter(loader), feature_extractor=fe, pr_feature_extractor=pr_fe,
        lpips=lpips, num_samples=args.num_samples,
        num_diversity_pairs=args.diversity_pairs, compute_pr=args.pr, seed=args.seed,
        eval_channel=args.eval_channel if is_25d else None,
        out_path=out if _is_host0() else None, metadata=sampling_meta, device=dev,
    )
    print(json.dumps({k: v for k, v in report.items()
                      if not isinstance(v, dict)}, indent=2))
    if _is_host0():
        print(f"[cli] wrote {out}")
    return 0


def cmd_eval_multi(args):
    """Batch-evaluate a config list of run dirs (the reference's
    `metrics_both.py` harness as a CLI): per-model metrics.json +
    summary.json + RUNNING/progress/ERROR breadcrumbs."""
    from mrijax_torch.evals import evaluate_runs

    run_configs = json.loads(Path(args.config).read_text())
    if isinstance(run_configs, dict):
        run_configs = run_configs.get("runs")
    if not isinstance(run_configs, list) or not all(
        isinstance(rc, dict) for rc in run_configs
    ):
        raise SystemExit(
            "--config must be a JSON list of run configs (or {\"runs\": "
            "[...]}) — each entry: {\"run_dir\": ..., \"num_samples\": N, "
            "\"ddim_steps\": N, \"split\": ..., \"compute_pr\": bool, "
            "\"name\": ..., per-run *_weights overrides}"
        )
    summary = evaluate_runs(
        run_configs, args.out_dir, inception_weights=args.inception_weights,
        lpips_weights=args.lpips_weights, resnet18_weights=args.resnet18_weights,
        device=_device(args),
    )
    failed = [k for k, v in summary.items() if "error" in v]
    print(f"[cli] evaluated {len(summary)} runs "
          f"({len(failed)} failed: {failed}) -> {args.out_dir}/summary.json")
    return 1 if failed and len(failed) == len(summary) else 0


def cmd_eval_seg(args):
    """Dice + HD95 per BraTS label between predicted and reference
    segmentation label maps (NIfTI), matched by filename when directories
    are given (`evaluation_scripts/evaluate_models.py:473-549`)."""
    from mrijax_torch.data import nifti
    from mrijax_torch.evals import BRATS_LABELS, dice_per_label, hd95_per_label

    pred, target = Path(args.pred), Path(args.target)
    if pred.is_dir() != target.is_dir():
        raise SystemExit("--pred and --target must both be files or both dirs")
    if pred.is_dir():
        pairs = []
        for p in sorted(pred.rglob("*.nii*")):
            t = target / p.relative_to(pred)
            if t.exists():
                pairs.append((p, t))
        if not pairs:
            raise SystemExit(f"no matching label maps between {pred} and {target}")
    else:
        pairs = [(pred, target)]

    labels = tuple(args.labels or BRATS_LABELS)
    spacing = tuple(args.voxelspacing) if args.voxelspacing else None
    per_case = {}
    for p, t in pairs:
        pv = np.rint(nifti.load(p)).astype(np.int32)
        tv = np.rint(nifti.load(t)).astype(np.int32)
        # key by the relative path used for matching — bare filenames can
        # collide across per-subject subdirectories
        case = str(p.relative_to(pred)) if pred.is_dir() else p.name
        per_case[case] = {
            "dice": dice_per_label(pv, tv, labels),
            "hd95": hd95_per_label(pv, tv, labels, spacing=spacing),
        }

    def finite_mean(vals):
        vals = [v for v in vals if np.isfinite(v)]
        return float(np.mean(vals)) if vals else None

    def jsonable(v):
        return float(v) if np.isfinite(v) else None  # inf: label absent

    report = {
        "labels": list(labels),
        "num_cases": len(per_case),
        "mean_dice": {
            str(l): float(np.mean([c["dice"][l] for c in per_case.values()]))
            for l in labels
        },
        "mean_hd95": {
            str(l): finite_mean([c["hd95"][l] for c in per_case.values()])
            for l in labels
        },
        "per_case": {
            name: {"dice": {str(l): v for l, v in c["dice"].items()},
                   "hd95": {str(l): jsonable(v) for l, v in c["hd95"].items()}}
            for name, c in per_case.items()
        },
    }
    out = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(out)
        print(f"[cli] wrote {args.out}")
    print(out if not args.out else json.dumps(
        {k: report[k] for k in ("labels", "num_cases", "mean_dice", "mean_hd95")},
        indent=2,
    ))
    return 0


def _count_leaves(tree) -> int:
    return sum(_count_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def cmd_convert_features(args):
    """Convert a torch feature-backbone state_dict (torchvision
    inception_v3/resnet18, or lpips alex) to the portable npz that ``eval``
    reads (the JAX package's layout) — recovers the reference's real ImageNet
    metrics (`evaluation_scripts/evaluate_models.py:82-131`,
    `slice_cond_2d_ddpm/metrics.py:147-229,329-343,419-443`)."""
    from mrijax_torch.io import (
        convert_inception_v3,
        convert_lpips_alex,
        convert_resnet18,
        save_params_npz,
    )

    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    convert = {
        "inception_v3": convert_inception_v3,
        "resnet18": convert_resnet18,
        "lpips_alex": convert_lpips_alex,
    }[args.arch]
    params = convert(sd)
    save_params_npz(args.out, params, meta={"arch": args.arch})
    print(f"[cli] converted {args.arch}: {_count_leaves(params)} tensors -> {args.out}")
    return 0


def _load_torch_state_dict(path):
    """torch.load + the reference's checkpoint-format tolerance: raw
    state_dict or ``{"state_dict": ...}`` wrapping
    (`ddpm_3d_ldm/show_model.py:43-52`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise SystemExit(
            f"{path} does not contain a state_dict (got {type(sd).__name__}) "
            "— expected a raw state_dict or {'state_dict': ...} checkpoint"
        )
    return dict(sd)


def _save_imported(directory, model, learning_rate, extra):
    """One checkpoint at step 0 of ``model``'s weights (no EMA), best by a
    val loss of 0, which ``sample`` / ``export`` restore."""
    from mrijax_torch.io import CheckpointManager
    from mrijax_torch.train.state import create_train_state

    state = create_train_state(model, learning_rate, device="cpu")
    mgr = CheckpointManager(directory)
    mgr.save(0, state, extra, metrics={"val_loss": 0.0})
    mgr.wait()
    mgr.close()


def cmd_import_torch(args):
    """Convert a reference PyTorch checkpoint (2D / 2.5D diffusion
    state_dict, or the 3D VAE+LDM pair) into a run directory usable by
    sample/eval/export."""
    from mrijax_torch.config import PRESETS, _apply_overrides
    from mrijax_torch.io import infer_timesteps, load_reference_unet2d
    from mrijax_torch.train.experiments import build_unet2d

    cfg = PRESETS[args.preset](args.root_dir or "")
    cfg.name = args.name or "imported"
    _apply_overrides(cfg, _parse_set(args.set))
    if cfg.train.ema_decay is not None:
        # torch checkpoints carry no EMA shadow; a config claiming one
        # would make the written run dir unrestorable by sample/eval
        print("[cli] note: train.ema_decay cleared — imported torch "
              "checkpoints have no EMA shadow")
        cfg.train.ema_decay = None

    if cfg.family == "ddpm_3d_ldm":
        return _import_torch_3d(args, cfg)

    sd = _load_torch_state_dict(args.checkpoint)
    t_inferred = infer_timesteps(sd)
    if t_inferred:
        cfg.diffusion.timesteps = t_inferred
        print(f"[cli] inferred T={t_inferred} from checkpoint betas")
    model = build_unet2d(cfg.unet)
    try:
        load_reference_unet2d(model, sd)
    except RuntimeError as e:   # load_state_dict(strict=True): names or shapes
        raise SystemExit(
            "converted parameter tree does not match the config's model — "
            f"check --preset / --set channel settings against the checkpoint ({e})"
        ) from e

    run_dir = Path(args.out)
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg.to_json(run_dir / "config.json")
    _save_imported(run_dir, model, cfg.train.learning_rate,
                   {"imported_from": str(args.checkpoint)})
    print(f"[cli] imported {args.checkpoint} -> {run_dir}")
    return 0


def _import_torch_3d(args, cfg):
    """Import the reference 3D pair — ``vae3d_final.pt`` +
    ``3d_ldm_diffusion_best.pt`` (the load protocol of
    `ddpm_3d_ldm/show_model.py:54-103`, incl. ``{"state_dict": ...}``
    wrapping and DDP prefix remap) — into a run dir with the ``vae/`` and
    ``ldm/`` checkpoints that ``sample --mode volume3d|diagnostics`` and
    ``export`` consume."""
    from mrijax_torch.io import convert_reference_unet3d, convert_reference_vae3d
    from mrijax_torch.train.experiments import build_unet3d, build_vae3d

    if not args.vae_checkpoint:
        raise SystemExit(
            "--preset ddpm_3d_ldm needs --vae-checkpoint (vae3d_final.pt) "
            "in addition to --checkpoint (the LDM UNet state_dict)"
        )
    vae, unet = build_vae3d(cfg.vae), build_unet3d(cfg.unet)
    for label, model, sd in (
            ("vae", vae, convert_reference_vae3d(_load_torch_state_dict(args.vae_checkpoint))),
            ("ldm", unet, convert_reference_unet3d(_load_torch_state_dict(args.checkpoint)))):
        try:
            model.load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise SystemExit(
                f"converted {label} parameter tree does not match the "
                "config's model — check --preset / --set channel settings "
                f"against the checkpoints ({e})"
            ) from e

    latent_scale = float(args.latent_scale)
    if args.latent_scale == 1.0:
        print(
            "[cli] latent_scale defaulted to 1.0 — the reference re-estimates "
            "it from data at inference (show_model.py:303,354-363); pass "
            "--latent-scale from the training run for exact parity"
        )

    run_dir = Path(args.out)
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg.to_json(run_dir / "config.json")
    _save_imported(run_dir / "vae", vae, cfg.vae_train.learning_rate,
                   {"imported_from": str(args.vae_checkpoint)})
    _save_imported(run_dir / "ldm", unet, cfg.train.learning_rate,
                   {"imported_from": str(args.checkpoint), "latent_scale": latent_scale})
    print(f"[cli] imported 3D pair -> {run_dir} (vae/ + ldm/, "
          f"latent_scale={latent_scale})")
    return 0


def _weights(model) -> dict:
    return {k: v.detach() for k, v in model.named_parameters()}


def cmd_export(args):
    """Export a run's best inference weights to a portable npz by
    ``state_dict`` name (the .pt-artifact analog), read on the host."""
    from mrijax_torch.io import save_params_npz

    cfg, run_dir = _load_run(args.run_dir)
    out = Path(args.out)
    host = torch.device("cpu")
    if cfg.family in ("slice_cond_2d", "ddpm_25d"):
        model, extra = _restore_2d(cfg, run_dir, host)
        save_params_npz(out, _weights(model),
                        meta={"family": cfg.family, "config": cfg.to_dict(),
                              **{k: v for k, v in extra.items()
                                 if isinstance(v, (int, float, str))}})
        print(f"[cli] exported {cfg.family} weights -> {out}")
    elif cfg.family == "ddpm_3d_ldm":
        vae, unet, latent_scale = _restore_3d(cfg, run_dir, host)
        save_params_npz(out.with_suffix(".vae.npz"), _weights(vae),
                        meta={"family": "vae3d", "config": cfg.to_dict()})
        save_params_npz(out, _weights(unet),
                        meta={"family": cfg.family, "config": cfg.to_dict(),
                              "latent_scale": latent_scale})
        print(f"[cli] exported LDM -> {out} and VAE -> {out.with_suffix('.vae.npz')}")
    else:
        raise SystemExit(f"unknown family {cfg.family!r}")
    return 0


def cmd_export_aot(args):
    """Write the run's sampling programs (``torch.export``: the per-step
    denoiser, and the VAE decode for 3D) with the sampler's settings to one
    ``.pt2``, so serving processes need neither the run directory nor the
    model code's construction path (see mrijax_torch/aot.py; the weights stay
    external arguments and come from ``export`` npz)."""
    from mrijax_torch import aot
    from mrijax_torch.train.experiments import build_unet3d

    cfg, run_dir = _load_run(args.run_dir)
    out = Path(args.out)
    dev = _device(args)
    t0 = time.perf_counter()
    if cfg.family == "ddpm_3d_ldm" and _dit_config(run_dir) is not None:
        raise SystemExit("export-aot exports the UNet3D denoiser; this run trained a DiT "
                         "(dit.json): sample it with `sample --mode volume3d`")
    if cfg.family == "ddpm_3d_ldm":
        # latent_scale travels in the ldm checkpoint's extra and goes into
        # the program's settings
        _, extra = _restore_model(run_dir / "ldm", build_unet3d(cfg.unet), cfg.train,
                                  torch.device("cpu"))
        programs = aot.build_volume_sampler(
            cfg, float(extra.get("latent_scale", 1.0)), num_volumes=args.num_samples,
            ddim_steps=args.ddim_steps, sampler=args.sampler, device=dev,
        )
        sig = "(unet_params, vae_params, generator)"
    elif cfg.family == "slice_cond_2d":
        programs = aot.build_slice_sampler(
            cfg, num_samples=args.num_samples, ddim_steps=args.ddim_steps,
            sampler=args.sampler, device=dev,
        )
        sig = "(params, generator, z_pos)"
    else:
        raise SystemExit(
            f"export-aot supports slice_cond_2d and ddpm_3d_ldm; "
            f"{cfg.family!r} sampling consumes context data, not just "
            "params — serve it via mrijax_torch.generate"
        )
    aot.save_exported(out, programs)
    print(
        f"[cli] AOT sampling programs -> {out} ({out.stat().st_size} bytes, "
        f"device {dev.type}, call signature {sig}, "
        f"exported in {time.perf_counter() - t0:.3f}s); "
        "serving: mrijax_torch.aot.load_exported(path)"
    )
    return 0


def cmd_serve(args):
    """Generation loop from an ``export-aot`` program + ``export`` npz
    weights — the serving deployment path (mrijax_torch/aot.py). Needs
    neither the run dir nor the model's construction: ``export-aot`` wrote
    the programs, ``export`` the weights; this binds them and writes batches
    of outputs. Batch ``b`` draws from a generator seeded from
    ``SeedSequence((seed, b))``."""
    from mrijax_torch import aot
    from mrijax_torch.data import nifti
    from mrijax_torch.io import load_params_npz
    from mrijax_torch.io.images import save_grid_png, save_png, volume_midslice_panel

    aot.check_device(args.program, args.device)   # the program's device type first
    dev = _device(args)
    sampler = aot.ExportedSampler(aot.deserialize_exported(args.program, dev), dev)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    weights, meta = load_params_npz(args.weights)
    family = meta.get("family")
    n_baked = sampler.batch  # batch size baked into the program

    def tensors(tree, prefix=""):
        """The npz's arrays on the device by name (a nested tree's names
        joined by "/", which no ``state_dict`` name matches)."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(tensors(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = torch.from_numpy(np.asarray(v)).to(dev)
        return out

    if family == "ddpm_3d_ldm":
        vae_path = args.vae_weights or Path(args.weights).with_suffix(".vae.npz")
        if not Path(vae_path).exists():
            raise SystemExit(
                f"VAE weights not found at {vae_path} — `mrijax_torch.cli export` "
                "writes them next to the LDM npz; pass --vae-weights"
            )
        vae_weights, _ = load_params_npz(vae_path)
        bound = (("params", tensors(weights)), ("vae_params", tensors(vae_weights)))
        z = None
    elif family == "slice_cond_2d":
        if args.z == "sweep":
            z = np.linspace(0.0, 1.0, n_baked, dtype=np.float32)
        else:
            z = np.full((n_baked,), float(args.z), np.float32)
        bound = (("params", tensors(weights)),)
    else:
        raise SystemExit(
            f"weights npz is family {family!r}; serve supports "
            "slice_cond_2d and ddpm_3d_ldm (what export-aot can build)"
        )
    try:
        if family != sampler.family:
            raise ValueError(f"family mismatch: weights {family!r}, program {sampler.family!r}")
        for which, params in bound:
            sampler.check_params(params, which)
    except ValueError as e:
        raise SystemExit(
            f"serve: {e}\n  check that {args.program} and {args.weights} were "
            "exported from the same run/config"
        ) from e

    t_first = t0 = time.perf_counter()
    first_s = None
    for b in range(args.batches):
        gen = _generator(args.seed, dev, b)
        if family == "ddpm_3d_ldm":
            out = _host(sampler(bound[0][1], bound[1][1], gen))
        else:
            out = _host(sampler(bound[0][1], gen, torch.from_numpy(z).to(dev)))
        if b == 0:
            t0 = time.perf_counter()  # the first batch pays the loaded programs' first run
            first_s = t0 - t_first
        if family == "ddpm_3d_ldm":
            for j, v in enumerate(out):
                nifti.save(out_dir / f"b{b:03d}_v{j}.nii.gz", v)
                save_png(out_dir / f"b{b:03d}_v{j}_midslices.png", volume_midslice_panel(v))
        else:
            save_grid_png(out_dir / f"b{b:03d}.png", out)
            np.savez(out_dir / f"b{b:03d}.npz", samples=out, z_pos=z)
    dt = time.perf_counter() - t_first
    steady = (time.perf_counter() - t0) / max(args.batches - 1, 1)
    print(
        f"[cli] served {args.batches} batch(es) of {n_baked} -> {out_dir} "
        f"({dt:.4f}s total, {first_s:.4f}s first batch"
        + (f", {steady:.4f}s/batch steady-state" if args.batches > 1 else "")
        + ")"
    )
    return 0


def cmd_preprocess(args):
    from mrijax_torch.data import pack_dataset, pack_multimodal_slices, pack_volumes

    if args.family == "2d":
        index = pack_dataset(
            args.root_dir, args.output_dir, image_size=args.image_size,
            modality_suffix=args.modality_suffix, device=_device(args),
        )
    elif args.family == "25d":
        index = pack_multimodal_slices(
            args.root_dir, args.output_dir, image_size=args.image_size,
            device=_device(args),
        )
    else:  # 3d: normalized whole volumes, on the host
        index = pack_volumes(args.root_dir, args.output_dir)
    print(f"[cli] packed {len(index['files'])} volumes "
          f"({args.family}) -> {args.output_dir}")
    return 0


def cmd_split(args):
    from mrijax_torch.data import apply_split

    splits = apply_split(
        args.src, args.out_root,
        train_frac=args.train_frac, val_frac=args.val_frac,
        test_frac=args.test_frac, seed=args.seed, mode=args.mode,
        dry_run=args.dry_run,
    )
    print({k: len(v) for k, v in splits.items()})
    return 0


def cmd_doctor(args):
    """Environment diagnostics: torch, CUDA, the card, which kernel
    libraries and the NIfTI reader are built. Read-only (builds nothing) —
    run this first when anything behaves oddly on a new machine."""
    from mrijax_torch.data import cnifti
    from mrijax_torch.kernels import _build

    from mrijax_torch.parallel import process_count, process_index

    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"cuda available={torch.cuda.is_available()}  --device {args.device}")
    print(f"process {process_index()} of {process_count()} "
          f"(torch.distributed initialized={torch.distributed.is_initialized()})")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            print(f"  device {i}: {props.name}, {props.total_memory / 2**30:.1f} GiB, "
                  f"sm_{props.major}{props.minor}, "
                  f"{torch.cuda.memory_allocated(i) / 2**30:.2f} GiB allocated")
        try:
            from mrijax_torch.obs.energy import NvmlPowerSensor

            sensor = NvmlPowerSensor(torch.cuda.current_device())
            print(f"  NVML: {sensor.read_power_w():.1f} W of a "
                  f"{sensor.power_limit_w():.1f} W limit")
        except RuntimeError as e:
            print(f"  NVML: unavailable ({e})")
    else:
        print("  no CUDA device: every subcommand that computes needs the "
              "top-level --device cpu")
    for name, src in _build._sources().items():
        lib = _build._library_path(name, src)
        print(f"kernel library {name}: "
              f"{'built' if lib.exists() else 'not built (nvcc builds it at the first CUDA call)'}")
    print(f"native NIfTI decoder: "
          f"{'built' if cnifti.library_path().exists() else 'not built (g++ builds it at first use)'}")
    return 0


def cmd_info(args):
    from mrijax_torch.io import CheckpointManager

    cfg, run_dir = _load_run(args.run_dir)
    print(cfg.to_json())
    for sub in ("", "vae", "ldm"):
        d = run_dir / sub if sub else run_dir
        if not (d / "best.json").exists() and not any(d.glob("[0-9]*")):
            continue
        mgr = CheckpointManager(d)
        print(f"{d}: latest={mgr.latest_step} best={mgr.best_step}")
        mgr.close()
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="mrijax_torch", description=__doc__)
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where models run (default cuda; nothing moves to the CPU unasked)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model family")
    t.add_argument("--preset", default="slice_cond_2d")
    t.add_argument("--config", default=None, help="config JSON (overrides preset)")
    t.add_argument("--root-dir", default=None)
    t.add_argument("--name", default=None)
    # action="extend": repeated --set flags accumulate instead of the last
    # silently replacing the rest
    t.add_argument("--set", nargs="*", action="extend", default=[], metavar="KEY=VAL",
                   help="dotted config overrides, e.g. train.epochs=3")
    t.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process rendezvous: tcp://host:port, host:port or "
                        "file://path (torchrun's MASTER_ADDR/MASTER_PORT otherwise)")
    t.add_argument("--num-processes", type=int, default=None,
                   help="total processes in the multi-process job")
    t.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, num-processes)")
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("sample", help="generate from a trained run")
    s.add_argument("--run-dir", required=True)
    s.add_argument("--mode", default="grid",
                   choices=["grid", "sweep", "pseudo3d-real", "pseudo3d-hybrid",
                            "volume3d", "diagnostics"])
    s.add_argument("--num-samples", type=int, default=16)
    s.add_argument("--num-slices", type=int, default=155)
    s.add_argument("--z-pos", type=float, default=0.5)
    s.add_argument("--subject", type=int, default=0)
    s.add_argument("--ddim-steps", type=int, default=None)
    s.add_argument("--guidance-scale", type=float, default=None,
                   help="classifier-free guidance scale (2D/2.5D grid+sweep; "
                        "needs a model trained with train.cond_dropout>0; "
                        "1.0 = plain conditional)")
    s.add_argument("--sampler", default="ddim", choices=["ddim", "dpm"],
                   help="fast-path solver when --ddim-steps is set: "
                        "first-order DDIM or second-order DPM-Solver++(2M)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out-dir", default=None)
    s.add_argument("--data-parallel", action="store_true",
                   help="shard the sampling batch over the processes of the job "
                        "(torchrun); one process runs as a world of one")
    s.set_defaults(fn=cmd_sample)

    e = sub.add_parser("eval", help="matched-condition generative eval")
    e.add_argument("--run-dir", required=True)
    e.add_argument("--num-samples", type=int, default=1000)
    # the fakes batch is a free parameter of the harness, not part of the
    # metric definition
    e.add_argument("--batch-size", type=int, default=128)
    e.add_argument("--ddim-steps", type=int, default=None)
    e.add_argument("--sampler", default="ddim", choices=["ddim", "dpm"])
    e.add_argument("--diversity-pairs", type=int, default=64)
    e.add_argument("--pr", action="store_true")
    e.add_argument("--unconditional", action="store_true")
    e.add_argument("--split", default="test", choices=["train", "val", "test", "all"])
    e.add_argument("--eval-channel", type=int, default=3,
                   help="channel scored for multichannel (2.5D) models (3=FLAIR)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--out", default=None)
    e.add_argument("--inception-weights", default=None,
                   help="npz from `convert-features --arch inception_v3` → real FID/KID")
    e.add_argument("--lpips-weights", default=None,
                   help="npz from `convert-features --arch lpips_alex` → real LPIPS diversity")
    e.add_argument("--resnet18-weights", default=None,
                   help="npz from `convert-features --arch resnet18` → real improved PR")
    e.add_argument("--data-parallel", action="store_true",
                   help="shard the matched-condition sampling over the processes "
                        "of the job (torchrun); one process runs as a world of one")
    e.set_defaults(fn=cmd_eval)

    em = sub.add_parser("eval-multi",
                        help="batch-evaluate a JSON list of run dirs")
    em.add_argument("--config", required=True,
                    help="JSON list of run configs (see evals.multi)")
    em.add_argument("--out-dir", required=True)
    em.add_argument("--inception-weights", default=None,
                    help="harness-wide default; per-run override via config")
    em.add_argument("--lpips-weights", default=None)
    em.add_argument("--resnet18-weights", default=None)
    em.set_defaults(fn=cmd_eval_multi)

    ex = sub.add_parser("export", help="export best weights to portable npz")
    ex.add_argument("--run-dir", required=True)
    ex.add_argument("--out", required=True)
    ex.set_defaults(fn=cmd_export)

    ea = sub.add_parser(
        "export-aot",
        help="write the sampling programs (torch.export) so serving processes "
             "need neither the run dir nor the model's construction",
    )
    ea.add_argument("--run-dir", required=True)
    ea.add_argument("--out", required=True, help="output .pt2 path")
    ea.add_argument("--num-samples", type=int, default=8,
                    help="batch size baked into the program's shapes")
    ea.add_argument("--ddim-steps", type=int, default=None,
                    help="fast-path steps (default: full ancestral T)")
    ea.add_argument("--sampler", default="ddim", choices=["ddim", "dpm"],
                    help="solver when --ddim-steps is set (dpm = "
                         "DPM-Solver++(2M))")
    ea.set_defaults(fn=cmd_export_aot)

    sv = sub.add_parser(
        "serve",
        help="generation loop from an export-aot program + export npz "
             "weights (no run dir)",
    )
    sv.add_argument("--program", required=True, help=".pt2 from export-aot")
    sv.add_argument("--weights", required=True, help="npz from export")
    sv.add_argument("--vae-weights", default=None,
                    help="3D family VAE npz (default: <weights>.vae.npz)")
    sv.add_argument("--out", required=True)
    sv.add_argument("--batches", type=int, default=1,
                    help="number of batches to generate")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--z", default="0.5",
                    help="2D family slice position: a float, or 'sweep' for "
                         "linspace(0,1) across the batch")
    sv.set_defaults(fn=cmd_serve)

    es = sub.add_parser(
        "eval-seg",
        help="Dice + HD95 per BraTS label between NIfTI label maps",
    )
    es.add_argument("--pred", required=True, help="predicted labels (file or dir)")
    es.add_argument("--target", required=True, help="reference labels (file or dir)")
    es.add_argument("--labels", type=int, nargs="*", default=None,
                    help="label ids (default: BraTS 1 2 4)")
    es.add_argument("--voxelspacing", type=float, nargs=3, default=None)
    es.add_argument("--out", default=None, help="write full report JSON here")
    es.set_defaults(fn=cmd_eval_seg)

    cf = sub.add_parser(
        "convert-features",
        help="torch inception_v3/resnet18/lpips weights -> npz for eval",
    )
    cf.add_argument("--checkpoint", required=True, help=".pth state_dict")
    cf.add_argument("--arch", required=True,
                    choices=["inception_v3", "resnet18", "lpips_alex"])
    cf.add_argument("--out", required=True, help="output npz path")
    cf.set_defaults(fn=cmd_convert_features)

    it = sub.add_parser("import-torch",
                        help="convert a reference PyTorch checkpoint")
    it.add_argument("--checkpoint", required=True,
                    help="diffusion state_dict (2D/2.5D) or the LDM UNet "
                         "state_dict (3D)")
    it.add_argument("--out", required=True, help="run dir to create")
    it.add_argument("--preset", default="slice_cond_2d")
    it.add_argument("--vae-checkpoint", default=None,
                    help="vae3d_final.pt (required for --preset ddpm_3d_ldm)")
    it.add_argument("--latent-scale", type=float, default=1.0,
                    help="latent scale from the reference training run (3D)")
    it.add_argument("--root-dir", default=None)
    it.add_argument("--name", default=None)
    it.add_argument("--set", nargs="*", action="extend", default=[], metavar="KEY=VAL")
    it.set_defaults(fn=cmd_import_torch)

    pp = sub.add_parser("preprocess", help="pack data into npz shards")
    pp.add_argument("--root-dir", required=True)
    pp.add_argument("--output-dir", required=True)
    pp.add_argument("--family", default="2d", choices=["2d", "25d", "3d"],
                    help="2d: FLAIR slices; 25d: multimodal slice stacks "
                         "(both preprocessed on --device); 3d: normalized full volumes")
    pp.add_argument("--image-size", type=int, default=128)
    pp.add_argument("--modality-suffix", default="_flair.nii.gz")
    pp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("split", help="subject-level train/val/test split")
    sp.add_argument("--src", required=True)
    sp.add_argument("--out-root", required=True)
    sp.add_argument("--train-frac", type=float, default=0.8)
    sp.add_argument("--val-frac", type=float, default=0.1)
    sp.add_argument("--test-frac", type=float, default=0.1)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--mode", default="symlink", choices=["symlink", "copy", "move"])
    sp.add_argument("--dry-run", action="store_true")
    sp.set_defaults(fn=cmd_split)

    dr = sub.add_parser("doctor", help="environment diagnostics (read-only)")
    dr.set_defaults(fn=cmd_doctor)

    i = sub.add_parser("info", help="show run config + checkpoints")
    i.add_argument("--run-dir", required=True)
    i.set_defaults(fn=cmd_info)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
