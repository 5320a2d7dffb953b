"""Experiment drivers: config → data → model → Trainer for all 3 families.

Counterpart of ``mrijax/train/experiments.py``. The three training entry
points of the reference (`python -m model_scripts.<exp>.<module>`):

* ``train_slice_cond_2d``  ~ slice_cond_2d_ddpm/model.py
* ``train_ddpm_25d``       ~ ddpm_25d_all_modalities/model.py
* ``train_ddpm_3d_ldm``    ~ ddpm_3d_ldm/train.py (two-stage: VAE → LDM,
  with latent-scale estimation between stages and the fixed-timestep
  validation grid)

``run_experiment`` dispatches on ``cfg.family``. Models are built with the
config's compute dtype and float32 parameters, as flax holds them; on the
card their kernels run, on the CPU the kernels' plain versions, so the JAX
package's ``use_flash`` switch has no counterpart. Every driver takes
``device`` (default the card) and ``mesh``.

Across processes (``parallel.initialize`` first, one device a process): with
``mesh=None`` a data-parallel mesh over every rank is made, each rank loads
its rows of every batch, the steps all-reduce gradients and losses, and the
drivers and the trainer agree on every branch (preemption, the latent cache,
the best checkpoint). Every rank builds the same weights from the same seed.
Rank 0 alone writes checkpoints, metrics and the latent cache.
``train.num_devices``, where set, must equal the size of the data axis: the
JAX drivers take a sub-mesh of the first k devices, but here a smaller data
group would leave whole processes idle, so the driver refuses instead.
``train.fsdp`` (and ``vae_train.fsdp``) shards the train state over a data
axis of more than one rank (``parallel.fsdp``); on one it is no layout at
all and is ignored, as in the JAX package.
"""

import traceback
from pathlib import Path
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

from mrijax_torch._device import require_device
from mrijax_torch.config import (
    DiffusionConfig,
    DiTConfig,
    ExperimentConfig,
    TrainConfig,
    UNetConfig,
    VAEConfig,
)
from mrijax_torch.data import (
    BatchLoader,
    MultiModalSliceDataset25D,
    PackedLatentDataset,
    PackedMultiModalDataset25D,
    PackedSliceDataset,
    PackedVolumeDataset,
    SliceDataset2D,
    VolumeDataset3D,
    pack_latents,
    split_dataset,
    take_subset,
)
from mrijax_torch.data.packing import (
    latent_cache_is_stale,
    latent_source_files,
    params_fingerprint,
)
from mrijax_torch.diffusion import (
    GaussianDiffusion,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)
# the module, not the name: io.checkpoint imports train.steps, whose package
# imports this module, so either may be imported first
import mrijax_torch.io.checkpoint as checkpoint_io
from mrijax_torch.models import DiT3D, UNet2D, UNet3D, VAE3D
from mrijax_torch.obs import MetricsLogger, NullLogger, install_signal_handlers
from mrijax_torch.parallel import shard_train_state
from mrijax_torch.parallel.mesh import axis_size, gather_rows, make_mesh
from mrijax_torch.parallel.multihost import (
    broadcast_from_host0,
    is_distributed,
    process_index,
)
from mrijax_torch.train.state import create_train_state
from mrijax_torch.train.steps import (
    estimate_latent_scale,
    estimate_latent_scale_from_latents,
    fixed_validation_timesteps,
    make_cached_latent_eval_step,
    make_cached_latent_train_step,
    make_diffusion_eval_step,
    make_diffusion_train_step,
    make_latent_diffusion_eval_step,
    make_latent_diffusion_train_step,
    make_vae_eval_step,
    make_vae_train_step,
)
from mrijax_torch.train.trainer import Trainer, TrainerResult


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def build_diffusion(cfg: DiffusionConfig) -> GaussianDiffusion:
    if cfg.schedule == "linear":
        betas = linear_beta_schedule(cfg.timesteps, cfg.beta_start, cfg.beta_end)
    elif cfg.schedule == "cosine":
        betas = cosine_beta_schedule(cfg.timesteps)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return GaussianDiffusion(
        make_schedule(betas), loss_type=cfg.loss_type, min_snr_gamma=cfg.min_snr_gamma
    )


def build_unet2d(cfg: UNetConfig) -> UNet2D:
    if cfg.remat_levels is not None:
        # refuse rather than ignore the knob, as the JAX package does: only
        # the 3D UNet implements per-level selective remat
        raise ValueError(
            "unet.remat_levels is only supported by the 3D UNet "
            "(ddpm_3d_ldm family); use unet.remat for the 2D/2.5D families"
        )
    return UNet2D(
        in_channels=cfg.in_channels,
        out_channels=cfg.out_channels,
        base_channels=cfg.base_channels,
        channel_mults=cfg.channel_mults,
        time_emb_dim=cfg.time_emb_dim,
        groups=cfg.groups,
        remat=cfg.remat,
        dtype=_dtype(cfg.compute_dtype),
        param_dtype=torch.float32,
    )


def build_unet3d(cfg: UNetConfig) -> UNet3D:
    if cfg.remat_levels is not None:
        # validate before building, as the JAX package does: its two-stage
        # trainer would otherwise spend all of stage 1 first
        n = len(cfg.channel_mults)
        bad = [l for l in cfg.remat_levels if not 0 <= l < n]
        if bad:
            raise ValueError(
                f"unet.remat_levels {tuple(cfg.remat_levels)} out of range "
                f"for {n} resolution levels (valid: 0..{n - 1})"
            )
    return UNet3D(
        in_channels=cfg.in_channels,
        base_channels=cfg.base_channels,
        channel_mults=cfg.channel_mults,
        time_emb_dim=cfg.time_emb_dim,
        groups=cfg.groups,
        num_heads=cfg.num_heads,
        use_attention=cfg.use_attention,
        attention_levels=cfg.attention_levels,
        remat=cfg.remat,
        remat_levels=cfg.remat_levels,
        dtype=_dtype(cfg.compute_dtype),
        param_dtype=torch.float32,
    )


def build_dit3d(cfg: DiTConfig) -> DiT3D:
    """The 3D latent transformer denoiser of ``cfg``, float32 parameters."""
    return DiT3D(
        in_channels=cfg.in_channels,
        patch=cfg.patch,
        hidden=cfg.hidden,
        depth=cfg.depth,
        heads=cfg.heads,
        mlp_ratio=cfg.mlp_ratio,
        freq_dim=cfg.freq_dim,
        remat=cfg.remat,
        dtype=_dtype(cfg.compute_dtype),
        param_dtype=torch.float32,
    )


def build_denoiser3d(cfg: ExperimentConfig, dit: Optional[DiTConfig] = None):
    """Stage 2's denoiser: the DiT of ``dit`` where given, else the UNet3D of
    ``cfg.unet``."""
    return build_unet3d(cfg.unet) if dit is None else build_dit3d(dit)


def build_vae3d(cfg: VAEConfig) -> VAE3D:
    return VAE3D(
        in_channels=cfg.in_channels,
        base_channels=cfg.base_channels,
        num_down=cfg.num_down,
        latent_channels=cfg.latent_channels,
        remat=cfg.remat,
        dtype=_dtype(cfg.compute_dtype),
        param_dtype=torch.float32,
    )


def _trainer(cfg_train: TrainConfig, *, ckpt_dir, logger, train_step, eval_step,
             train_loader, val_loader, prefix="", extra=None,
             root=None) -> Trainer:
    """``root`` overrides ``cfg_train.checkpoint_dir`` as the checkpoint
    tree base: a two-stage run keeps both stages under one directory."""
    ckpt = checkpoint_io.CheckpointManager(
        Path(root or cfg_train.checkpoint_dir) / ckpt_dir,
        max_to_keep=cfg_train.max_checkpoints,
    )
    return Trainer(
        train_step=train_step,
        eval_step=eval_step,
        train_loader=train_loader,
        val_loader=val_loader,
        logger=logger,
        checkpoint_manager=ckpt,
        epochs=cfg_train.epochs,
        plateau_factor=cfg_train.plateau_factor,
        plateau_patience=cfg_train.plateau_patience,
        early_stop_patience=cfg_train.early_stop_patience,
        log_every_steps=cfg_train.log_every_steps,
        debug_max_steps=cfg_train.debug_max_steps if cfg_train.debug_fast else None,
        seed=cfg_train.seed,
        metric_prefix=prefix,
        checkpoint_extra=extra,
        resume=cfg_train.resume,
    )


def _make_loaders(cfg: ExperimentConfig, dataset, device, batch_size=None, mesh=None):
    d = cfg.data
    if batch_size is None:  # not `or`: an explicit 0 must hit the
        batch_size = d.batch_size  # "must be positive" error, not fall back
    if d.subsample_fraction:
        dataset = take_subset(dataset, fraction=d.subsample_fraction, seed=42)
    if cfg.train.debug_fast:
        dataset = take_subset(dataset, max_items=max(4 * batch_size, 64), seed=42)
    train_ds, val_ds = split_dataset(dataset, d.val_fraction, seed=0)
    if len(train_ds) < batch_size:
        raise ValueError(
            f"train split has {len(train_ds)} items < batch size {batch_size} "
            "(drop_last would yield zero batches) — lower the batch size or "
            "add data"
        )
    train_loader = BatchLoader(
        train_ds, batch_size, shuffle=True, drop_last=True,
        seed=d.shuffle_seed, device=device, mesh=mesh,
    )
    # validation runs full batches only, as the JAX drivers' do (they always
    # shard over a mesh, which a ragged last batch may not divide)
    val_loader = BatchLoader(
        val_ds, batch_size, shuffle=False, drop_last=True, device=device, mesh=mesh,
    )
    return train_loader, val_loader


def _build_2d_dataset(cfg: ExperimentConfig):
    d = cfg.data
    if d.packed_dir:
        return PackedSliceDataset(d.packed_dir)
    return SliceDataset2D(d.root_dir, d.image_size, d.modality_suffix)


def _init_params(build: Callable[[], torch.nn.Module], seed: int) -> torch.nn.Module:
    """The model that ``build`` makes, its parameters drawn by the default
    initialisers from a torch RNG seeded with ``seed`` (the caller's RNG state
    is left as it was): the same seed gives the same weights. The one place a
    driver's weights come from."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _default_mesh(cfg: ExperimentConfig, mesh):
    """``mesh`` where given; a data axis over every rank where a process
    group is up; else None (one process). ``num_devices``, where set, must be
    the data axis' size."""
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = make_mesh(("data",))
    n = axis_size(mesh, "data")
    for name, train_cfg in (("train", cfg.train), ("vae_train", cfg.vae_train)):
        if train_cfg.num_devices is not None and train_cfg.num_devices != n:
            raise ValueError(
                f"{name}.num_devices={train_cfg.num_devices}, but the data axis "
                f"has {n} process(es): the port runs one device a process and "
                "trains over every process of the group, so start as many "
                "processes as devices wanted (or leave num_devices unset)")
    return mesh


def _start(cfg: ExperimentConfig, device, logger, mesh):
    """What every driver does first: signal handlers, the device, the mesh
    and its ``num_devices`` check, and the logger (made here when not given;
    on ranks other than 0 a ``NullLogger``)."""
    install_signal_handlers()
    dev = require_device(device)
    mesh = _default_mesh(cfg, mesh)
    own_logger = logger is None
    if own_logger:
        logger = (MetricsLogger(cfg.family, run_name=cfg.name) if process_index() == 0
                  else NullLogger())
    logger.log_params(_flatten_cfg(cfg))
    return dev, logger, own_logger, mesh


def _place(state, train_cfg: TrainConfig, mesh):
    """The state as the mesh wants it: replicated (data parallel), or
    sharded with ``fsdp`` over a data axis of more than one (the train steps
    read the layout from the state)."""
    if train_cfg.fsdp and axis_size(mesh, "data") > 1:
        state, _ = shard_train_state(mesh, state,
                                     min_leaf_elems=train_cfg.fsdp_min_leaf_elems)
    return state


def _gathered(mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch (every rank's rows, in rank order) of a local one."""
    n = axis_size(mesh, "data")
    return x if n == 1 else gather_rows(x, mesh.get_group("data"), n)


# ------------------------------------------------------------- 2D / 2.5D


def _train_2d(cfg: ExperimentConfig, dataset, dev, logger, mesh) -> TrainerResult:
    """The DDPM training of the 2D and 2.5D families over ``dataset``."""
    train_loader, val_loader = _make_loaders(cfg, dataset, dev, mesh=mesh)
    model = _init_params(lambda: build_unet2d(cfg.unet), cfg.train.seed)
    diffusion = build_diffusion(cfg.diffusion).to(dev)
    state = create_train_state(model, cfg.train.learning_rate,
                               ema=cfg.train.ema_decay is not None, device=dev)
    state = _place(state, cfg.train, mesh)
    train_step = make_diffusion_train_step(
        model, diffusion, t_min=cfg.diffusion.t_min,
        nan_guard=cfg.train.nan_guard, ema_decay=cfg.train.ema_decay,
        cond_dropout=cfg.train.cond_dropout, mesh=mesh,
    )
    eval_step = make_diffusion_eval_step(model, diffusion, t_min=cfg.diffusion.t_min,
                                         mesh=mesh)
    trainer = _trainer(
        cfg.train, ckpt_dir=f"{cfg.family}/{cfg.name}", logger=logger,
        train_step=train_step, eval_step=eval_step,
        train_loader=train_loader, val_loader=val_loader,
    )
    return trainer.fit(state)


def train_slice_cond_2d(cfg: ExperimentConfig, device: Union[str, torch.device] = "cuda",
                        logger=None, mesh=None) -> TrainerResult:
    dev, logger, own_logger, mesh = _start(cfg, device, logger, mesh)
    result = _train_2d(cfg, _build_2d_dataset(cfg), dev, logger, mesh)
    if own_logger:
        logger.finish()
    return result


def train_ddpm_25d(cfg: ExperimentConfig, device: Union[str, torch.device] = "cuda",
                   logger=None, mesh=None) -> TrainerResult:
    dev, logger, own_logger, mesh = _start(cfg, device, logger, mesh)
    d = cfg.data
    if d.packed_dir:
        dataset = PackedMultiModalDataset25D(d.packed_dir, d.slice_radius)
    else:
        dataset = MultiModalSliceDataset25D(d.root_dir, d.image_size, d.slice_radius)
    result = _train_2d(cfg, dataset, dev, logger, mesh)
    if own_logger:
        logger.finish()
    return result


# ------------------------------------------------------------ 3D two-stage


def _first_batches(loader, key: str, n: int = 200):
    """``batch[key]`` of the loader's first ``n`` batches; the loader's
    iterator (and its prefetch thread) is closed when this generator ends."""
    it = iter(loader)
    try:
        for _, batch in zip(range(n), it):
            yield batch[key]
    finally:
        it.close()


def train_ddpm_3d_ldm(cfg: ExperimentConfig, device: Union[str, torch.device] = "cuda",
                      logger=None, mesh=None, dit: Optional[DiTConfig] = None):
    """Two-stage: (1) VAE on volumes; (2) frozen-VAE latent diffusion.

    Stage 2 trains the UNet3D of ``cfg.unet``, or with ``dit`` the
    transformer denoiser of that config (``build_dit3d``), which rank 0 also
    writes as ``dit.json`` into the run directory
    (``train.checkpoint_dir/<family>/<name>/``), where the CLI's sample route
    finds it.

    Returns (vae_result, ldm_result, latent_scale). Both stages live under one
    run directory, ``train.checkpoint_dir/<family>/<name>/`` (``vae/``,
    ``ldm/``, ``latent_cache/``). Across processes rank 0 decides whether the
    latent cache is stale and packs it, the decision and its success are
    broadcast, and every rank checks that the index is visible (the
    checkpoint directory must be on a filesystem that every process sees).
    """
    dev, logger, own_logger, mesh = _start(cfg, device, logger, mesh)

    # fail fast on a bad stage-2 UNet config BEFORE the (expensive) VAE
    # stage runs; built on the meta device, so nothing is allocated
    with torch.device("meta"):
        build_denoiser3d(cfg, dit)
    if dit is not None and process_index() == 0:
        run_dir = Path(cfg.train.checkpoint_dir) / cfg.family / cfg.name
        run_dir.mkdir(parents=True, exist_ok=True)
        dit.to_json(run_dir / "dit.json")

    d = cfg.data
    if d.packed_dir:
        dataset = PackedVolumeDataset(d.packed_dir, d.patch_size, random_crop=True)
    else:
        dataset = VolumeDataset3D(d.root_dir, d.patch_size, random_crop=True)
    train_loader, val_loader = _make_loaders(cfg, dataset, dev, mesh=mesh)

    vae = _init_params(lambda: build_vae3d(cfg.vae), cfg.vae_train.seed)
    f = vae.spatial_downsample  # 2**(num_down-1), NOT 2**num_down
    if cfg.train.cache_latents and any(p % f for p in d.patch_size):
        # fail fast, BEFORE stage-1 VAE training: latent crops need the patch
        # on the encoder's pixel grid
        raise ValueError(
            f"cache_latents requires patch_size {d.patch_size} divisible "
            f"by the VAE downsample factor {f}"
        )
    vae_state = _place(create_train_state(vae, cfg.vae_train.learning_rate, device=dev),
                       cfg.vae_train, mesh)
    vae_step = make_vae_train_step(vae, kl_weight=cfg.vae.kl_weight,
                                   nan_guard=cfg.vae_train.nan_guard,
                                   grad_accum=cfg.vae_train.grad_accum, mesh=mesh)
    vae_trainer = _trainer(
        cfg.vae_train, ckpt_dir=f"{cfg.family}/{cfg.name}/vae", logger=logger,
        train_step=vae_step,
        eval_step=make_vae_eval_step(vae, kl_weight=cfg.vae.kl_weight, mesh=mesh),
        train_loader=train_loader, val_loader=val_loader, prefix="vae_",
        root=cfg.train.checkpoint_dir,  # one run = one directory tree
    )
    vae_result = vae_trainer.fit(vae_state)
    vae = vae_result.state.model  # frozen from here on

    # The VAE is frozen from here on, so its output is a pure function of
    # the data: with cache_latents, encode every full volume ONCE and run
    # the whole LDM stage from latent crops.
    use_cache = cfg.train.cache_latents
    if use_cache:
        cache_dir = (
            Path(cfg.train.checkpoint_dir) / cfg.family / cfg.name / "latent_cache"
        )
        src_dir = d.packed_dir or d.root_dir
        idx_path = cache_dir / "index.json"
        multi = is_distributed()
        needs_pack = latent_cache_is_stale(idx_path, params_fingerprint(vae),
                                           latent_source_files(src_dir))
        if multi:
            # rank 0's decision, so that every rank takes the same branch
            needs_pack = broadcast_from_host0(float(needs_pack)) > 0.5
        if needs_pack:
            ok = 1.0
            if process_index() == 0:
                print(f"[3d_ldm] packing frozen-VAE latents -> {cache_dir}")
                try:
                    pack_latents(src_dir, cache_dir, vae, downsample=f, device=dev)
                except Exception:
                    if not multi:
                        raise
                    ok = 0.0  # reported to the other ranks, which would wait
                    traceback.print_exc()
            if multi:
                # doubles as the barrier before the readers open the cache
                if broadcast_from_host0(ok) < 0.5:
                    raise RuntimeError("latent packing failed on process 0 (see its log)")
        if not idx_path.exists():
            raise RuntimeError(
                f"latent cache index {idx_path} is not visible on process "
                f"{process_index()}: train.checkpoint_dir must be on a filesystem "
                "that every process sees when cache_latents is on")
        lat_patch = tuple(p // f for p in d.patch_size)
        # cross-check against the encoder's ACTUAL output shape (a shape-only
        # run on the meta device) so a VAE topology change can't silently
        # train the UNet at the wrong latent size
        with torch.device("meta"):
            enc_shape = build_vae3d(cfg.vae).encode_to_latent(
                torch.empty((1, *d.patch_size, cfg.vae.in_channels))).shape
        if tuple(enc_shape[1:-1]) != lat_patch:
            raise AssertionError(
                f"latent patch {lat_patch} != encoder output {tuple(enc_shape[1:-1])} "
                f"for patch_size {d.patch_size}"
            )
        lat_ds = PackedLatentDataset(cache_dir, lat_patch, random_crop=True)
        # same split seed over the same case order => identical subject split;
        # stage 2 batches latents (64x smaller than volumes), so it gets its
        # own batch size
        train_loader, val_loader = _make_loaders(
            cfg, lat_ds, dev, batch_size=d.latent_batch_size, mesh=mesh
        )

    # latent-scale estimation over ≤200 global batches (each rank gathers
    # every rank's rows, so all of them compute the one-process estimate)
    train_loader.set_epoch(0)
    if use_cache:
        latent_scale = estimate_latent_scale_from_latents(
            _gathered(mesh, z) for z in _first_batches(train_loader, "latent"))
    elif mesh is None:
        latent_scale = estimate_latent_scale(vae, _first_batches(train_loader, "volume"))
    else:
        with torch.no_grad():
            latent_scale = estimate_latent_scale_from_latents(
                _gathered(mesh, vae.encode_to_latent(x))
                for x in _first_batches(train_loader, "volume"))
    logger.log_metric("latent_scale", latent_scale)
    print(f"[3d_ldm] latent scale = {latent_scale:.4f}")

    unet = _init_params(lambda: build_denoiser3d(cfg, dit), cfg.train.seed)
    diffusion = build_diffusion(cfg.diffusion).to(dev)
    ldm_state = create_train_state(unet, cfg.train.learning_rate,
                                   ema=cfg.train.ema_decay is not None, device=dev)
    t_grid = fixed_validation_timesteps(cfg.diffusion.timesteps, 8)

    if use_cache:
        ldm_step = make_cached_latent_train_step(
            unet, diffusion, t_min=cfg.diffusion.t_min,
            nan_guard=cfg.train.nan_guard, ema_decay=cfg.train.ema_decay, mesh=mesh,
        )
        ldm_eval = make_cached_latent_eval_step(unet, diffusion, mesh=mesh)
    else:
        ldm_step = make_latent_diffusion_train_step(
            unet, vae, diffusion, t_min=cfg.diffusion.t_min,
            nan_guard=cfg.train.nan_guard, ema_decay=cfg.train.ema_decay, mesh=mesh,
        )
        ldm_eval = make_latent_diffusion_eval_step(unet, vae, diffusion, mesh=mesh)
    ldm_state = _place(ldm_state, cfg.train, mesh)

    def train_step(state, batch, generator):
        return ldm_step(state, batch, generator, latent_scale)

    def eval_step(params, batch, generator, batch_index=0):
        # fixed-timestep validation grid, cycled per batch and realigned
        # every epoch (train.py:446-458): the Trainer supplies the per-epoch
        # batch_index
        t_fixed = t_grid[batch_index % len(t_grid)]
        return ldm_eval(params, batch, generator, latent_scale, t_fixed)

    ldm_trainer = _trainer(
        cfg.train, ckpt_dir=f"{cfg.family}/{cfg.name}/ldm", logger=logger,
        train_step=train_step, eval_step=eval_step,
        train_loader=train_loader, val_loader=val_loader, prefix="ldm_",
        extra=lambda: {"latent_scale": float(latent_scale)},
    )
    ldm_result = ldm_trainer.fit(ldm_state)
    if own_logger:
        logger.finish()
    return vae_result, ldm_result, latent_scale


def run_experiment(cfg: ExperimentConfig, device: Union[str, torch.device] = "cuda",
                   logger=None, mesh=None, dit: Optional[DiTConfig] = None):
    """Train ``cfg.family``; ``dit`` (3D only) replaces stage 2's UNet3D."""
    if dit is not None and cfg.family != "ddpm_3d_ldm":
        raise ValueError(f"a DiT config is for the ddpm_3d_ldm family, not {cfg.family!r}")
    fn = {
        "slice_cond_2d": train_slice_cond_2d,
        "ddpm_25d": train_ddpm_25d,
        "ddpm_3d_ldm": train_ddpm_3d_ldm,
    }.get(cfg.family)
    if fn is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    extra = {} if dit is None else {"dit": dit}
    return fn(cfg, device=device, logger=logger, mesh=mesh, **extra)


def _flatten_cfg(cfg: ExperimentConfig) -> dict:
    flat = {}

    def rec(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                rec(f"{prefix}{k}.", v)
            else:
                flat[f"{prefix}{k}"] = str(v)

    rec("", cfg.to_dict())
    return flat
