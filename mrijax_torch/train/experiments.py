"""Config → model, diffusion and trainer builders.

Counterpart of the builders of ``mrijax/train/experiments.py``
(``build_diffusion``, ``build_unet2d``, ``build_unet3d``, ``build_vae3d`` and
``_trainer``).
Models are built with the config's compute dtype and float32 parameters, as
flax holds them; on the card their kernels run, on the CPU the kernels' plain
versions, so the JAX package's ``use_flash`` switch has no counterpart. The
experiment drivers (``train_ddpm_3d_ldm`` and the 2D / 2.5D ones) come with
the data pipeline.
"""

from pathlib import Path

import torch

from mrijax_torch.config import DiffusionConfig, TrainConfig, UNetConfig, VAEConfig
from mrijax_torch.diffusion import (
    GaussianDiffusion,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
)
from mrijax_torch.io.checkpoint import CheckpointManager
from mrijax_torch.models import UNet2D, UNet3D, VAE3D
from mrijax_torch.train.trainer import Trainer


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
    ckpt = CheckpointManager(
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
