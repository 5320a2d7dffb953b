"""Declarative experiment configuration.

Counterpart of ``mrijax/config.py``, field for field, so that every
``configs/*.json`` and every preset reads the same in both packages. One
dataclass tree is the single source of truth: trainers consume it,
checkpoints embed it, and inference/eval rebuild models from the embedded
copy so configs can never drift from weights.

Defaults reproduce the reference's three training setups
(`slice_cond_2d_ddpm/model.py:24-46`, `ddpm_25d_all_modalities/
model.py:32-43`, `ddpm_3d_ldm/train.py:33-69`). A few fields name what the
JAX package does on a TPU mesh (``num_devices``, ``fsdp``,
``fsdp_min_leaf_elems``); the port reads them in ``train.experiments``
(``num_devices`` must equal the processes of the data axis; ``fsdp`` shards
through ``parallel.fsdp``).
"""

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence, Tuple


@dataclass
class DataConfig:
    root_dir: str = ""
    image_size: int = 128
    modality_suffix: str = "_flair.nii.gz"
    slice_radius: int = 2                      # 2.5D only
    patch_size: Tuple[int, int, int] = (128, 160, 160)  # 3D only
    subsample_fraction: Optional[float] = None  # ref: ⅓ (2D), ¼ (2.5D)
    val_fraction: float = 0.1
    batch_size: int = 64
    latent_batch_size: Optional[int] = None    # 3D stage-2 batch when
                                               # cache_latents is on (latents
                                               # are ~64x smaller than the
                                               # volumes the VAE stage
                                               # batches; 32 + selective
                                               # unet.remat_levels=(0,) was
                                               # the JAX package's single-TPU
                                               # optimum, PERF_TPU_v5e.md;
                                               # not measured on a GPU)
    shuffle_seed: int = 0
    packed_dir: Optional[str] = None           # use packed npz shards if set


@dataclass
class UNetConfig:
    in_channels: int = 1
    out_channels: int = 1
    base_channels: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4, 8)
    time_emb_dim: int = 256
    groups: int = 8
    num_heads: int = 4
    use_attention: bool = False                # 3D bottleneck attention
    attention_levels: Tuple[int, ...] = ()     # extra attention levels (3D)
    remat: bool = False                        # res-block rematerialization
    remat_levels: Optional[Tuple[int, ...]] = None  # selective remat: only
                                               # res blocks at these levels
                                               # (0 = full resolution) are
                                               # rematerialized; overrides
                                               # `remat` when set (3D only)
    compute_dtype: str = "bfloat16"


@dataclass
class VAEConfig:
    in_channels: int = 4
    base_channels: int = 32
    num_down: int = 3
    latent_channels: int = 16
    kl_weight: float = 1e-4
    remat: bool = False
    compute_dtype: str = "bfloat16"


@dataclass
class DiffusionConfig:
    timesteps: int = 1000
    schedule: str = "linear"                   # "linear" | "cosine"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    loss_type: str = "mse"                     # "mse" | "min_snr"
    min_snr_gamma: float = 5.0
    t_min: int = 0                             # 3D trainer samples t≥1


@dataclass
class TrainConfig:
    epochs: int = 20
    learning_rate: float = 2e-4
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    early_stop_patience: int = 4
    log_every_steps: int = 500
    checkpoint_dir: str = "checkpoints"
    max_checkpoints: int = 3
    seed: int = 0
    debug_fast: bool = False                   # ref DEBUG_FAST smoke mode
    debug_max_steps: int = 5
    resume: bool = True
    num_devices: Optional[int] = None          # sub-mesh size (None = all)
    nan_guard: bool = False                    # skip optimizer updates on
                                               # non-finite loss/grads (the
                                               # reference has no NaN guard)
    cache_latents: bool = False                # 3D LDM stage: precompute
                                               # frozen-VAE latents once and
                                               # train from latent crops
    cond_dropout: float = 0.0                  # classifier-free guidance:
                                               # probability of replacing a
                                               # sample's z_pos with the
                                               # null token during training
                                               # (2D/2.5D; 0 = off = exact
                                               # reference behavior); sample
                                               # with --guidance-scale
    ema_decay: Optional[float] = None          # EMA of the diffusion-model
                                               # params (e.g. 0.999); shadow
                                               # tree is checkpointed and
                                               # preferred for sampling/eval
    fsdp: bool = False                         # fully-sharded (ZeRO) layout:
                                               # params/Adam moments/EMA split
                                               # across the data axis; ~1/N
                                               # state memory per device,
                                               # same math (parallel.fsdp)
    fsdp_min_leaf_elems: int = 2 ** 15         # leaves smaller than this stay
                                               # replicated (sharding a bias
                                               # saves nothing, costs a
                                               # collective)
    grad_accum: int = 1                        # stage-1 VAE only: gradient
                                               # accumulation over
                                               # batch/grad_accum microbatches
                                               # (make_vae_train_step)


@dataclass
class ExperimentConfig:
    """Top-level config for one of the three model families."""

    family: str = "slice_cond_2d"  # slice_cond_2d | ddpm_25d | ddpm_3d_ldm
    name: str = "run"
    data: DataConfig = field(default_factory=DataConfig)
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)        # 3D only
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    vae_train: TrainConfig = field(default_factory=TrainConfig)  # 3D stage 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path=None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        def build(tp, val):
            if val is None:
                return tp()
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in val.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {tp.__name__}.{k}")
                ft = fields[k].type
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            family=d.get("family", "slice_cond_2d"),
            name=d.get("name", "run"),
            data=build(DataConfig, d.get("data")),
            unet=build(UNetConfig, d.get("unet")),
            vae=build(VAEConfig, d.get("vae")),
            diffusion=build(DiffusionConfig, d.get("diffusion")),
            train=build(TrainConfig, d.get("train")),
            vae_train=build(TrainConfig, d.get("vae_train")),
        )

    @classmethod
    def from_json(cls, path) -> "ExperimentConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))


# ---------------------------------------------------------------- presets

def preset_slice_cond_2d(root_dir: str = "", **over) -> ExperimentConfig:
    """128², 1ch, T=1000 linear, bs 64, Adam 2e-4, 20 epochs, ⅓ subsample
    (`slice_cond_2d_ddpm/model.py:24-46`)."""
    cfg = ExperimentConfig(
        family="slice_cond_2d",
        data=DataConfig(root_dir=root_dir, subsample_fraction=1 / 3, batch_size=64),
        unet=UNetConfig(in_channels=1, out_channels=1),
        diffusion=DiffusionConfig(timesteps=1000, schedule="linear", loss_type="mse"),
        train=TrainConfig(epochs=20, learning_rate=2e-4),
    )
    return _apply_overrides(cfg, over)


def preset_ddpm_25d(root_dir: str = "", **over) -> ExperimentConfig:
    """4-modality center + radius-2 context ⇒ 20 in / 4 out channels,
    T=1000, 50 epochs (`ddpm_25d_all_modalities/model.py:32-43,135-144`)."""
    radius = 2
    cfg = ExperimentConfig(
        family="ddpm_25d",
        data=DataConfig(
            root_dir=root_dir, subsample_fraction=0.25, batch_size=64,
            slice_radius=radius,
        ),
        unet=UNetConfig(in_channels=4 + 4 * 2 * radius, out_channels=4),
        diffusion=DiffusionConfig(timesteps=1000, schedule="linear", loss_type="mse"),
        train=TrainConfig(epochs=50, learning_rate=2e-4),
    )
    return _apply_overrides(cfg, over)


def preset_ddpm_3d_ldm(root_dir: str = "", **over) -> ExperimentConfig:
    """VAE 32ch/3down/16latent + UNet 128 (1,2,4) w/ attention, T=400
    cosine, min-SNR γ=5, bs 1/device, lr 1e-4 both stages
    (`ddpm_3d_ldm/train.py:37-59`)."""
    cfg = ExperimentConfig(
        family="ddpm_3d_ldm",
        data=DataConfig(root_dir=root_dir, batch_size=1, patch_size=(128, 160, 160)),
        # vae.remat=True: the JAX package needs it at the flagship patch size
        # (its un-rematerialised stage-1 program crashed the TPU compiler,
        # PERF_TPU_v5e.md); rematerialisation is math-identical
        # (tests/test_torch_config.py holds VAE3D(remat=True) to it)
        vae=VAEConfig(in_channels=4, base_channels=32, num_down=3,
                      latent_channels=16, remat=True),
        unet=UNetConfig(
            in_channels=16, out_channels=16, base_channels=128,
            channel_mults=(1, 2, 4), use_attention=True,
        ),
        diffusion=DiffusionConfig(
            timesteps=400, schedule="cosine", loss_type="min_snr", t_min=1
        ),
        train=TrainConfig(epochs=20, learning_rate=1e-4),
        vae_train=TrainConfig(epochs=20, learning_rate=1e-4),
    )
    return _apply_overrides(cfg, over)


def _apply_overrides(cfg: ExperimentConfig, over: dict) -> ExperimentConfig:
    """Dotted-path overrides, e.g. _apply_overrides(cfg,
    {"train.epochs": 2, "unet.base_channels": 8})."""
    for key, value in over.items():
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = getattr(node, p)
        if not hasattr(node, parts[-1]):
            raise KeyError(f"unknown override {key}")
        if isinstance(value, list):
            value = tuple(value)
        setattr(node, parts[-1], value)
    return cfg


PRESETS = {
    "slice_cond_2d": preset_slice_cond_2d,
    "ddpm_25d": preset_ddpm_25d,
    "ddpm_3d_ldm": preset_ddpm_3d_ldm,
}
