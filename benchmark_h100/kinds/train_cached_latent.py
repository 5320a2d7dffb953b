"""Kind ``train_cached_latent``: ``train.steps.make_cached_latent_train_step``
on batches drawn from a pool of latents on the device."""

import torch

from mrijax_torch.models import UNet3D
from mrijax_torch.train.steps import make_cached_latent_train_step

from benchmark_h100 import seeding
from benchmark_h100.kind_base import UNET3D_KEYS, Train, _kw
from benchmark_h100.reference import nets


class TrainCachedLatent(Train):
    def build(self) -> torch.nn.Module:
        u = self.config["unet"]
        return UNet3D(**_kw(u, UNET3D_KEYS), remat_levels=tuple(u["remat_levels"]),
                      dtype=self.dtype, param_dtype=torch.float32)

    def make_step(self, diffusion):
        self.t_min = self.config["diffusion"]["t_min"]
        return make_cached_latent_train_step(self.net, diffusion, t_min=self.t_min,
                                             nan_guard=self.config["train"]["nan_guard"])

    def make_pool(self) -> None:
        c = self.config
        self.sample_shape = (*c["latent"], c["unet"]["in_channels"])
        self.pool = torch.empty((self.mix["pool_rows"], *self.sample_shape), device=self.device)
        seeding.fill_pool(self.pool, self.seed, "normal")
        self.latent_scale = c["train"]["latent_scale"]

    def call(self, b: dict):
        return self.step_fn(self.state, {"latent": self.pool[b["idx"]]}, None, self.latent_scale,
                            t=b["t"], noise=b["noise"])

    def rows(self, idx: torch.Tensor) -> dict:
        return {"x": self.pool[idx] * self.latent_scale}

    def forward_ref(self, params, x_t, t, rows, prec):
        return nets.unet3d(params, self.config["unet"], x_t, t, prec)


KIND = TrainCachedLatent
