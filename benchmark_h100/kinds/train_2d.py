"""Kind ``train_2d``: ``train.steps.make_diffusion_train_step`` on batches
drawn from a pool of slices and their positions on the device."""

import torch

from mrijax_torch.models import UNet2D
from mrijax_torch.train.steps import make_diffusion_train_step

from benchmark_h100 import seeding
from benchmark_h100.kind_base import UNET2D_KEYS, Train, _kw
from benchmark_h100.reference import nets


class Train2D(Train):
    def build(self) -> torch.nn.Module:
        return UNet2D(**_kw(self.config["unet"], UNET2D_KEYS), dtype=self.dtype,
                      param_dtype=torch.float32)

    def make_step(self, diffusion):
        self.t_min = self.config["diffusion"]["t_min"]
        return make_diffusion_train_step(self.net, diffusion, t_min=self.t_min,
                                         nan_guard=self.config["train"]["nan_guard"])

    def make_pool(self) -> None:
        c, m = self.config, self.mix
        size = c["image_size"]
        self.sample_shape = (size, size, c["unet"]["in_channels"])
        self.pool = torch.empty((m["pool_rows"], *self.sample_shape), device=self.device)
        seeding.fill_pool(self.pool, self.seed, "uniform")
        self.z_pool = self.positions(m["pool_rows"])

    def positions(self, n: int) -> torch.Tensor:
        """Row r is slice ``first + r mod count`` of a ``slices``-slice volume,
        at z = slice / (slices − 1): the central band the pool holds."""
        s = self.mix["slices"]
        first = s["first"]
        r = torch.arange(n, device=self.device)
        return ((first + r % s["count"]).float() / (s["of"] - 1))

    def call(self, b: dict):
        batch = {"image": self.pool[b["idx"]], "z_pos": self.z_pool[b["idx"]]}
        return self.step_fn(self.state, batch, None, t=b["t"], noise=b["noise"])

    def rows(self, idx: torch.Tensor) -> dict:
        return {"x": self.pool[idx], "z": self.z_pool[idx]}

    def forward_ref(self, params, x_t, t, rows, prec):
        return nets.unet2d(params, self.config["unet"], x_t, t, rows["z"], prec)


KIND = Train2D
