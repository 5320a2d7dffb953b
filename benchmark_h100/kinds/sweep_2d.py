"""Kind ``sweep_2d``: a closed loop of ``generate.sample_pseudo3d_sweep``
calls, the ``num_slices`` positions ``linspace(0, 1, num_slices)`` as one
batch."""

import torch

from mrijax_torch.diffusion import GaussianDiffusion
from mrijax_torch.generate import sample_pseudo3d_sweep
from mrijax_torch.models import UNet2D

from benchmark_h100 import seeding
from benchmark_h100.count import ops
from benchmark_h100.kind_base import UNET2D_KEYS, WARMUP, Generate, _kw
from benchmark_h100.reference import nets


class Sweep2D(Generate):
    program_attrs = ("net", "diffusion")

    def setup(self) -> None:
        c, m, dev = self.config, self.mix, self.device
        with dev:
            self.net = UNet2D(**_kw(c["unet"], UNET2D_KEYS), dtype=self.dtype).eval()
        self.mark("modules")
        self.net_spec = seeding.param_spec(self.net)
        seeding.load_weights(self.net, seeding.make_weights(
            self.net_spec, self.seed, seeding.WEIGHTS_UNET, dev))
        self.mark("weights")
        self.diffusion = GaussianDiffusion(self.schedule)
        size = c["image_size"]
        self.shape = (m["num_slices"], size, size, c["unet"]["in_channels"])
        self.per_call = m["num_slices"]
        self._install_hooks()
        g = seeding.generator(self.seed, WARMUP, dev)
        self._sweep(torch.randn(self.shape, generator=g, device=dev), 2)
        self.mark("warm-up")

    def _sweep(self, x_t: torch.Tensor, steps: int) -> torch.Tensor:
        return sample_pseudo3d_sweep(
            self.net, self.diffusion, num_slices=self.mix["num_slices"],
            image_size=self.config["image_size"], x_t=x_t, ddim_steps=steps,
            sampler=self.mix["sampler"], channels=self.config["unet"]["in_channels"],
            device=self.device)

    def denoise(self, x_t: torch.Tensor) -> torch.Tensor:
        return self._sweep(x_t, self.mix["ddim_steps"])

    def finish(self, z: torch.Tensor) -> torch.Tensor:
        return z

    def traced_denoise(self) -> None:
        """The traced segment: one whole sweep call."""
        x = torch.randn(self.shape, generator=seeding.generator(self.seed, WARMUP, self.device),
                        device=self.device)
        self._sweep(x, self.mix["ddim_steps"])

    def _unet_ref(self, p, x, t, prec):
        z = torch.linspace(0.0, 1.0, self.mix["num_slices"], device=self.device)
        return nets.unet2d(p, self.config["unet"], x, t, z, prec)

    def counts(self) -> dict:
        meta = seeding.make_weights(self.net_spec, 0, 0, "meta")
        with ops.counting() as unit:
            nets.unet2d(meta, self.config["unet"], torch.empty(self.shape, device="meta"),
                        torch.zeros(self.shape[0], dtype=torch.long, device="meta"),
                        torch.zeros(self.shape[0], device="meta"))
        return {"forward": unit, "decode_flops_per_sample": 0}


KIND = Sweep2D
