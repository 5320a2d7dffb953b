"""Kind ``generate_3d``: a closed loop of 3D generate calls. A call is the
batch's start noise drawn from the seed, ``GaussianDiffusion.ddim_sample``
over the latent and ``VAE3D.decode_from_latent`` ``decode_chunk`` latents at
a time (the composition of ``mrijax_torch/bench.py::sample_volumes``)."""

from typing import Dict

import torch

from mrijax_torch.diffusion import GaussianDiffusion
from mrijax_torch.models import UNet3D, VAE3D

from benchmark_h100 import judge, seeding
from benchmark_h100.count import ops
from benchmark_h100.kind_base import UNET3D_KEYS, VAE_KEYS, WARMUP, Generate, _kw
from benchmark_h100.reference import nets


class Generate3D(Generate):
    program_attrs = ("net", "vae", "diffusion")

    def setup(self) -> None:
        c, m, dev = self.config, self.mix, self.device
        with dev:
            self.net = UNet3D(**_kw(c["unet"], UNET3D_KEYS), dtype=self.dtype).eval()
            self.vae = VAE3D(**_kw(c["vae"], VAE_KEYS), dtype=self.dtype).eval()
        self.mark("modules")
        self.net_spec = seeding.param_spec(self.net)
        self.vae_spec = seeding.param_spec(self.vae)
        seeding.load_weights(self.net, seeding.make_weights(
            self.net_spec, self.seed, seeding.WEIGHTS_UNET, dev))
        seeding.load_weights(self.vae, seeding.make_weights(
            self.vae_spec, self.seed, seeding.WEIGHTS_VAE, dev))
        self.mark("weights")
        self.diffusion = GaussianDiffusion(self.schedule)
        self.shape = (m["batch"], *c["latent"], c["unet"]["in_channels"])
        self.per_call = m["batch"]
        self._install_hooks()
        # warm-up: every shape of the timed path — two denoise steps and the decode
        g = seeding.generator(self.seed, WARMUP, dev)
        with torch.no_grad():
            self.finish(self.diffusion.ddim_sample(self.net, self.shape, x_t=torch.randn(
                self.shape, generator=g, device=dev), start_t=2))
        self.mark("warm-up")

    def denoise(self, x_t: torch.Tensor) -> torch.Tensor:
        return self.diffusion.ddim_sample(self.net, self.shape, x_t=x_t,
                                          num_steps=self.mix["ddim_steps"])

    def finish(self, z: torch.Tensor) -> torch.Tensor:
        chunk = self.mix["decode_chunk"]
        return torch.cat([self.vae.decode_from_latent(z[i:i + chunk])
                          for i in range(0, z.shape[0], chunk)])

    def traced_denoise(self) -> None:
        """The traced segment: the last skip + active steps of a T-step chain."""
        x = torch.randn(self.shape, generator=seeding.generator(self.seed, WARMUP, self.device),
                        device=self.device)
        prof = self.mix["profile"]
        self.diffusion.ddim_sample(self.net, self.shape, x_t=x,
                                   start_t=prof["skip"] + prof["active"])

    def _unet_ref(self, p, x, t, prec):
        return nets.unet3d(p, self.config["unet"], x, t, prec)

    def _judge_output(self, control: bool) -> Dict[str, float]:
        pv = seeding.make_weights(self.vae_spec, self.seed, seeding.WEIGHTS_VAE, self.device)
        worst = 0.0
        chunk = self.mix["check"]["decode_chunk"]
        with torch.no_grad():
            for call in self.checked:
                z = call["next"][len(self._steps()) - 1]
                for i in range(0, z.shape[0], chunk):
                    want = nets.vae3d_decode(pv, z[i:i + chunk], "fp32")
                    got = (nets.vae3d_decode(pv, z[i:i + chunk], "fp8") if control
                           else call["out"][i:i + chunk])
                    worst = max(worst, judge.rel_rows(got, want))
                    del want, got
        return {"decode_rel_err": worst}

    def counts(self) -> dict:
        c = self.config
        meta = seeding.make_weights(self.net_spec, 0, 0, "meta")
        with ops.counting() as unit:
            nets.unet3d(meta, c["unet"], torch.empty(self.shape, device="meta"),
                        torch.zeros(self.shape[0], dtype=torch.long, device="meta"))
        meta_v = seeding.make_weights(self.vae_spec, 0, 0, "meta")
        with ops.counting() as dec:
            nets.vae3d_decode(meta_v, torch.empty(
                (1, *c["latent"], c["vae"]["latent_channels"]), device="meta"))
        return {"forward": unit, "decode_flops_per_sample": dec.total_flops}


KIND = Generate3D
