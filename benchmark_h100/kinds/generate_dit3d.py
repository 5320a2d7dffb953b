"""Kind ``generate_dit3d``: ``generate_3d``'s closed loop of 3D generate calls
(``GaussianDiffusion.ddim_sample`` over the latent, then
``VAE3D.decode_from_latent`` ``decode_chunk`` latents at a time) with the
transformer denoiser ``mrijax_torch.models.DiT3D`` in the UNet's place. Only
the network, its reference (``reference/dit3d.py``) and the counts differ;
the window, the traced segment and the judge are ``Generate3D``'s."""

from typing import Dict

import torch

from mrijax_torch.diffusion import GaussianDiffusion
from mrijax_torch.models import VAE3D, DiT3D

from benchmark_h100 import seeding
from benchmark_h100.count import ops
from benchmark_h100.kind_base import VAE_KEYS, WARMUP, _kw
from benchmark_h100.kinds.generate_3d import Generate3D
from benchmark_h100.reference import dit3d, nets


def dit_kwargs(config: dict) -> Dict[str, object]:
    """``DiT3D``'s arguments from the configuration file's DiT keys."""
    return dict(in_channels=config["in_channels"], patch=config["patch_size"],
                hidden=config["hidden_size"], depth=config["depth"],
                heads=config["num_heads"], mlp_ratio=config["mlp_ratio"],
                freq_dim=config["frequency_embedding_size"])


class GenerateDiT3D(Generate3D):
    def setup(self) -> None:
        c, m, dev = self.config, self.mix, self.device
        with dev:
            self.net = DiT3D(**dit_kwargs(c), dtype=self.dtype).eval()
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
        self.shape = (m["batch"], *c["latent"], c["in_channels"])
        self.per_call = m["batch"]
        self._install_hooks()
        # warm-up: every shape of the timed path — two denoise steps and the decode
        g = seeding.generator(self.seed, WARMUP, dev)
        with torch.no_grad():
            self.finish(self.diffusion.ddim_sample(self.net, self.shape, x_t=torch.randn(
                self.shape, generator=g, device=dev), start_t=2))
        self.mark("warm-up")

    def _unet_ref(self, p, x, t, prec):
        return dit3d.dit3d(p, self.config, x, t, prec)

    def counts(self) -> dict:
        c = self.config
        meta = seeding.make_weights(self.net_spec, 0, 0, "meta")
        with ops.counting() as unit:
            dit3d.dit3d(meta, c, torch.empty(self.shape, device="meta"),
                        torch.zeros(self.shape[0], dtype=torch.long, device="meta"))
        meta_v = seeding.make_weights(self.vae_spec, 0, 0, "meta")
        with ops.counting() as dec:
            nets.vae3d_decode(meta_v, torch.empty(
                (1, *c["latent"], c["vae"]["latent_channels"]), device="meta"))
        return {"forward": unit, "decode_flops_per_sample": dec.total_flops}


KIND = GenerateDiT3D
