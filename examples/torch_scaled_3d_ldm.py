"""3D LDM on the PyTorch port: cached-latent training and data-parallel
sampling end to end — the run of ``examples/scaled_3d_ldm.py``, from
``mrijax_torch``.

1. synthesize a tiny BraTS tree;
2. train the two-stage 3D LDM with ``train.cache_latents=True`` (the VAE
   encodes each volume once, stage 2 trains from latent crops);
3. sample volumes data-parallel over the process group
   (``parallel.sharded_sample`` through ``generate.generate_3d_volumes``)
   and write mid-slice panels.

A plain run is a world of one: the script makes a process group of one
(``file://`` rendezvous) so that the sharded path runs. Under ``torchrun
--nproc_per_node N`` every rank joins torchrun's group, trains data
parallel and denoises its own volume; rank 0 writes the panels.

CPU-friendly sizes. On the card the bottleneck attention (16 channels, 4
heads: Dh = 4) runs the flash kernels, padded to their head dim of 32.

Usage: python examples/torch_scaled_3d_ldm.py [--out-dir out/] [--device cuda|cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models run (no move to the CPU unasked)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from mrijax_torch import parallel
    from mrijax_torch._device import require_device
    from mrijax_torch.config import preset_ddpm_3d_ldm
    from mrijax_torch.data.synthetic import write_synthetic_brats
    from mrijax_torch.generate import generate_3d_volumes, latent_shape_for
    from mrijax_torch.io.images import save_png, volume_midslice_panel
    from mrijax_torch.parallel import make_mesh
    from mrijax_torch.train.experiments import build_diffusion, run_experiment

    require_device(args.device)
    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="mrijax_torch_3d_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    # torchrun's group where it started this process, else a group of one
    started = not dist.is_initialized()
    parallel.initialize(device=args.device)
    rendezvous = None
    if not dist.is_initialized():
        rendezvous = tempfile.TemporaryDirectory(prefix="mrijax_torch_rdv_")
        parallel.initialize(f"file://{Path(rendezvous.name) / 'rendezvous'}", 1, 0,
                            device=args.device)
    dev = require_device(args.device)
    try:
        root = write_synthetic_brats(
            tempfile.mkdtemp(), num_subjects=3, shape=(32, 32, 20), seed=0
        )
        cfg = preset_ddpm_3d_ldm(str(root))
        cfg.name = "scaled_demo"
        cfg.data.patch_size = (16, 16, 16)
        cfg.data.batch_size = 2
        # train.num_devices is not set: the port trains over every process of
        # the group and refuses a count that differs from it
        cfg.vae.base_channels = 8
        cfg.vae.num_down = 2
        cfg.vae.latent_channels = 4
        cfg.unet.in_channels = cfg.vae.latent_channels
        cfg.unet.base_channels = 8
        cfg.unet.channel_mults = (1, 2)
        cfg.unet.time_emb_dim = 16
        cfg.unet.compute_dtype = "float32"
        cfg.vae.compute_dtype = "float32"
        cfg.diffusion.timesteps = 20
        cfg.vae_train.epochs = 1
        cfg.train.epochs = 1
        cfg.train.debug_fast = True
        cfg.train.debug_max_steps = 3
        cfg.train.cache_latents = True        # <- encode once, train from crops
        cfg.data.latent_batch_size = 2        # stage-2 batch, independent of VAE
        cfg.train.nan_guard = True
        cfg.train.checkpoint_dir = str(out_dir / "ckpt")

        vae_res, ldm_res, latent_scale = run_experiment(cfg, device=dev)
        print(f"[demo] two-stage training done; latent_scale={latent_scale:.3f}")

        # the trained models, sampled over every process of the group
        vae, unet = vae_res.state.model, ldm_res.state.model
        diffusion = build_diffusion(cfg.diffusion)
        mesh = make_mesh(("data",))
        n = mesh.size()
        lat = latent_shape_for(vae, (*cfg.data.patch_size, cfg.vae.in_channels), device=dev)
        vols = generate_3d_volumes(
            unet, vae, diffusion, num_volumes=n, latent_spatial=lat[:-1],
            latent_channels=lat[-1], latent_scale=latent_scale, ddim_steps=5,
            mesh=mesh, seed=0, device=dev,
        ).cpu().numpy()
        if not np.isfinite(vols).all():
            raise SystemExit("[demo] sampled volumes are not finite")
        if parallel.process_index() == 0:
            for i in range(min(2, len(vols))):
                save_png(out_dir / f"vol{i}.png", volume_midslice_panel(vols[i]))
        print(f"[demo] sampled {len(vols)} volumes over {n} process(es) -> {out_dir}")
    finally:
        if started:
            parallel.shutdown()
        if rendezvous is not None:
            rendezvous.cleanup()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
