"""Minimal unconditional 2D DDPM on the PyTorch port: the same run as
``examples/minimal_2d_ddpm.py``, from ``mrijax_torch``.

Trains a tiny UNet on synthetic BraTS slices for a couple of epochs, prints
the loss curve, and writes a DDIM sample grid — the one-file end-to-end
smoke demo of the framework's core loop. Every draw comes from an explicit
``torch.Generator`` on the device.

Usage: python examples/torch_minimal_2d_ddpm.py [--epochs 2] [--out grid.png]
       [--device cuda|cpu]
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

# allow running straight from a checkout: python examples/<script>.py
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--out", default="minimal_ddpm_grid.png")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (no move to the CPU unasked)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from mrijax_torch._device import require_device
    from mrijax_torch.data import BatchLoader, SliceDataset2D
    from mrijax_torch.data.synthetic import write_synthetic_brats
    from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
    from mrijax_torch.io.images import save_grid_png
    from mrijax_torch.models import UNet2D
    from mrijax_torch.train import create_train_state, make_diffusion_train_step

    dev = require_device(args.device)
    root = write_synthetic_brats(
        tempfile.mkdtemp(prefix="brats_mini_"), num_subjects=2, shape=(32, 32, 20)
    )
    ds = SliceDataset2D(root, image_size=args.image_size)
    loader = BatchLoader(ds, batch_size=8, device=dev)
    print(f"dataset: {len(ds)} slices; device: {dev}")

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UNet2D(in_channels=1, out_channels=1, base_channels=8,
                       channel_mults=(1, 2), time_emb_dim=16)
    diffusion = GaussianDiffusion(make_schedule(linear_beta_schedule(50)))
    state = create_train_state(model, 2e-3, device=dev)
    step = make_diffusion_train_step(model, diffusion)
    generator = torch.Generator(device=dev).manual_seed(0)

    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        losses = []
        t0 = time.time()
        for batch in loader:
            state, loss = step(state, batch, generator)
            losses.append(float(loss))
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"({len(losses)} steps, {time.time()-t0:.1f}s)")

    model.eval()

    @torch.no_grad()
    def model_fn(x, t):
        return model(x, t, torch.full((x.shape[0],), 0.5, device=x.device))

    grid = diffusion.ddim_sample(
        model_fn, (16, args.image_size, args.image_size, 1),
        torch.Generator(device=dev).manual_seed(1), num_steps=10,
    )
    save_grid_png(args.out, grid[..., 0].cpu().numpy(), nrow=4)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
