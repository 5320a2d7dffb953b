"""The port's 2D and 2.5D drivers against ``mrijax``'s: ``run_experiment``
of both packages at tiny widths, the 2D family from the raw NIfTI tree and
the 2.5D family from ``pack_multimodal_slices`` shards. The same batches,
bitwise and in the same order, the same train and val steps and the same
run directory. The machinery is in ``tests/test_torch_experiments.py``."""

import pytest

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch.data import packing
from test_torch_experiments import (  # noqa: F401  (brats_root is a fixture)
    brats_root,
    latest_steps,
    run_both,
    run_layout,
    step_counts,
    assert_same_batches,
)

TINY_2D = {
    "data.image_size": 16, "data.batch_size": 4, "data.val_fraction": 0.25,
    "unet.base_channels": 8, "unet.channel_mults": (1, 2), "unet.time_emb_dim": 16,
    "unet.compute_dtype": "float32", "diffusion.timesteps": 10,
    "train.epochs": 2, "train.debug_fast": True, "train.debug_max_steps": 2,
    "train.cond_dropout": 0.1, "train.ema_decay": 0.9,
}


# 6 subjects of 20 slices: 96 central slices (72 at radius 2), subsampled
# to ⅓ (¼): 24 train and 8 val (14 and 4); 2 epochs capped at 2 steps each
@pytest.mark.parametrize("family, val_steps", [("slice_cond_2d", 4), ("ddpm_25d", 2)])
def test_2d_drivers_match_jax(monkeypatch, tmp_path, brats_root, family, val_steps):
    packed = None
    if family == "ddpm_25d":
        packed = tmp_path / "packed"
        packing.pack_multimodal_slices(brats_root, packed, image_size=16, use_device=False)
    results, logs, dirs = run_both(monkeypatch, tmp_path, family, brats_root, TINY_2D,
                                   packed_dir=packed)
    assert_same_batches(logs)
    counts = {"make_diffusion_train_step": 4, "make_diffusion_eval_step": val_steps}
    assert step_counts(logs["port"]) == step_counts(logs["jax"]) == counts
    batch = logs["port"][0][1]
    assert batch["image"].shape == (4, 16, 16, 1 if family == "slice_cond_2d" else 4)
    assert ("context" in batch) == (family == "ddpm_25d")
    assert run_layout(dirs["port"]) == run_layout(dirs["jax"]) == ["2", "4", "best",
                                                                   "best.json"]
    steps = latest_steps(dirs, ("",))
    assert steps["port"] == steps["jax"] == {"": 4}
    assert results["port"].epochs_run == results["jax"].epochs_run == 2
