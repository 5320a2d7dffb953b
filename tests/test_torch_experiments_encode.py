"""The port's 3D driver against ``mrijax``'s on the stage-2 route that
encodes every batch with the frozen VAE (``cache_latents`` off), from the
raw NIfTI tree: the same batches, bitwise and in the same order, the same
steps per stage and run directory, and with ``learning_rate`` 0 the same
latent scale (``SCALE_RTOL``). The machinery is in
``tests/test_torch_experiments.py``."""

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from test_torch_experiments import (  # noqa: F401  (brats_root is a fixture)
    TINY_3D,
    assert_3d_run,
    brats_root,
    run_both,
)


def test_3d_encode_per_step_route_matches_jax(monkeypatch, tmp_path, brats_root):
    results, logs, dirs = run_both(monkeypatch, tmp_path, "ddpm_3d_ldm", brats_root,
                                   {**TINY_3D, "train.cache_latents": False})
    # stage 2 runs over stage 1's volume loaders, at batch 1
    assert_3d_run(results, logs, dirs, {"make_latent_diffusion_train_step": 2,
                                        "make_latent_diffusion_eval_step": 2})
    assert logs["port"][-1][1]["volume"].shape == (1, 8, 16, 16, 4)
    assert not (dirs["port"] / "latent_cache").exists()
