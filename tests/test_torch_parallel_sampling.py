"""Data-parallel sampling (``mrijax_torch.parallel.sampling``) and the
``mesh=`` of the generators, under the JAX package's contract
(``tests/test_sharded_sampling.py``): the global result equals the
concatenation of the d one-process runs with the shards' generators
``(seed, 0..d-1)`` — reproducible from (seed, shard count), and dependent on
the shard count."""

import json

import numpy as np
import pytest
import torch

from _torch_mp_worker import launch
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.evals.harness import call_generator
from mrijax_torch.generate import (
    _chunk_seed,
    conditional_sample_25d,
    generate_3d_volumes,
    sample_2d,
)
from mrijax_torch.models import UNet2D
from mrijax_torch.parallel import shard_generator, sharded_sample

MODEL_KW = dict(in_channels=1, out_channels=1, base_channels=8, channel_mults=(1, 2),
                time_emb_dim=16)
SEED, NUM, SIZE, STEPS = 5, 4, 16, 3


def test_shard_generator_is_the_harness_generator():
    for seed, shard in ((0, 0), (5, 1), (123, 7)):
        a, b = shard_generator(seed, shard, "cpu"), call_generator(seed, shard, device="cpu")
        assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))


def test_one_process_is_a_world_of_one():
    """``mesh=None``: shard 0's generator, no collective, the cond passed on."""
    got = sharded_sample(None, lambda p, g, n: torch.rand(n, generator=g), None, SEED, 3,
                         device="cpu")
    assert torch.equal(got, torch.rand(3, generator=shard_generator(SEED, 0, "cpu")))
    cond = (torch.arange(4.0), torch.arange(8.0).reshape(4, 2), None)
    got = sharded_sample(None, lambda p, g, c: c[1][:, 0] + c[0], None, 0, 4, cond=cond,
                         device="cpu")
    assert torch.equal(got, torch.tensor([0.0, 3.0, 6.0, 9.0]))


def test_a_mesh_takes_no_generator_or_start():
    model = UNet2D(**MODEL_KW)
    diff = GaussianDiffusion(make_schedule(linear_beta_schedule(10)))
    with pytest.raises(ValueError, match="neither generator nor x_t"):
        sample_2d(model, diff, num_samples=2, image_size=SIZE, ddim_steps=1, mesh=object(),
                  generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="neither generator nor x_t"):
        generate_3d_volumes(model, model, diff, latent_spatial=(4, 4, 4), latent_channels=4,
                            x_t=torch.zeros(1, 4, 4, 4, 4), mesh=object(), device="cpu")


CTX_KW = dict(MODEL_KW, in_channels=12, out_channels=4)
SLICES = 9   # the default chunk of 4 slices a rank: 8 split over 2 ranks, then 1 whole


def test_sharded_sample_is_the_concatenation_of_the_shards(tmp_path):
    """``sample_2d(mesh=…)`` on two processes: every rank holds the 4 images,
    which are shard 0's and shard 1's one-process runs of 2 images each; the
    axis refuses a count it does not divide, with the JAX message.
    ``generate_pseudo3d_real_context(mesh=…)`` over 9 slices: the first chunk
    of 8 is split (shards of 4 from the chunk's seed), the ragged last slice
    runs whole on every rank with shard 0's generator of its own seed."""
    torch.manual_seed(0)
    model, model25 = UNet2D(**MODEL_KW), UNet2D(**CTX_KW)
    betas = linear_beta_schedule(20)
    diff = GaussianDiffusion(make_schedule(betas))
    rng = np.random.default_rng(2)
    slices = {"context": torch.from_numpy(
        rng.uniform(-1, 1, (SLICES, SIZE, SIZE, 8)).astype(np.float32)),
        "z_pos": torch.linspace(0, 1, SLICES)}
    outs, _ = launch("sharded_sample", 2, tmp_path, {
        "model_kw": MODEL_KW, "state_dict": model.state_dict(), "betas": betas, "num": NUM,
        "size": SIZE, "steps": STEPS, "seed": SEED, "ctx_kw": CTX_KW,
        "ctx_state": model25.state_dict(), "slices": slices})
    ctx = []
    for s0, shards in ((0, 2), (8, 1)):
        per = min(8, SLICES - s0) // shards
        for i in range(shards):
            sl = slice(s0 + i * per, s0 + (i + 1) * per)
            ctx.append(conditional_sample_25d(
                model25, diff, slices["z_pos"][sl], slices["context"][sl], ddim_steps=STEPS,
                generator=shard_generator(_chunk_seed(SEED, s0), i, "cpu"), device="cpu"))
    for out in outs:
        torch.testing.assert_close(out["real_context"], torch.cat(ctx), atol=1e-6, rtol=0)
    want = torch.cat([sample_2d(model, diff, num_samples=NUM // 2, image_size=SIZE,
                                ddim_steps=STEPS, generator=shard_generator(SEED, i, "cpu"),
                                device="cpu") for i in range(2)])
    whole = sample_2d(model, diff, num_samples=NUM, image_size=SIZE, ddim_steps=STEPS,
                      generator=shard_generator(SEED, 0, "cpu"), device="cpu")
    for out in outs:
        torch.testing.assert_close(out["grid"], want, atol=1e-6, rtol=0)
        assert "num_samples 3 is not divisible by mesh axis 'data' of size 2" in out["error"]
    assert not torch.allclose(outs[0]["grid"], whole)   # depends on the shard count


def test_cli_eval_and_sample_data_parallel_on_two_processes(tmp_path, monkeypatch):
    """``eval --data-parallel`` and ``sample --data-parallel`` of a tiny 2D run
    on two processes: the sampling batch split over the ranks, both ranks
    report the same metrics, rank 0 alone writes the report and the grid."""
    from mrijax_torch import cli
    from mrijax_torch.data import synthetic

    monkeypatch.chdir(tmp_path)
    synthetic.write_synthetic_brats(tmp_path / "brats", num_subjects=3, shape=(32, 32, 20))
    cli.main(["--device", "cpu", "train", "--preset", "slice_cond_2d", "--root-dir",
              str(tmp_path / "brats"), "--name", "t", "--set", "data.image_size=16",
              "unet.base_channels=8", "unet.channel_mults=[1,2]", "unet.time_emb_dim=16",
              "diffusion.timesteps=20", "train.debug_fast=true", "train.debug_max_steps=2",
              "train.epochs=1", "data.batch_size=4", f"train.checkpoint_dir={tmp_path / 'ck'}"])
    run = str(tmp_path / "ck" / "slice_cond_2d" / "t")
    outs, _ = launch("cli", 2, tmp_path / "mp", {"argvs": [
        ["--device", "cpu", "eval", "--run-dir", run, "--num-samples", "8", "--batch-size", "4",
         "--ddim-steps", "2", "--diversity-pairs", "2", "--split", "all", "--data-parallel",
         "--out", str(tmp_path / "eval" / "metrics.json")],
        ["--device", "cpu", "sample", "--run-dir", run, "--num-samples", "4", "--ddim-steps",
         "2", "--data-parallel", "--out-dir", str(tmp_path / "grid")]]})
    (rc0, eval0), (rc1, eval1) = outs[0]["printed"][0], outs[1]["printed"][0]
    assert rc0 == rc1 == 0
    assert "data-parallel sampling over 2 processes" in eval0
    assert "[cli] wrote" in eval0 and "[cli] wrote" not in eval1
    reports = [json.loads(text[text.index("{"):text.rindex("}") + 1]) for text in (eval0, eval1)]
    for report in reports:
        report.pop("eval_seconds")
    assert reports[0] == reports[1] and reports[0]["num_samples"] == 8
    assert (tmp_path / "eval" / "metrics.json").exists() and (tmp_path / "grid" / "grid.png").exists()
    assert "wrote" in outs[0]["printed"][1][1] and "wrote" not in outs[1]["printed"][1][1]
