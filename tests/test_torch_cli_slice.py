"""The slice as a whole through the entry points a user types: the port's
``train`` (2D, 2.5D and a 2-epoch 3D run) → ``info`` → ``sample`` in every
mode → ``export`` → ``export-aot`` → ``serve``, plus ``eval`` /
``eval-multi``, all with ``--device cpu`` at 16² (base 8, mults (1, 2)).

What ``sample`` and ``serve`` write equals a direct call of the port's
library on the exported weights with the documented generators
(``call_generator(seed, b)``), bitwise: the CLI adds no arithmetic of its
own. ``train`` writes ``config.json`` and the ``energy_*`` metrics that
``obs.analyze`` reads (the JAX analyzer gives the same report).
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.obs import analyze as janalyze
from mrijax_torch import cli, generate
from mrijax_torch.config import ExperimentConfig
from mrijax_torch.data import MultiModalSliceDataset25D, VolumeDataset3D, nifti
from mrijax_torch.data.synthetic import write_synthetic_brats
from mrijax_torch.evals.harness import call_generator
from mrijax_torch.io import load_params_npz
from mrijax_torch.obs import analyze
from mrijax_torch.train.experiments import build_diffusion, build_unet2d, build_unet3d, build_vae3d

SEED = 3
TINY = ["data.image_size=16", "unet.base_channels=8", "unet.channel_mults=[1,2]",
        "unet.time_emb_dim=16", "unet.compute_dtype=\"float32\"", "diffusion.timesteps=20",
        "train.debug_fast=true", "train.debug_max_steps=2", "train.epochs=1",
        "data.batch_size=4", "train.ema_decay=0.9", "train.checkpoint_dir=ckpt"]
TINY_3D = ["data.patch_size=[16,16,16]", "vae.base_channels=8", "vae.num_down=2",
           "vae.latent_channels=4", "vae.compute_dtype=\"float32\"", "unet.in_channels=4",
           "unet.out_channels=4", "unet.base_channels=8", "unet.channel_mults=[1,2]",
           "unet.time_emb_dim=16", "unet.num_heads=2", "unet.compute_dtype=\"float32\"",
           "diffusion.timesteps=6", "train.debug_fast=true", "train.debug_max_steps=2",
           "train.epochs=2", "vae_train.debug_fast=true", "vae_train.debug_max_steps=2",
           "vae_train.epochs=1", "train.checkpoint_dir=ckpt", "data.batch_size=1",
           "data.latent_batch_size=2", "train.cache_latents=true"]
RUNS = {"slice_cond_2d": ("slice_cond_2d", TINY),
        "ddpm_25d": ("ddpm_25d", TINY),
        "ddpm_3d_ldm": ("ddpm_3d_ldm", TINY_3D)}


def port(*argv):
    return cli.main(["--device", "cpu", *map(str, argv)])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The three runs trained through ``train`` in a fresh directory (the
    metrics logger writes ``runs/`` under the working directory)."""
    root = tmp_path_factory.mktemp("cli_slice")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        brats = write_synthetic_brats(root / "brats", num_subjects=3, shape=(32, 32, 20))
        for family, (preset, tiny) in RUNS.items():
            assert port("train", "--preset", preset, "--root-dir", brats, "--name", "t",
                        "--set", *tiny) == 0
        yield root
    finally:
        os.chdir(cwd)


def run_dir(work, family):
    return work / "ckpt" / family / "t"


def exported(work, family):
    """``export``'s npz of a run (written once)."""
    out = work / f"{family}.npz"
    if not out.exists():
        assert port("export", "--run-dir", run_dir(work, family), "--out", out) == 0
    return out


def loaded(model, npz):
    weights, meta = load_params_npz(npz)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
    return model.eval(), meta


def config(work, family):
    return ExperimentConfig.from_json(run_dir(work, family) / "config.json")


@pytest.mark.parametrize("family", list(RUNS))
def test_train_writes_config_metrics_and_energy(work, family, capsys):
    cfg = config(work, family)
    assert cfg.family == family and cfg.name == "t" and cfg.data.root_dir.endswith("brats")
    assert port("info", "--run-dir", run_dir(work, family)) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed[:printed.rindex("}") + 1]) == json.loads(cfg.to_json())
    subs = ("vae", "ldm") if family == "ddpm_3d_ldm" else ("",)
    assert all(f"{run_dir(work, family) / s if s else run_dir(work, family)}: latest="
               in printed for s in subs)
    metrics = work / "runs" / family / "t"
    records = [json.loads(l) for l in (metrics / "metrics.jsonl").read_text().splitlines()]
    energy = {r["key"]: r["value"] for r in records if r["key"].startswith("energy_")}
    assert set(energy) == {f"energy_{k}" for k in (
        "runtime_s", "avg_power_w", "energy_joules", "energy_kwh", "co2_kg", "cost_eur",
        "device_busy_s", "device_idle_fraction")}
    # no sensor on the CPU: power and energy are honest zeros; the busy time
    # is the trainer's step time
    assert energy["energy_avg_power_w"] == 0.0 and energy["energy_runtime_s"] > 0
    assert 0 < energy["energy_device_busy_s"] <= energy["energy_runtime_s"]
    report = analyze.analyze_run(metrics)
    assert report == janalyze.analyze_run(metrics)
    assert ({"vae", "ldm"} if family == "ddpm_3d_ldm" else {"train"}) <= set(report)
    if family == "ddpm_3d_ldm":
        assert report["ldm"]["epochs"] == 2


def _record(monkeypatch, name):
    """Wrap ``generate.<name>`` so the test sees what the CLI got back."""
    seen = []
    fn = getattr(generate, name)

    def wrapped(*a, **kw):
        seen.append(fn(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(generate, name, wrapped)
    return seen


SAMPLE_2D = {
    "grid": (["--num-samples", "3", "--ddim-steps", "4", "--z-pos", "0.3"], "sample_2d",
             dict(num_samples=3, image_size=16, z_pos=0.3, ddim_steps=4)),
    "grid-guided": (["--num-samples", "2", "--ddim-steps", "3", "--guidance-scale", "3"],
                    "sample_2d", dict(num_samples=2, image_size=16, ddim_steps=3,
                                      guidance_scale=3.0)),
    "grid-full-T": (["--num-samples", "2"], "sample_2d", dict(num_samples=2, image_size=16)),
    "sweep": (["--mode", "sweep", "--num-slices", "5", "--ddim-steps", "3", "--sampler", "dpm"],
              "sample_pseudo3d_sweep", dict(num_slices=5, image_size=16, ddim_steps=3,
                                            sampler="dpm")),
}


@pytest.mark.parametrize("case", list(SAMPLE_2D))
def test_sample_2d_equals_the_library(work, tmp_path, monkeypatch, case):
    argv, name, kw = SAMPLE_2D[case]
    seen = _record(monkeypatch, name)
    assert port("sample", "--run-dir", run_dir(work, "slice_cond_2d"), "--seed", SEED,
                "--out-dir", tmp_path, *argv) == 0
    cfg = config(work, "slice_cond_2d")
    model, _ = loaded(build_unet2d(cfg.unet), exported(work, "slice_cond_2d"))
    monkeypatch.undo()
    want = getattr(generate, name)(model, build_diffusion(cfg.diffusion),
                                   generator=call_generator(SEED, 0, device="cpu"),
                                   device="cpu", **kw)
    assert len(seen) == 1 and torch.equal(seen[0], want)
    if name == "sample_pseudo3d_sweep":
        np.testing.assert_array_equal(nifti.load(tmp_path / "sweep.nii.gz"), want[..., 0].numpy())
    assert (tmp_path / ("sweep.png" if name != "sample_2d" else "grid.png")).exists()


@pytest.mark.parametrize("mode", ["pseudo3d-real", "pseudo3d-hybrid"])
def test_sample_25d_equals_the_library(work, tmp_path, mode):
    assert port("sample", "--run-dir", run_dir(work, "ddpm_25d"), "--mode", mode,
                "--ddim-steps", "2", "--seed", SEED, "--guidance-scale", "2",
                "--out-dir", tmp_path) == 0
    cfg = config(work, "ddpm_25d")
    model, _ = loaded(build_unet2d(cfg.unet), exported(work, "ddpm_25d"))
    ds = MultiModalSliceDataset25D(cfg.data.root_dir, 16, cfg.data.slice_radius)
    fn = (generate.generate_pseudo3d_real_context if mode == "pseudo3d-real"
          else generate.generate_pseudo3d_hybrid)
    want = fn(model, build_diffusion(cfg.diffusion), ds, 0, ddim_steps=2, guidance_scale=2.0,
              generator=call_generator(SEED, 0, device="cpu"), device="cpu")
    np.testing.assert_array_equal(nifti.load(tmp_path / f"{mode}.nii.gz"), want.numpy())
    assert all((tmp_path / f"{mode}_mod{c}.png").exists() for c in range(4))


def _models_3d(work):
    cfg = config(work, "ddpm_3d_ldm")
    npz = exported(work, "ddpm_3d_ldm")
    unet, meta = loaded(build_unet3d(cfg.unet), npz)
    vae, vmeta = loaded(build_vae3d(cfg.vae), npz.with_suffix(".vae.npz"))
    assert meta["family"] == "ddpm_3d_ldm" and vmeta["family"] == "vae3d"
    return cfg, unet, vae, meta["latent_scale"]


def test_sample_3d_equals_the_library(work, tmp_path):
    assert port("sample", "--run-dir", run_dir(work, "ddpm_3d_ldm"), "--mode", "volume3d",
                "--num-samples", "2", "--ddim-steps", "3", "--seed", SEED,
                "--out-dir", tmp_path) == 0
    assert port("sample", "--run-dir", run_dir(work, "ddpm_3d_ldm"), "--mode", "diagnostics",
                "--seed", SEED, "--out-dir", tmp_path) == 0
    cfg, unet, vae, scale = _models_3d(work)
    diffusion = build_diffusion(cfg.diffusion)
    want = generate.generate_3d_volumes(
        unet, vae, diffusion, num_volumes=2, latent_spatial=(8, 8, 8), latent_channels=4,
        latent_scale=scale, generator=call_generator(SEED, 0, device="cpu"), ddim_steps=3,
        device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(nifti.load(tmp_path / f"volume{i}.nii.gz"),
                                      want[i].numpy())
    ds = VolumeDataset3D(cfg.data.root_dir, cfg.data.patch_size, random_crop=False)
    real = torch.from_numpy(np.stack([ds[i]["volume"] for i in range(2)]))
    diag = generate.Vae3dDiagnostics(unet, vae, diffusion, latent_scale=scale, device="cpu")
    gen = call_generator(SEED, 0, device="cpu")
    report = json.loads((tmp_path / "diagnostics.json").read_text())
    assert report == json.loads(json.dumps({
        "recon_l1": diag.reconstruction(real)[1], "latent_stats": diag.latent_stats(real),
        "noising_roundtrip_l1": {str(k): v for k, v in
                                 diag.noising_roundtrip(real, generator=gen).items()},
        "eps_mse_by_t": {str(k): v for k, v in diag.eps_mse_by_t(real, generator=gen).items()},
    }))


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_export_aot_and_serve_2d(work, tmp_path, monkeypatch, capsys, sampler):
    """Served batch b equals ``sample_2d`` with ``call_generator(seed, b)``
    on the exported weights; batch 0 also equals ``sample --mode grid``.
    ``--sampler dpm`` is kept in the program (the JAX CLI's 2D export drops
    it)."""
    run = run_dir(work, "slice_cond_2d")
    program = tmp_path / "p.pt2"
    assert port("export-aot", "--run-dir", run, "--out", program, "--num-samples", "3",
                "--ddim-steps", "4", "--sampler", sampler) == 0
    assert "AOT sampling programs" in capsys.readouterr().out
    npz = exported(work, "slice_cond_2d")
    assert port("serve", "--program", program, "--weights", npz, "--out", tmp_path / "s",
                "--batches", "2", "--seed", SEED) == 0
    assert "served 2 batch(es) of 3" in capsys.readouterr().out
    cfg = config(work, "slice_cond_2d")
    model, _ = loaded(build_unet2d(cfg.unet), npz)
    for b in range(2):
        with np.load(tmp_path / "s" / f"b{b:03d}.npz") as f:
            got, z = f["samples"], f["z_pos"]
        want = generate.sample_2d(model, build_diffusion(cfg.diffusion), num_samples=3,
                                  image_size=16, ddim_steps=4, sampler=sampler, device="cpu",
                                  generator=call_generator(SEED, b, device="cpu"))
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(z, np.full(3, 0.5, np.float32))
    seen = _record(monkeypatch, "sample_2d")
    assert port("sample", "--run-dir", run, "--num-samples", "3", "--ddim-steps", "4",
                "--sampler", sampler, "--seed", SEED, "--out-dir", tmp_path) == 0
    with np.load(tmp_path / "s" / "b000.npz") as f:
        np.testing.assert_array_equal(f["samples"], seen[0].numpy())


def test_export_aot_and_serve_3d(work, tmp_path, capsys):
    program = tmp_path / "v.pt2"
    assert port("export-aot", "--run-dir", run_dir(work, "ddpm_3d_ldm"), "--out", program,
                "--num-samples", "2", "--ddim-steps", "3") == 0
    npz = exported(work, "ddpm_3d_ldm")
    assert port("serve", "--program", program, "--weights", npz, "--out", tmp_path / "s",
                "--seed", SEED) == 0
    assert "served 1 batch(es) of 2" in capsys.readouterr().out
    cfg, unet, vae, scale = _models_3d(work)
    want = generate.generate_3d_volumes(
        unet, vae, build_diffusion(cfg.diffusion), num_volumes=2, latent_spatial=(8, 8, 8),
        latent_channels=4, latent_scale=scale, ddim_steps=3, device="cpu",
        generator=call_generator(SEED, 0, device="cpu"))
    for j in range(2):
        np.testing.assert_array_equal(nifti.load(tmp_path / "s" / f"b000_v{j}.nii.gz"),
                                      want[j].numpy())
        assert (tmp_path / "s" / f"b000_v{j}_midslices.png").exists()


def test_eval_and_eval_multi(work, tmp_path, capsys):
    """``eval`` labels the fast sampler and gives the keys of ``evaluate_runs``
    (plus the two sampler labels); ``eval-multi`` exits 1 only when every run
    failed."""
    run = run_dir(work, "slice_cond_2d")
    settings = dict(num_samples=8, batch_size=4, ddim_steps=2, diversity_pairs=2)
    out = tmp_path / "eval.json"
    assert port("eval", "--run-dir", run, "--split", "all", "--pr", "--out", out,
                *[a for k, v in settings.items() for a in (f"--{k.replace('_', '-')}", v)]) == 0
    report = json.loads(out.read_text())
    assert report["sampler"] == "ddim-2" and report["sampler_is_reference_protocol"] is False
    cfg_list = tmp_path / "runs.json"
    cfg_list.write_text(json.dumps([{"run_dir": str(run), "name": "a", "split": "all",
                                     "compute_pr": True, **settings},
                                    {"run_dir": str(tmp_path / "missing"), "name": "b"}]))
    assert port("eval-multi", "--config", cfg_list, "--out-dir", tmp_path / "multi") == 0
    multi = json.loads((tmp_path / "multi" / "a.metrics.json").read_text())
    assert set(report) - set(multi) == {"sampler", "sampler_is_reference_protocol"}
    assert set(multi) <= set(report) and "fid_rand" in multi
    summary = json.loads((tmp_path / "multi" / "summary.json").read_text())
    assert "error" in summary["b"] and "error" not in summary["a"]
    cfg_list.write_text(json.dumps([{"run_dir": str(tmp_path / "missing")}]))
    assert port("eval-multi", "--config", cfg_list, "--out-dir", tmp_path / "m2") == 1
    cfg_list.write_text(json.dumps({"runs": "not a list"}))
    with pytest.raises(SystemExit, match="JSON list"):
        port("eval-multi", "--config", cfg_list, "--out-dir", tmp_path / "m3")


def test_import_torch_3d_feeds_sample(tmp_path):
    """The reference 3D pair (VAE raw, LDM in ``{"state_dict": ...}``) →
    ``import-torch`` → ``sample --mode volume3d`` from the imported run; the
    latent scale travels in the LDM checkpoint."""
    from test_torch_parity_3d import TUNet3D, TVAE3D

    torch.manual_seed(0)
    vae_pt, ldm_pt = tmp_path / "vae3d_final.pt", tmp_path / "3d_ldm_diffusion_best.pt"
    torch.save(TVAE3D(cin=4, base=8, num_down=2, latent=4).state_dict(), vae_pt)
    torch.save({"state_dict": TUNet3D(cin=4, base=8, mults=(1, 2), tdim=16, heads=2)
                .state_dict()}, ldm_pt)
    tiny = [s for s in TINY_3D if not s.startswith(("train.", "vae_train.", "data.b",
                                                     "data.l"))]
    run = tmp_path / "imported"
    assert port("import-torch", "--preset", "ddpm_3d_ldm", "--checkpoint", ldm_pt,
                "--vae-checkpoint", vae_pt, "--latent-scale", "1.7", "--out", run,
                "--set", *tiny) == 0
    assert port("sample", "--run-dir", run, "--num-samples", "1", "--ddim-steps", "2",
                "--out-dir", tmp_path / "vols") == 0
    assert np.isfinite(nifti.load(tmp_path / "vols" / "volume0.nii.gz")).all()
    assert port("export", "--run-dir", run, "--out", tmp_path / "w.npz") == 0
    assert load_params_npz(tmp_path / "w.npz")[1]["latent_scale"] == 1.7
    with pytest.raises(SystemExit, match="vae-checkpoint"):
        port("import-torch", "--preset", "ddpm_3d_ldm", "--checkpoint", ldm_pt,
             "--out", tmp_path / "x", "--set", *tiny)
