"""``mrijax_torch.evals.evaluate_runs`` on run directories of the port's own
trainer: ``run_experiment`` of both 2D families at a tiny size from a
synthetic raw NIfTI tree (as ``tests/test_torch_experiments_2d.py`` trains
them), with the ``config.json`` the CLI's ``train`` writes beside the
checkpoints. The per-model ``metrics.json`` and ``summary.json``, the
breadcrumbs, duplicate names, a bad weights path, the pretrained-weights
route, and the device rule."""

import functools
import json

import numpy as np
import pytest
import torch

from torch_replicas import InceptionV3Trunk, LPIPSAlexReplica, ResNet18Trunk, randomize_

from mrijax_torch import config
from mrijax_torch.data import synthetic
from mrijax_torch.evals import (
    FeatureExtractor,
    InceptionFeatureExtractor,
    evaluate_conditional_2d,
    evaluate_runs,
    multi,
)
from mrijax_torch.io import (
    convert_inception_v3,
    convert_lpips_alex,
    convert_resnet18,
    save_params_npz,
)
from mrijax_torch.obs import MetricsLogger, reset_termination
from mrijax_torch.train import experiments

TINY = {
    "data.image_size": 32, "data.batch_size": 4, "data.val_fraction": 0.25,
    "unet.base_channels": 8, "unet.channel_mults": (1, 2), "unet.time_emb_dim": 16,
    "unet.compute_dtype": "float32", "diffusion.timesteps": 10,
    "train.epochs": 1, "train.debug_fast": True, "train.debug_max_steps": 2,
    "train.ema_decay": 0.9, "name": "t",
}
EVAL = {"num_samples": 8, "batch_size": 4, "ddim_steps": 3, "split": "all",
        "compute_pr": True, "diversity_pairs": 2}
HEADLINE = {"fid_rand", "kid_rand_mean", "diversity_ssim_mean", "improved_precision_rand",
            "improved_recall_rand", "num_samples"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run directories of both families, trained 2 steps on the CPU, each with
    its ``config.json``."""
    tmp = tmp_path_factory.mktemp("runs")
    root = tmp / "brats"
    synthetic.write_synthetic_brats(root, num_subjects=3, shape=(32, 32, 20), seed=0)
    dirs = {}
    for family, preset in (("slice_cond_2d", config.preset_slice_cond_2d),
                           ("ddpm_25d", config.preset_ddpm_25d)):
        reset_termination()
        cfg = preset(str(root), **TINY, **{"train.checkpoint_dir": str(tmp / "ckpt")})
        logger = MetricsLogger(family, run_name="t", root=str(tmp / "logs"))
        experiments.run_experiment(cfg, device="cpu", logger=logger)
        logger.finish()
        run_dir = tmp / "ckpt" / family / "t"
        cfg.to_json(run_dir / "config.json")
        dirs[family] = run_dir
    return dirs


@pytest.fixture(scope="module")
def small_fe():
    return FeatureExtractor(image_size=32, widths=(8, 16), device="cpu")


def test_evaluate_runs_scores_port_runs(tmp_path, runs, small_fe):
    """Both families (the 2.5D one scored on channel 3), a duplicate name
    disambiguated, one ``metrics.json`` each, the headline numbers in
    ``summary.json``, no ``*_RUNNING.txt`` left."""
    out = tmp_path / "out"
    summary = evaluate_runs(
        [{"run_dir": str(runs["slice_cond_2d"]), "name": "m", **EVAL},
         {"run_dir": str(runs["slice_cond_2d"]), "name": "m", **EVAL},
         {"run_dir": str(runs["ddpm_25d"]), **EVAL}],
        out, feature_extractor=small_fe, progress=False, device="cpu")
    assert set(summary) == {"m", "m_1", "t"}
    assert json.loads((out / "summary.json").read_text()) == summary
    for name, entry in summary.items():
        assert "error" not in entry, entry
        assert set(entry) == HEADLINE
        assert entry["num_samples"] == EVAL["num_samples"]
        report = json.loads((out / f"{name}.metrics.json").read_text())
        assert report["improved_pr_feature_space"] == "fid_features_rand"
        assert "diversity_feat_dist_mean" in report and len(report["fid_rand_per_z_bin"])
        assert all(np.isfinite(report[k]) for k in HEADLINE)
        assert (out / f"{name}_progress.txt").exists()
    # the same run and options score the same
    assert summary["m"] == summary["m_1"]
    assert not list(out.glob("*_RUNNING.txt")) and not list(out.glob("*_ERROR.txt"))


def test_bad_weights_path_is_a_per_model_error(tmp_path, runs, small_fe):
    """A per-run weights path that does not exist, and a run directory that
    does not: each model's own error and ``*_ERROR.txt``; the others go on."""
    out = tmp_path / "out"
    summary = evaluate_runs(
        [{"run_dir": str(runs["slice_cond_2d"]), "name": "bad",
          "resnet18_weights": str(tmp_path / "nope.npz"), **EVAL},
         {"run_dir": str(tmp_path / "missing"), "name": "gone"},
         {"run_dir": str(runs["slice_cond_2d"]), "name": "good", **EVAL}],
        out, feature_extractor=small_fe, progress=False, device="cpu")
    assert summary["bad"]["error"].startswith("FileNotFoundError")
    assert "error" in summary["gone"]
    assert (out / "bad_ERROR.txt").exists() and (out / "gone_ERROR.txt").exists()
    assert "error" not in summary["good"] and "fid_rand" in summary["good"]
    assert not list(out.glob("*_RUNNING.txt"))


def test_pretrained_weights_give_unsuffixed_metrics(monkeypatch, tmp_path, runs):
    """npz files of converted torchvision-layout Inception-v3, ResNet-18 and
    AlexNet-LPIPS weights (random, not ImageNet) put the pretrained
    extractors in: ``fid``, ``improved_precision`` (ResNet-18 space) and
    ``diversity_lpips_mean``, no ``_rand``. This is the route where the JAX
    package's ``evaluate_runs`` records an ``ImportError`` for every model:
    ``mrijax/evals/multi.py`` imports the three extractors from
    ``mrijax.evals.backbones``, which does not define them. Inception resizes
    to 96² here instead of 299², a tenth of the CPU time (the extractor is
    held against the JAX package's at 96² in ``test_torch_evals_backbones.py``,
    and at 299² on the card against the CPU in ``test_torch_evals_cuda.py``)."""
    monkeypatch.setitem(multi._ExtractorCache._CTORS, "inception",
                        functools.partial(InceptionFeatureExtractor, image_size=96))
    weights = {}
    for kind, make, convert in (
            ("inception", InceptionV3Trunk, convert_inception_v3),
            ("resnet18", ResNet18Trunk, convert_resnet18),
            ("lpips", LPIPSAlexReplica, convert_lpips_alex)):
        weights[kind] = tmp_path / f"{kind}.npz"
        save_params_npz(weights[kind], convert(randomize_(make(), seed=4).state_dict()))
    opts = {**EVAL, "num_samples": 4, "diversity_pairs": 2}
    summary = evaluate_runs(
        [{"run_dir": str(runs["slice_cond_2d"]), "name": "pre", **opts}], tmp_path / "out",
        inception_weights=str(weights["inception"]), resnet18_weights=str(weights["resnet18"]),
        lpips_weights=str(weights["lpips"]), progress=False, device="cpu")
    entry = summary["pre"]
    assert "error" not in entry, entry
    assert set(entry) == {"fid", "kid_mean", "diversity_ssim_mean", "diversity_lpips_mean",
                          "improved_precision", "improved_recall", "num_samples"}
    assert all(np.isfinite(v) for v in entry.values())
    report = json.loads((tmp_path / "out" / "pre.metrics.json").read_text())
    assert report["improved_pr_feature_space"] == "resnet18"
    assert not any(k.endswith("_rand") or "_rand_" in k for k in report)


def test_evaluation_defaults_to_the_card(tmp_path, runs):
    """``evaluate_runs`` and ``evaluate_conditional_2d`` default to CUDA and
    raise where it is absent, before any model is touched."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_runs([{"run_dir": str(runs["slice_cond_2d"])}], tmp_path / "out")
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_conditional_2d(lambda batch, generator: batch["image"], iter([]))
