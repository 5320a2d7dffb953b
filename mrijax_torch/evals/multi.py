"""Multi-model evaluation harness (the `metrics_both.py` equivalent).

Counterpart of ``mrijax/evals/multi.py``. The reference evaluates a config
list of heterogeneous checkpoints (`slice_cond_2d_ddpm/metrics_both.py:244-687`):
per-model protocol dispatch, breadcrumb files so long cluster jobs are
observable (``*_RUNNING.txt`` / ``*_progress.txt``), per-model JSON and a
final ``summary.json``. Here each entry names a run directory of the port's
trainer (with its ``config.json`` beside the checkpoints — the CLI's ``train``
writes it, ``run_experiment`` does not) plus protocol options; family
dispatch is automatic.

The pretrained extractors are the port's own (``evals.features``): given
``inception_weights`` / ``resnet18_weights`` / ``lpips_weights``, the reports
carry the unsuffixed ``fid`` / ``improved_precision`` /
``diversity_lpips_mean``.
"""

import json
import time
import traceback
from pathlib import Path
from typing import List, Optional, Union

import torch

from mrijax_torch._device import require_device
from mrijax_torch.config import ExperimentConfig
from mrijax_torch.data import (
    BatchLoader,
    MultiModalSliceDataset25D,
    SliceDataset2D,
    volume_split_indices,
)
from mrijax_torch.data.loader import _IndexView
from mrijax_torch.evals.features import (
    FeatureExtractor,
    InceptionFeatureExtractor,
    LPIPSDistance,
    ResNet18FeatureExtractor,
)
from mrijax_torch.evals.harness import evaluate_conditional_2d
from mrijax_torch.io.checkpoint import CheckpointManager
from mrijax_torch.train.experiments import build_diffusion, build_unet2d
from mrijax_torch.train.state import create_train_state, inference_params

Device = Union[str, torch.device]


class _ExtractorCache:
    """Build each (kind, weights_path) extractor/distance once across the
    model list — converted backbone weights are shared, not per-run."""

    _CTORS = {
        "inception": InceptionFeatureExtractor,
        "resnet18": ResNet18FeatureExtractor,
        "lpips": LPIPSDistance,
    }

    def __init__(self, device: torch.device):
        self.device = device
        self._cache = {}

    def get(self, kind: str, weights_path):
        if weights_path is None:
            return None
        k = (kind, str(weights_path))
        if k not in self._cache:
            self._cache[k] = self._CTORS[kind](weights_path=weights_path, device=self.device)
        return self._cache[k]


def evaluate_runs(
    run_configs: List[dict],
    out_dir,
    *,
    feature_extractor: Optional[FeatureExtractor] = None,
    inception_weights=None,
    lpips_weights=None,
    resnet18_weights=None,
    progress: bool = True,
    device: Device = "cuda",
) -> dict:
    """run_configs: [{"run_dir": ..., "num_samples": 500, "ddim_steps": 50,
    "split": "test", "compute_pr": false, "name": optional,
    "inception_weights"/"lpips_weights"/"resnet18_weights": optional
    per-run overrides of the harness-wide paths}, ...].

    ``*_weights`` are npz paths in the JAX package's layout (its
    ``mrijax convert-features``, or ``save_params_npz`` of the port's
    ``convert_*``); with them the batch harness emits REAL fid/kid/lpips/pr
    (the reference's pretrained-metric mode, `metrics.py:147-229,419-443`)
    instead of ``_rand``-suffixed stand-ins.

    Writes ``<out_dir>/<name>.metrics.json`` per model + ``summary.json``;
    returns the summary dict. A model failure is recorded, not fatal
    (the reference's long-job resilience pattern). Everything runs on
    ``device`` (default the card).
    """
    dev = require_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    extractors = _ExtractorCache(dev)
    summary = {}
    seen_names: dict = {}
    for i, rc in enumerate(run_configs):
        run_dir = Path(rc["run_dir"])
        name = rc.get("name") or run_dir.name
        # duplicate names would silently overwrite each other's
        # metrics.json and summary entry — disambiguate deterministically
        if name in seen_names:
            seen_names[name] += 1
            name = f"{name}_{seen_names[name]}"
        else:
            seen_names[name] = 0
        crumb = out_dir / f"{name}_RUNNING.txt"
        crumb.write_text(f"started {time.ctime()}\n")
        try:
            # inside the try: a bad weights path is a per-model error, not
            # a batch-killer
            inc = rc.get("inception_weights", inception_weights)
            fe = (
                feature_extractor
                or extractors.get("inception", inc)
                or FeatureExtractor(device=dev)
            )
            pr_fe = extractors.get(
                "resnet18", rc.get("resnet18_weights", resnet18_weights)
            )
            lpips = extractors.get(
                "lpips", rc.get("lpips_weights", lpips_weights)
            )
            report = _evaluate_one(
                rc, fe, out_dir / f"{name}.metrics.json",
                pr_feature_extractor=pr_fe, lpips=lpips,
                progress_path=out_dir / f"{name}_progress.txt", device=dev,
            )
            headline = ("fid", "kid_mean", "diversity_ssim_mean",
                        "diversity_lpips_mean", "improved_precision",
                        "improved_recall", "num_samples")
            summary[name] = {
                k: report[k]
                for k in report
                # keep both pretrained ("fid") and labeled ("fid_rand") forms
                if k in headline or k.replace("_rand", "") in headline
            }
        except Exception as e:  # noqa: BLE001 — keep evaluating other models
            summary[name] = {"error": f"{type(e).__name__}: {e}"}
            (out_dir / f"{name}_ERROR.txt").write_text(traceback.format_exc())
        finally:
            crumb.unlink(missing_ok=True)
        if progress:
            print(f"[evals.multi] {i + 1}/{len(run_configs)}: {name} -> "
                  f"{summary[name]}")
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def _restore_params(run_dir, state):
    """The best-by-val checkpoint of ``run_dir`` into ``state`` (the latest
    where no best is recorded), as the JAX CLI's ``_restore_params``.
    Returns ``(state, extra)``."""
    mgr = CheckpointManager(run_dir)
    try:
        state, extra = mgr.restore(state, best=True)
    except (FileNotFoundError, ValueError):
        state, extra = mgr.restore(state)
    mgr.close()
    return state, extra or {}


def _evaluate_one(
    rc: dict,
    fe: FeatureExtractor,
    out_path: Path,
    *,
    pr_feature_extractor=None,
    lpips=None,
    progress_path=None,
    device: torch.device,
) -> dict:
    run_dir = Path(rc["run_dir"])
    cfg = ExperimentConfig.from_json(run_dir / "config.json")
    if cfg.family not in ("slice_cond_2d", "ddpm_25d"):
        raise NotImplementedError(
            f"multi-eval handles slice_cond_2d and ddpm_25d; got {cfg.family}"
        )
    is_25d = cfg.family == "ddpm_25d"
    s = cfg.data.image_size
    model = build_unet2d(cfg.unet)
    diffusion = build_diffusion(cfg.diffusion).to(device)
    state = create_train_state(model, cfg.train.learning_rate,
                               ema=cfg.train.ema_decay is not None, device=device)
    state, _ = _restore_params(run_dir, state)
    params = inference_params(state)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    model.eval()

    if is_25d:
        ds = MultiModalSliceDataset25D(cfg.data.root_dir, s, cfg.data.slice_radius)
    else:
        ds = SliceDataset2D(cfg.data.root_dir, s, cfg.data.modality_suffix)
    split = rc.get("split", "test")
    train_v, val_v, test_v = volume_split_indices(len(ds.volume_paths), seed=42)
    vols = {"train": train_v, "val": val_v, "test": test_v,
            "all": list(range(len(ds.volume_paths)))}[split]
    paths = {ds.volume_paths[i] for i in vols}
    keep = [i for i, (p, _) in enumerate(ds.slice_tuples) if p in paths]

    if len(keep) < 2:
        raise ValueError(
            f"split {split!r} has {len(keep)} slices — FID/KID need at "
            "least 2; use split='all' or a larger dataset"
        )
    # keep the ragged tail: a split smaller than the batch size must still
    # produce batches (single-device eval has no whole-batch requirement)
    loader = BatchLoader(_IndexView(ds, keep), rc.get("batch_size", 32), shuffle=False,
                         drop_last=False, prefetch=0, device=device)
    ddim_steps = rc.get("ddim_steps")

    def sample_fn(batch, generator):
        z = batch["z_pos"]
        context = batch["context"] if is_25d else None

        def model_fn(x, t):
            return model(x, t, z, context)

        shape = (z.shape[0], s, s, cfg.unet.out_channels)
        if ddim_steps:
            return diffusion.ddim_sample(model_fn, shape, generator, num_steps=ddim_steps)
        return diffusion.p_sample_loop_auto(model_fn, shape, generator)

    return evaluate_conditional_2d(
        sample_fn, iter(loader), feature_extractor=fe,
        pr_feature_extractor=pr_feature_extractor,
        lpips=lpips,
        num_samples=rc.get("num_samples", 1000),
        num_diversity_pairs=rc.get("diversity_pairs", 64),
        compute_pr=rc.get("compute_pr", False),
        seed=rc.get("seed", 0),
        eval_channel=rc.get("eval_channel", 3) if is_25d else None,
        out_path=out_path,
        progress_path=progress_path,
        device=device,
    )
