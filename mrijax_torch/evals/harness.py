"""Evaluation harness reproducing the reference's metrics.json protocol.

Counterpart of ``mrijax/evals/harness.py``; protocol parity with
`slice_cond_2d_ddpm/metrics.py:232-523` / `evaluation_scripts/metrics.py`:

* volume-level test split (no slice leakage) — ``volume_split_indices``;
* stream real test slices; for each real batch, sample fakes at the SAME
  z conditions; update global + per-z-bin (8 bins over [0,1]) FID/KID
  accumulators;
* diversity: pairs of independent generations at the same z → SSIM, plus
  AlexNet-LPIPS when an ``lpips`` distance is supplied (metrics.py:419-443)
  — otherwise a feature-space cosine stand-in labeled ``feat_dist``;
* optional improved precision/recall, on ResNet18 features when a
  ``pr_feature_extractor`` is supplied (metrics.py:147-229), else on the
  FID features;
* metric names carry the extractor's ``metric_suffix``: "" for converted
  ImageNet weights (``fid``/``kid`` comparable to BASELINE.md), "_rand"
  for the offline seeded-random extractor;
* memorization stats of fakes vs a real pool;
* writes ``metrics.json`` with the reference's key layout.

Images, features and SSIM stay on the device; the statistics (FID, KID,
precision/recall, memorization) are float64 numpy on the host, as in the JAX
package. The sampling loop dominates cost exactly as in the reference (§3.5);
use ``ddim_steps`` for the fast path.
"""

import json
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from mrijax_torch._device import require_device
from mrijax_torch.evals.features import FeatureExtractor
from mrijax_torch.evals.frechet import FidAccumulator, frechet_distance, kid_from_features
from mrijax_torch.evals.memorization import memorization_stats
from mrijax_torch.evals.prd import improved_precision_recall
from mrijax_torch.evals.ssim import ssim

NUM_Z_BINS = 8
DIVERSITY_CALL = 999  # the stream of the two diversity calls (the JAX fold_in(key, 999))


def _bin_of(z: np.ndarray, num_bins: int = NUM_Z_BINS) -> np.ndarray:
    return np.clip((np.asarray(z) * num_bins).astype(int), 0, num_bins - 1)


def call_generator(seed: int, *stream: int, device: Union[str, torch.device] = "cuda"
                   ) -> torch.Generator:
    """The generator of one ``sample_fn`` call, in place of the JAX harness's
    ``jax.random.split`` chain: seeded from ``numpy.random.SeedSequence((seed,
    *stream))`` — ``(seed, i)`` for the i-th real batch, ``(seed, 999, j)``
    for diversity draw j ∈ {0, 1}. Deterministic, and independent of how many
    batches came before."""
    state = np.random.SeedSequence((seed, *stream)).generate_state(2, np.uint32)
    value = (int(state[0]) << 31) ^ int(state[1])  # 63 bits: a valid manual_seed
    return torch.Generator(device=device).manual_seed(value)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def evaluate_conditional_2d(
    sample_fn: Callable,
    real_iter,
    *,
    feature_extractor: Optional[FeatureExtractor] = None,
    pr_feature_extractor=None,
    lpips=None,
    num_samples: int = 1000,
    num_diversity_pairs: int = 64,
    compute_pr: bool = False,
    memorization_pool: int = 2000,
    seed: int = 0,
    eval_channel: Optional[int] = None,
    out_path=None,
    progress_path=None,
    metadata: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Evaluate a conditional 2D sampler against real data.

    ``sample_fn(batch, generator) -> (B, H, W, C) fakes in [-1, 1]`` — the
    batch dict (tensors on ``device``) carries whatever conditioning the model
    needs (z_pos for the 2D model; z_pos + context for the 2.5D model), and
    ``generator`` is a ``torch.Generator`` on ``device`` (``call_generator``).
    ``real_iter`` yields dicts with at least "image" (B, H, W, C) and "z_pos"
    (B,), as tensors or arrays.

    ``eval_channel`` selects one channel of both real and fake images before
    feature extraction for multichannel (2.5D) models — the reference's
    ``eval_channel`` (`metrics_both.py:178-189`).
    """
    dev = require_device(device)
    fe = feature_extractor or FeatureExtractor(device=dev)
    sfx = getattr(fe, "metric_suffix", "_rand")

    def select(img):
        if eval_channel is None:
            return img
        return img[..., eval_channel: eval_channel + 1]

    global_real = FidAccumulator(fe.dim)
    global_fake = FidAccumulator(fe.dim)
    bin_real = [FidAccumulator(fe.dim) for _ in range(NUM_Z_BINS)]
    bin_fake = [FidAccumulator(fe.dim) for _ in range(NUM_Z_BINS)]
    real_feats_all, fake_feats_all = [], []
    real_pool, fake_pool = [], []
    # PR runs on its own feature space (ResNet18); embed each real batch as
    # it streams by and keep only the feature vectors — the real side must
    # NOT inherit the memorization cap (precision/recall would compare
    # ~2000 real vs num_samples fake manifolds), and holding raw images
    # instead of features would cost GBs at large num_samples
    embed_pr = compute_pr and pr_feature_extractor is not None
    real_feats_pr = []

    n_seen = 0
    calls = 0
    t0 = time.time()
    div_batch = None
    for batch in real_iter:
        if n_seen >= num_samples:
            break
        take = min(num_samples - n_seen, batch["image"].shape[0])
        batch = {k: torch.as_tensor(v)[:take].to(dev) for k, v in batch.items()}
        real = select(batch["image"]).float()
        z = _host(batch["z_pos"])
        fake = select(sample_fn(batch, call_generator(seed, calls, device=dev))).float()
        calls += 1

        rf = _host(fe(real))
        ff = _host(fe(fake))
        global_real.update(rf)
        global_fake.update(ff)
        for b in range(NUM_Z_BINS):
            m = _bin_of(z) == b
            if m.any():
                bin_real[b].update(rf[m])
                bin_fake[b].update(ff[m])
        real_feats_all.append(rf)
        fake_feats_all.append(ff)
        if len(real_pool) * real.shape[0] < memorization_pool:
            real_pool.append(_host(real))
        if embed_pr:
            real_feats_pr.append(_host(pr_feature_extractor(real)))
        fake_pool.append(_host(fake))
        if div_batch is None:
            div_batch = batch  # reuse the first batch's conditions
        n_seen += real.shape[0]
        if progress_path is not None:
            # mid-model breadcrumb so a long eval (sampling dominates, §3.5)
            # is observable from outside, like the reference's
            # *_progress.txt (`metrics_both.py:389`)
            Path(progress_path).write_text(
                f"{n_seen}/{num_samples} samples  "
                f"{time.time() - t0:.0f}s elapsed  {time.ctime()}\n"
            )

    report: dict = {"num_samples": n_seen, "protocol": "matched-z streaming"}
    # caller-supplied provenance (e.g. which sampler generated the fakes —
    # the reference can only do the full-T ancestral protocol,
    # `metrics.py:355`; a fast-mode report must say so in its JSON)
    report.update(metadata or {})
    mu_r, cov_r = global_real.stats()
    mu_f, cov_f = global_fake.stats()
    report[f"fid{sfx}"] = frechet_distance(mu_r, cov_r, mu_f, cov_f)
    rfa = np.concatenate(real_feats_all)
    ffa = np.concatenate(fake_feats_all)
    kid_mean, kid_std = kid_from_features(
        rfa, ffa, subset_size=min(1000, n_seen), num_subsets=100, seed=seed
    )
    report[f"kid{sfx}_mean"], report[f"kid{sfx}_std"] = kid_mean, kid_std

    report[f"fid{sfx}_per_z_bin"] = {}
    for b in range(NUM_Z_BINS):
        if bin_real[b].n >= 2 and bin_fake[b].n >= 2:
            report[f"fid{sfx}_per_z_bin"][str(b)] = frechet_distance(
                *bin_real[b].stats(), *bin_fake[b].stats()
            )

    # diversity: two generations at identical conditions
    if div_batch is not None and num_diversity_pairs > 0:
        db = {k: v[:num_diversity_pairs] for k, v in div_batch.items()}
        g1, g2 = (select(sample_fn(db, call_generator(seed, DIVERSITY_CALL, j, device=dev)))
                  .float() for j in (0, 1))
        # reference protocol rescales to [0,1] with data_range=1 before
        # SSIM (metrics.py:433-436) — SSIM is not shift-invariant, so
        # scoring the raw [-1,1] samples would not be comparable
        s = _host(ssim(torch.clamp((g1 + 1.0) / 2.0, 0.0, 1.0),
                       torch.clamp((g2 + 1.0) / 2.0, 0.0, 1.0), data_range=1.0))
        report["diversity_ssim_mean"] = float(s.mean())
        report["diversity_ssim_std"] = float(s.std())
        if lpips is not None:
            lsfx = "" if getattr(lpips, "is_pretrained", False) else "_rand"
            d = _host(lpips(g1, g2))
            report[f"diversity_lpips{lsfx}_mean"] = float(d.mean())
            report[f"diversity_lpips{lsfx}_std"] = float(d.std())
        else:
            f1, f2 = _host(fe(g1)), _host(fe(g2))
            cos = np.sum(f1 * f2, axis=1) / np.maximum(
                np.linalg.norm(f1, axis=1) * np.linalg.norm(f2, axis=1), 1e-12
            )
            report["diversity_feat_dist_mean"] = float((1 - cos).mean())
            report["diversity_feat_dist_std"] = float((1 - cos).std())

    if compute_pr:
        if pr_feature_extractor is not None:
            # re-embed the pools with the PR extractor (ResNet18 features,
            # metrics.py:147-229) — PR runs on a different feature space
            # than FID by design
            prf = pr_feature_extractor
            rfa_pr = np.concatenate(real_feats_pr)
            ffa_pr = prf.embed_batched(np.concatenate(fake_pool))
            p, r = improved_precision_recall(rfa_pr, ffa_pr)
            psfx = getattr(prf, "metric_suffix", "_rand")
            report["improved_pr_feature_space"] = "resnet18"
        else:
            # FALLBACK: FID-space features, a DIFFERENT metric than the
            # reference's ResNet18-space PR — record the space explicitly
            # so the fallback is visible beyond the suffix
            p, r = improved_precision_recall(rfa, ffa)
            psfx = sfx
            report["improved_pr_feature_space"] = f"fid_features{sfx}"
        report[f"improved_precision{psfx}"] = p
        report[f"improved_recall{psfx}"] = r

    fakes = np.concatenate(fake_pool)[:memorization_pool]
    reals = np.concatenate(real_pool)[:memorization_pool]
    report["memorization"] = memorization_stats(fakes, reals)
    report["eval_seconds"] = time.time() - t0

    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(report, indent=2))
    return report
