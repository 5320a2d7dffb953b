"""Dataset exploration on the PyTorch port: the same report as
``examples/explore_dataset.py``, from ``mrijax_torch.data``.

Reports, per subject: modality volume shapes/dtypes, nonzero fraction,
intensity percentiles before/after normalization, slice-index window; and
aggregate intensity statistics across the tree. Works on any BraTS-layout
directory; with --synthetic it generates a demo tree first. Host only
(numpy): nothing runs on a device.

Usage:
    python examples/torch_explore_dataset.py --root /data/brats [--max-subjects 5]
    python examples/torch_explore_dataset.py --synthetic
"""

import argparse
import sys
import tempfile
from pathlib import Path

# allow running straight from a checkout: python examples/<script>.py
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--max-subjects", type=int, default=5)
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)

    from mrijax_torch.data import central_slice_range, nifti
    from mrijax_torch.data.datasets import MODALITY_SUFFIXES_25D, _zscore_nonzero_np

    root = args.root
    if args.synthetic or root is None:
        from mrijax_torch.data.synthetic import write_synthetic_brats

        root = write_synthetic_brats(
            tempfile.mkdtemp(prefix="brats_demo_"), num_subjects=3,
            shape=(48, 48, 32),
        )
        print(f"[explore] wrote synthetic tree at {root}\n")

    flairs = sorted(Path(root).rglob("*_flair.nii.gz"))[: args.max_subjects]
    if not flairs:
        raise SystemExit(f"no *_flair.nii.gz under {root}")

    all_means, all_stds = [], []
    for p in flairs:
        print(f"== {p.parent.name}")
        for sfx in MODALITY_SUFFIXES_25D:
            mp = str(p).replace("_flair.nii.gz", sfx)
            try:
                vol = nifti.load(mp)
            except FileNotFoundError:
                print(f"  {sfx:16s} MISSING")
                continue
            nz = vol != 0
            frac = nz.mean()
            vals = vol[nz] if nz.any() else vol.ravel()
            norm = _zscore_nonzero_np(vol)
            print(
                f"  {sfx:16s} shape={vol.shape} nonzero={frac:5.1%} "
                f"raw[p1,p50,p99]=({np.percentile(vals,1):8.1f}, "
                f"{np.percentile(vals,50):8.1f}, {np.percentile(vals,99):8.1f}) "
                f"norm range=[{norm.min():+.2f}, {norm.max():+.2f}]"
            )
            all_means.append(vals.mean())
            all_stds.append(vals.std())
        depth = nifti.load_header(p).shape[2]
        zr = central_slice_range(depth)
        print(f"  slice window: z in [{zr.start}, {zr.stop}) of {depth} "
              f"({len(zr)} training slices)\n")

    print(f"aggregate nonzero-intensity mean {np.mean(all_means):.1f} "
          f"± {np.std(all_means):.1f}; std {np.mean(all_stds):.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
