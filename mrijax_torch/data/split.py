"""Subject-level dataset splitting (no slice leakage across splits).

A copy of ``mrijax/data/split.py`` (the port imports nothing of ``mrijax``).

Two parity surfaces:

* ``split_subjects`` / ``apply_split`` — the offline CLI that moves/copies/
  symlinks subject directories into ``out/{train,val,test}`` and writes
  manifests, matching `evaluation_scripts/split_train_val_test.py:29-167`
  (floor for val/test with remainder to train, non-empty-split fixup for
  small n, seeded shuffle, out-root ⊄ src guard, dry-run).
* ``volume_split_indices`` — the in-memory volume-level split used by every
  eval script (`slice_cond_2d_ddpm/metrics.py:82-95` and its two clones).
"""

import os
import shutil
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def split_counts(
    n: int, train_frac: float = 0.8, val_frac: float = 0.1, test_frac: float = 0.1
) -> Tuple[int, int, int]:
    """Deterministic 80/10/10 count arithmetic. The semantics ARE the spec
    (`split_train_val_test.py:42-61`): floor val/test, train takes the
    remainder, and for n ≥ 3 every split is made non-empty with train
    absorbing the rebalance."""
    if abs((train_frac + val_frac + test_frac) - 1.0) > 1e-9:
        raise ValueError("fractions must sum to 1.0")
    counts = {"val": int(n * val_frac), "test": int(n * test_frac)}
    counts["train"] = n - counts["val"] - counts["test"]
    if n >= 3:
        counts = {k: max(v, 1) for k, v in counts.items()}
        counts["train"] -= sum(counts.values()) - n
    return counts["train"], counts["val"], counts["test"]


def split_subjects(
    subjects: Sequence,
    *,
    train_frac: float = 0.8,
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 42,
):
    """Seeded shuffle + 80/10/10 split of a subject list. Returns a dict of
    {"train": [...], "val": [...], "test": [...]} preserving shuffle order."""
    subjects = sorted(subjects, key=lambda p: str(p))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(subjects))
    shuffled = [subjects[i] for i in order]
    n_train, n_val, n_test = split_counts(len(subjects), train_frac, val_frac, test_frac)
    return {
        "train": shuffled[:n_train],
        "val": shuffled[n_train : n_train + n_val],
        "test": shuffled[n_train + n_val :],
    }


def _is_subpath(child: Path, parent: Path) -> bool:
    """True when ``child`` resolves to ``parent`` or inside it (guards the
    out-root ⊄ src requirement)."""
    c, p = child.resolve(), parent.resolve()
    return c == p or p in c.parents


def apply_split(
    src: Path,
    out_root: Path,
    *,
    train_frac: float = 0.8,
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 42,
    mode: str = "symlink",
    dry_run: bool = False,
) -> dict:
    """Place subject dirs of ``src`` into ``out_root/{train,val,test}`` and
    write ``out_root/splits/{train,val,test}.txt`` manifests."""
    src, out_root = Path(src), Path(out_root)
    if _is_subpath(out_root, src):
        raise ValueError(f"out_root {out_root} must not be inside src {src}")
    subject_dirs = sorted(
        (p for p in src.iterdir() if p.is_dir() and not p.name.startswith(".")),
        key=lambda p: p.name,
    )
    splits = split_subjects(
        subject_dirs,
        train_frac=train_frac, val_frac=val_frac, test_frac=test_frac, seed=seed,
    )
    manifest_dir = out_root / "splits"
    if not dry_run:
        manifest_dir.mkdir(parents=True, exist_ok=True)
    for name, dirs in splits.items():
        split_dir = out_root / name
        if not dry_run:
            split_dir.mkdir(parents=True, exist_ok=True)
        for d in dirs:
            dst = split_dir / d.name
            if dry_run:
                print(f"[DRY-RUN] {mode}: {d} -> {dst}")
                continue
            if dst.exists():
                raise FileExistsError(f"destination exists: {dst}")
            if mode == "move":
                shutil.move(str(d), str(dst))
            elif mode == "copy":
                shutil.copytree(d, dst)
            elif mode == "symlink":
                os.symlink(d.resolve(), dst, target_is_directory=True)
            else:
                raise ValueError(f"unknown mode {mode!r}")
        manifest = manifest_dir / f"{name}.txt"
        if dry_run:
            print(f"[DRY-RUN] manifest {manifest} ({len(dirs)} ids)")
        else:
            manifest.write_text(
                "\n".join(d.name for d in dirs) + "\n", encoding="utf-8"
            )
    return splits


def volume_split_indices(
    num_volumes: int,
    *,
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 42,
) -> Tuple[List[int], List[int], List[int]]:
    """In-memory volume-level (train, val, test) index split — eval-script
    parity (`slice_cond_2d_ddpm/metrics.py:82-95`)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_volumes).tolist()
    n_test = int(num_volumes * test_frac)
    n_val = int(num_volumes * val_frac)
    test = order[:n_test]
    val = order[n_test : n_test + n_val]
    train = order[n_test + n_val :]
    return train, val, test
