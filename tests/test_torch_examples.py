"""The port's examples (``examples/torch_*.py``) on the CPU.

``torch_explore_dataset`` prints what ``explore_dataset`` prints on the same
tree. ``torch_minimal_2d_ddpm`` and ``torch_scaled_3d_ldm`` run at their own
sizes with ``--device cpu`` (the kernels' plain versions), in this process
through their ``main(argv)``: their losses are reported and finite, their
files written. On the card ``chip_smoke.py`` runs all three with
``--device cuda`` and counts their kernel launches.
"""

import importlib.util
import math
import re
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from mrijax_torch.data.synthetic import write_synthetic_brats

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def own_tmp(tmp_path, monkeypatch):
    """The examples' temporary trees and run directories under ``tmp_path``;
    torch on one thread meanwhile (their tensors are tiny, and the suite runs
    several workers on the host's cores)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(threads)


def test_explore_dataset_prints_what_the_jax_script_prints(own_tmp, capsys, monkeypatch):
    root = write_synthetic_brats(own_tmp / "tree", num_subjects=2, shape=(24, 20, 16))
    # a missing modality is reported, not fatal
    next(root.rglob("*_t2.nii.gz")).unlink()
    monkeypatch.setattr(sys, "argv", ["explore_dataset.py", "--root", str(root)])
    _load("explore_dataset").main()
    want = capsys.readouterr().out
    assert _load("torch_explore_dataset").main(["--root", str(root)]) == 0
    got = capsys.readouterr().out
    assert "MISSING" in got and "slice window" in got and "aggregate" in got
    assert got == want


def _epoch_losses(text):
    return [float(x) for x in re.findall(r"^epoch \d+: loss (\S+) ", text, re.M)]


def test_minimal_2d_ddpm_trains_and_writes_its_grid(own_tmp, capsys):
    out = own_tmp / "grid.png"
    assert _load("torch_minimal_2d_ddpm").main(
        ["--epochs", "2", "--out", str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    losses = _epoch_losses(text)
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses), text
    assert "dataset: 32 slices; device: cpu" in text
    assert out.stat().st_size > 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_scaled_3d_ldm_trains_both_stages_and_samples(own_tmp, capsys):
    import torch.distributed as dist

    out_dir = own_tmp / "out"
    assert _load("torch_scaled_3d_ldm").main(["--out-dir", str(out_dir), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    scale = float(re.search(r"latent_scale=(\S+)", text).group(1))
    assert math.isfinite(scale) and scale > 0
    trainer = [float(x) for x in re.findall(r"train (\S+) val", text)]
    assert len(trainer) == 2 and all(math.isfinite(x) for x in trainer), text
    assert "sampled 1 volumes over 1 process(es)" in text
    assert (out_dir / "vol0.png").stat().st_size > 0
    run = out_dir / "ckpt" / "ddpm_3d_ldm" / "scaled_demo"
    assert any((run / "vae").iterdir()) and any((run / "ldm").iterdir())
    assert any((run / "latent_cache").iterdir())
    assert not dist.is_initialized()   # the group of one it made is gone


def test_examples_refuse_cuda_without_a_card(own_tmp):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    for name in ("torch_minimal_2d_ddpm", "torch_scaled_3d_ldm"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            _load(name).main(["--out-dir" if "3d" in name else "--out",
                              str(own_tmp / name)])
