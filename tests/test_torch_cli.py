"""``python -m mrijax_torch.cli`` against ``python -m mrijax.cli``.

* The parsers: the same 14 subcommands, each with the same option strings,
  defaults, choices, ``nargs`` and ``required``; the only difference is the
  top-level ``--device`` in place of ``--platform`` / ``--compile-cache``.
* The host-side subcommands on the same files: ``split`` (dry run and
  symlink), ``preprocess`` (3D shards bitwise, 2D / 2.5D within 1e-5, the
  bar of ``tests/test_torch_data.py``), ``eval-seg`` (the same report),
  ``convert-features`` (the same npz, bitwise) and ``import-torch`` of a
  reference 2D checkpoint (the same weights and ``config.json``).
* The refusals: bad ``--set``, unknown preset, ``--guidance-scale`` with 3D,
  ``serve`` without the VAE npz or with other weights, 2.5D ``export-aot``,
  the multi-device flags (they come with the parallel slice), and CUDA asked
  for where there is none (``doctor`` still answers).

The JAX CLI's ``train`` is not called here (its tests are slow-marked); the
slice as a whole is in ``tests/test_torch_cli_slice.py``.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from mrijax import cli as jcli
from mrijax.io import torch_convert as jconvert
from mrijax.train import experiments as jexperiments
from mrijax_torch import cli
from mrijax_torch.config import ExperimentConfig, preset_ddpm_3d_ldm, preset_slice_cond_2d
from mrijax_torch.data import nifti
from mrijax_torch.data.synthetic import write_synthetic_brats
from mrijax_torch.io import CheckpointManager, save_params_npz, unet2d_state_dict_from_flax
from test_torch_parity import TorchRefUNet
from torch_replicas import InceptionV3Trunk, LPIPSAlexReplica, ResNet18Trunk, randomize_

REPO = Path(__file__).resolve().parent.parent
SUBCOMMANDS = ["train", "sample", "eval", "eval-multi", "export", "export-aot", "serve",
               "eval-seg", "convert-features", "import-torch", "preprocess", "split",
               "doctor", "info"]
TINY_2D = ["data.image_size=16", "unet.base_channels=8", "unet.channel_mults=[1,2]",
           "unet.time_emb_dim=16", "unet.compute_dtype=\"float32\"", "diffusion.timesteps=20"]


def port(*argv):
    return cli.main(["--device", "cpu", *map(str, argv)])


def port_main(argv):
    """``port`` with the JAX CLI's ``main(argv)`` signature."""
    return port(*argv)


# ------------------------------------------------------------------ parsers


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.choices, a.nargs, a.required,
             type(a).__name__, a.type)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)]


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_parser_matches_the_jax_cli(name):
    jax_subs, port_subs = _subparsers(jcli.build_parser()), _subparsers(cli.build_parser())
    assert list(port_subs) == list(jax_subs) and set(port_subs) == set(SUBCOMMANDS)
    assert _options(port_subs[name]) == _options(jax_subs[name])


def test_top_level_options_differ_only_by_device():
    jtop = {o[1]: o for o in _options(jcli.build_parser())}
    top = {o[1]: o for o in _options(cli.build_parser())}
    assert set(jtop) - set(top) == {"platform", "compile_cache"}
    assert set(top) - set(jtop) == {"device"}
    assert top["device"][2:4] == ("cuda", ["cuda", "cpu"])
    # the subcommand action itself, but for its parsers (compared per subcommand above)
    assert top["cmd"][:3] + top["cmd"][4:] == jtop["cmd"][:3] + jtop["cmd"][4:]


def test_module_help_lists_every_subcommand():
    r = subprocess.run([sys.executable, "-m", "mrijax_torch.cli", "--help"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert all(name in r.stdout for name in SUBCOMMANDS)


# ---------------------------------------------- host-side, against the JAX CLI


@pytest.fixture(scope="module")
def brats(tmp_path_factory):
    return write_synthetic_brats(tmp_path_factory.mktemp("brats") / "raw", num_subjects=3,
                                 shape=(32, 32, 20))


def _tree(root):
    return sorted((str(p.relative_to(root)), os.readlink(p) if p.is_symlink() else None)
                  for p in root.rglob("*"))


def test_split_matches_jax(tmp_path, capsys):
    src = tmp_path / "subjects"
    for i in range(10):
        (src / f"BraTS2021_{i:05d}").mkdir(parents=True)
        (src / f"BraTS2021_{i:05d}" / "x_flair.nii.gz").write_bytes(b"")
    printed = {}
    for tag, main in (("jax", jcli.main), ("port", port_main)):
        for dry in (True, False):
            argv = ["split", "--src", src, "--out-root", tmp_path / tag, "--seed", "3"]
            assert main([str(a) for a in argv] + (["--dry-run"] if dry else [])) == 0
            printed[tag, dry] = capsys.readouterr().out.replace(str(tmp_path / tag), "OUT")
    for dry in (True, False):
        assert printed["port", dry] == printed["jax", dry]
        assert printed["port", dry].splitlines()[-1] == "{'train': 8, 'val': 1, 'test': 1}"
    assert "[DRY-RUN]" in printed["port", True]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert any(link for _, link in _tree(tmp_path / "port"))


@pytest.mark.parametrize("family", ["2d", "25d", "3d"])
def test_preprocess_matches_jax(brats, tmp_path, family):
    out = {}
    for tag, main in (("jax", jcli.main), ("port", port_main)):
        out[tag] = tmp_path / tag
        assert main(["preprocess", "--root-dir", str(brats), "--output-dir", str(out[tag]),
                     "--family", family, "--image-size", "16"]) == 0
    index = json.loads((out["port"] / "index.json").read_text())
    assert index == json.loads((out["jax"] / "index.json").read_text())
    assert len(index["files"]) == 3
    for entry in index["files"]:
        with np.load(out["port"] / entry["path"]) as got, np.load(out["jax"] / entry["path"]) as want:
            assert set(got.files) == set(want.files)
            for k in want.files:
                assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
                if family == "3d":
                    np.testing.assert_array_equal(got[k], want[k])
                else:
                    np.testing.assert_allclose(got[k], want[k], atol=1e-5)


def test_eval_seg_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    pred, target = tmp_path / "pred", tmp_path / "target"
    for case in ("a/case1", "b/case1", "case2"):
        t = np.zeros((14, 12, 10), np.float32)
        t[rng.uniform(size=t.shape) < 0.2] = 2.0
        t[3:7, 3:7, 2:6] = 1.0
        t[4:6, 4:6, 3:5] = 4.0
        p = np.roll(t, 1, axis=0)
        p[p == 4.0] = 0.0 if case == "case2" else 4.0   # label 4 missing once: inf HD95
        for root, vol in ((target, t), (pred, p)):
            (root / case).parent.mkdir(parents=True, exist_ok=True)
            nifti.save(root / f"{case}.nii.gz", vol)
    reports, printed = {}, {}
    for tag, main in (("jax", jcli.main), ("port", port_main)):
        reports[tag] = tmp_path / f"{tag}.json"
        assert main(["eval-seg", "--pred", str(pred), "--target", str(target),
                     "--voxelspacing", "1", "1", "2", "--out", str(reports[tag])]) == 0
        printed[tag] = capsys.readouterr().out.replace(str(reports[tag]), "")
    got = json.loads(reports["port"].read_text())
    assert got == json.loads(reports["jax"].read_text())
    assert printed["port"] == printed["jax"]
    assert got["num_cases"] == 3 and got["mean_hd95"]["4"] is not None
    with pytest.raises(SystemExit, match="both be files or both dirs"):
        port("eval-seg", "--pred", pred, "--target", target / "case2.nii.gz")


@pytest.mark.parametrize("arch,make", [("inception_v3", InceptionV3Trunk),
                                       ("resnet18", ResNet18Trunk),
                                       ("lpips_alex", LPIPSAlexReplica)])
def test_convert_features_matches_jax(tmp_path, capsys, arch, make):
    ckpt = tmp_path / "backbone.pth"
    torch.save({"state_dict": randomize_(make(), seed=4).state_dict()}, ckpt)
    out = {}
    for tag, main in (("jax", jcli.main), ("port", port_main)):
        out[tag] = tmp_path / f"{tag}.npz"
        assert main(["convert-features", "--checkpoint", str(ckpt), "--arch", arch,
                     "--out", str(out[tag])]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].replace("port.npz", "") == lines[0].replace("jax.npz", "")
    with np.load(out["port"]) as got, np.load(out["jax"]) as want:
        assert got.files == want.files
        assert str(got["__keys__"]) == str(want["__keys__"])
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_import_torch_2d_matches_jax(tmp_path, monkeypatch):
    """The reference twin's checkpoint (the diffusion wrapper's ``model.``
    prefix and ``betas``) → both CLIs: the same ``config.json`` (T inferred,
    EMA cleared) and the weights of the JAX package's converter, which its
    ``import-torch`` saves; the run restores into ``sample`` / ``export``.
    The JAX CLI's shape check gets its tree from ``jax.eval_shape`` (its
    op-by-op ``init`` takes ~20 s here for the same shapes)."""
    build = jexperiments.build_unet2d

    def shapes_only(cfg_unet):
        model = build(cfg_unet)
        return SimpleNamespace(init=lambda *a: jax.eval_shape(model.init, *a))

    monkeypatch.setattr(jexperiments, "build_unet2d", shapes_only)
    torch.manual_seed(0)
    twin = TorchRefUNet(img_channels=1, base=8, mults=(1, 2), tdim=16)
    ckpt = tmp_path / "ddpm.pt"
    torch.save({**{f"model.{k}": v for k, v in twin.state_dict().items()},
                "betas": torch.linspace(1e-4, 0.02, 37)}, ckpt)
    runs = {}
    for tag, main in (("jax", jcli.main), ("port", port_main)):
        runs[tag] = tmp_path / tag
        assert main(["import-torch", "--checkpoint", str(ckpt), "--out", str(runs[tag]),
                     "--set", *TINY_2D, "train.ema_decay=0.999"]) == 0
    cfg = json.loads((runs["port"] / "config.json").read_text())
    assert cfg == json.loads((runs["jax"] / "config.json").read_text())
    assert cfg["diffusion"]["timesteps"] == 37 and cfg["train"]["ema_decay"] is None
    want = unet2d_state_dict_from_flax(
        jconvert.convert_reference_unet2d(dict(torch.load(ckpt)), channel_mults=(1, 2)),
        channel_mults=(1, 2))
    payload, extra = CheckpointManager(runs["port"]).restore_host(best=True)
    assert payload["ema"] is None and extra == {"imported_from": str(ckpt)}
    assert payload["model"].keys() == want.keys()
    for k in want:
        assert torch.equal(payload["model"][k], want[k]), k
    assert port("export", "--run-dir", runs["port"], "--out", tmp_path / "w.npz") == 0
    # channel settings that do not fit the checkpoint are a clear error
    with pytest.raises(SystemExit, match="does not match the config"):
        port("import-torch", "--checkpoint", ckpt, "--out", tmp_path / "bad",
             "--set", *TINY_2D, "unet.base_channels=16")


# ----------------------------------------------------------------- refusals


def test_bad_inputs():
    with pytest.raises(SystemExit, match="unknown preset"):
        port("train", "--preset", "nope", "--root-dir", "/x")
    with pytest.raises(SystemExit, match="key=value"):
        port("train", "--preset", "slice_cond_2d", "--set", "badformat")
    with pytest.raises(KeyError, match="unknown override"):
        port("train", "--preset", "slice_cond_2d", "--set", "train.nope=1")
    with pytest.raises(FileNotFoundError):
        port("info", "--run-dir", "/nonexistent/run")


@pytest.mark.parametrize("argv", [
    ["train", "--num-processes", "2"],
    ["train", "--coordinator", "localhost:1234"],
    ["train", "--process-id", "0"],
    ["sample", "--run-dir", "{run}", "--data-parallel"],
    ["eval", "--run-dir", "{run}", "--data-parallel"],
], ids=["num-processes", "coordinator", "process-id", "sample", "eval"])
def test_multi_device_flags_name_the_parallel_slice(tmp_path, argv, monkeypatch):
    """The multi-device flags are no longer refused. A train flag without
    a full rendezvous (and no torchrun or SLURM variables) fails loudly
    instead of dropping to one process; ``--data-parallel`` in one process
    is a world of one and gets as far as the run's (missing) checkpoint."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID",
                "SLURM_NTASKS", "MRIJAX_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    run = tmp_path / "run"
    run.mkdir()
    preset_slice_cond_2d(str(tmp_path)).to_json(run / "config.json")
    argv = [a.replace("{run}", str(run)) for a in argv]
    if argv[0] == "train":
        with pytest.raises(RuntimeError, match="multi-process start-up"):
            port(*argv)
    else:
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            port(*argv)
    assert not torch.distributed.is_initialized()


def test_multihost_environment_is_refused(monkeypatch):
    """A multi-task SLURM allocation makes ``train`` one rank of a job: with
    no rank and no address to meet the others at, it fails loudly."""
    for var in ("RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="multi-process start-up"):
        port("train", "--preset", "slice_cond_2d")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    args = cli.build_parser().parse_args(["train", "--num-processes", "1"])
    assert not cli._multihost_mode(args)   # one process is a plain run


def test_guidance_with_3d_and_export_aot_of_25d_are_refused(tmp_path):
    run3d, run25 = tmp_path / "r3", tmp_path / "r25"
    run3d.mkdir()
    run25.mkdir()
    preset_ddpm_3d_ldm(str(tmp_path)).to_json(run3d / "config.json")
    ExperimentConfig(family="ddpm_25d").to_json(run25 / "config.json")
    with pytest.raises(SystemExit, match="guidance-scale is not supported"):
        port("sample", "--run-dir", run3d, "--guidance-scale", "2")
    with pytest.raises(SystemExit, match="export-aot supports"):
        port("export-aot", "--run-dir", run25, "--out", tmp_path / "p.pt2")


@pytest.fixture(scope="module")
def exported_2d(tmp_path_factory):
    """A tiny 2D program and matching weights, as ``export-aot`` / ``export``
    write them."""
    from mrijax_torch import aot

    d = tmp_path_factory.mktemp("served")
    cfg = preset_slice_cond_2d("/unused", **{k: json.loads(v) for k, v in
                                             (s.split("=") for s in TINY_2D)})
    program = aot.save_exported(d / "p.pt2", aot.build_slice_sampler(
        cfg, num_samples=2, ddim_steps=2, device="cpu"))
    return d, program, cfg


def test_serve_refuses_missing_vae_and_mismatched_weights(exported_2d, tmp_path):
    d, program, _ = exported_2d
    w3d = tmp_path / "ldm.npz"
    save_params_npz(w3d, {"w": np.zeros(2, np.float32)}, meta={"family": "ddpm_3d_ldm"})
    with pytest.raises(SystemExit, match="VAE weights not found"):
        port("serve", "--program", program, "--weights", w3d, "--out", tmp_path / "o")
    bad = tmp_path / "bad.npz"
    save_params_npz(bad, {"params": {"dense": {"kernel": np.zeros((2, 2), np.float32)}}},
                    meta={"family": "slice_cond_2d"})
    with pytest.raises(SystemExit, match="mismatch"):
        port("serve", "--program", program, "--weights", bad, "--out", tmp_path / "o")
    other = tmp_path / "other.npz"
    save_params_npz(other, {}, meta={"family": "ddpm_25d"})
    with pytest.raises(SystemExit, match="serve supports"):
        port("serve", "--program", program, "--weights", other, "--out", tmp_path / "o")


def test_without_cuda_computing_subcommands_exit_and_doctor_answers(exported_2d, tmp_path,
                                                                    capsys):
    assert not torch.cuda.is_available()
    d, program, cfg = exported_2d
    run = tmp_path / "run"
    run.mkdir()
    cfg.to_json(run / "config.json")
    for argv in (["sample", "--run-dir", run], ["train", "--root-dir", tmp_path],
                 ["export-aot", "--run-dir", run, "--out", tmp_path / "p.pt2"],
                 ["preprocess", "--root-dir", tmp_path, "--output-dir", tmp_path / "o"]):
        with pytest.raises(SystemExit, match=r"torch.cuda.is_available\(\) is False"):
            cli.main([str(a) for a in argv])
    # the program was traced on the CPU: serving it on the card is refused first
    with pytest.raises(ValueError, match="exported for device type 'cpu'"):
        cli.main(["serve", "--program", str(program), "--weights", "x.npz", "--out", "o"])
    assert cli.main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "cuda available=False" in out and "kernel library groupnorm_silu" in out
    r = subprocess.run([sys.executable, "-m", "mrijax_torch.cli", "sample", "--run-dir",
                        str(run)], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
