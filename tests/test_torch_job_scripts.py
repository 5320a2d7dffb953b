"""The port's SLURM job scripts (``scripts/torch_*.sh``).

Each script is syntax-checked with ``bash -n``; then copied into a temporary
tree with stub ``python``, ``torchrun`` and ``scontrol`` programs first on
``PATH``, so that running it records the command line it would start, the
directory it starts it in and where its output goes, for a preset, a
``.json`` config, SLURM's variables and explicit ones. On the card
``chip_smoke.py`` runs them for real.
"""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

from _torch_threads import thread_budget  # noqa: F401  (autouse)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
NAMES = ("torch_preprocess_job.sh", "torch_sampling_job.sh", "torch_training_job.sh",
         "torch_training_job_multihost.sh")
STUB = """#!/bin/bash
{{ echo "$(basename "$0")"; echo "$PWD"; printf '%s\\n' "$@"; }} > "$STUB_ARGV"
echo "{name} ran"
"""
SCONTROL = """#!/bin/bash
[[ "$1 $2 $3" == "show hostnames nodes[3-4]" ]] && printf 'node3\\nnode4\\n'
"""


@pytest.mark.parametrize("name", NAMES)
def test_bash_syntax(name):
    subprocess.run(["bash", "-n", str(SCRIPTS / name)], check=True)


@pytest.fixture
def tree(tmp_path):
    """A repo-shaped tree: the scripts under ``scripts/``, stubs on PATH."""
    (tmp_path / "scripts").mkdir()
    for name in NAMES:
        shutil.copy2(SCRIPTS / name, tmp_path / "scripts" / name)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for stub, text in (("python", STUB.format(name="python")),
                       ("torchrun", STUB.format(name="torchrun")), ("scontrol", SCONTROL)):
        (bin_dir / stub).write_text(text)
        (bin_dir / stub).chmod(0o755)
    return tmp_path


def _run(tree, name, *args, env=None, ok=True):
    """Run a script of ``tree``; returns (program, cwd, argv, log text) or,
    with ``ok=False``, the failed process."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("SLURM_", "MRIJAX_"))}
    base.update(PATH=f"{tree / 'bin'}{os.pathsep}{os.environ['PATH']}",
                STUB_ARGV=str(tree / "argv.txt"), SLURM_JOB_ID="77")
    base.update(env or {})
    base = {k: v for k, v in base.items() if v is not None}   # None: unset
    proc = subprocess.run(["bash", str(tree / "scripts" / name), *map(str, args)], env=base,
                          capture_output=True, text=True, timeout=60)
    if not ok:
        return proc
    assert proc.returncode == 0, proc.stderr
    program, cwd, *argv = (tree / "argv.txt").read_text().splitlines()
    return program, cwd, argv, proc.stdout


def test_training_job_with_a_preset_and_a_config(tree):
    program, cwd, argv, _ = _run(tree, "torch_training_job.sh", "ddpm_3d_ldm",
                                 "--root-dir", "/data/brats", "--set", "train.epochs=3")
    assert (program, cwd) == ("python", str(tree))
    assert argv == ["-m", "mrijax_torch.cli", "train", "--preset", "ddpm_3d_ldm",
                    "--root-dir", "/data/brats", "--set", "train.epochs=3"]
    log = tree / "scripts" / "logs" / "train" / "77" / "77.out"
    assert log.read_text() == "python ran\n"
    _, _, argv, _ = _run(tree, "torch_training_job.sh", "configs/tuned.json")
    assert argv == ["-m", "mrijax_torch.cli", "train", "--config", "configs/tuned.json"]


def test_training_job_without_a_job_id_logs_under_the_time(tree):
    _run(tree, "torch_training_job.sh", "slice_cond_2d", env={"SLURM_JOB_ID": None})
    (job,) = [p.name for p in (tree / "scripts" / "logs" / "train").iterdir()]
    assert job.isdigit() and job != "77"


def test_training_job_needs_a_preset_or_config(tree):
    proc = _run(tree, "torch_training_job.sh", ok=False)
    assert proc.returncode != 0 and "usage: torch_training_job.sh" in proc.stderr


def test_sampling_job(tree):
    program, cwd, argv, _ = _run(tree, "torch_sampling_job.sh", "ckpt/slice_cond_2d/a",
                                 "--mode", "grid", "--ddim-steps", "20")
    assert (program, cwd) == ("python", str(tree))
    assert argv == ["-m", "mrijax_torch.cli", "sample", "--run-dir", "ckpt/slice_cond_2d/a",
                    "--mode", "grid", "--ddim-steps", "20"]
    assert (tree / "scripts" / "logs" / "sample" / "77" / "77.out").exists()


def test_preprocess_job_runs_on_the_cpu(tree):
    _, _, argv, _ = _run(tree, "torch_preprocess_job.sh", "/data/raw", "/data/packed")
    assert argv == ["-m", "mrijax_torch.cli", "--device", "cpu", "preprocess",
                    "--root-dir", "/data/raw", "--output-dir", "/data/packed",
                    "--image-size", "128"]
    _, _, argv, _ = _run(tree, "torch_preprocess_job.sh", "/r", "/o", "64")
    assert argv[-2:] == ["--image-size", "64"]
    assert (tree / "scripts" / "logs" / "preprocess" / "77" / "77.out").exists()
    proc = _run(tree, "torch_preprocess_job.sh", "/r", ok=False)
    assert proc.returncode != 0 and "output dir" in proc.stderr


def _torchrun(nnodes, gpus, rank, coord, *rest):
    return ["--nnodes", nnodes, "--nproc_per_node", gpus, "--node_rank", rank,
            "--rdzv_endpoint", coord, "-m", "mrijax_torch.cli", "train", *rest]


def test_multihost_job_under_slurm(tree):
    env = {"SLURM_PROCID": "1", "SLURM_NODEID": "1", "SLURM_NNODES": "2",
           "SLURM_NTASKS": "2", "SLURM_GPUS_ON_NODE": "8", "SLURM_JOB_NODELIST": "nodes[3-4]"}
    program, cwd, argv, out = _run(tree, "torch_training_job_multihost.sh", "ddpm_3d_ldm",
                                   "--name", "mh", env=env)
    assert (program, cwd) == ("torchrun", str(tree))
    assert argv == _torchrun("2", "8", "1", "node3:12355", "--preset", "ddpm_3d_ldm",
                             "--name", "mh")
    assert "node 1/2, 8 processes, endpoint=node3:12355" in out
    assert (tree / "scripts" / "logs" / "train" / "77" / "77_n1.out").read_text() == \
        "torchrun ran\n"
    env["MRIJAX_COORD_PORT"] = "29500"
    _, _, argv, _ = _run(tree, "torch_training_job_multihost.sh", "cfg.json", env=env)
    assert argv == _torchrun("2", "8", "1", "node3:29500", "--config", "cfg.json")


EXPLICIT = {"MRIJAX_NODE_RANK": "0", "MRIJAX_NNODES": "3", "MRIJAX_GPUS_PER_NODE": "4",
            "MRIJAX_COORD": "host0:12400"}


def test_multihost_job_with_explicit_variables(tree):
    program, _, argv, _ = _run(tree, "torch_training_job_multihost.sh", "slice_cond_2d",
                               env=EXPLICIT)
    assert program == "torchrun"
    assert argv == _torchrun("3", "4", "0", "host0:12400", "--preset", "slice_cond_2d")


@pytest.mark.parametrize("missing", sorted(EXPLICIT))
def test_multihost_job_fails_without_a_rank_variable(tree, missing):
    env = {k: v for k, v in EXPLICIT.items() if k != missing}
    proc = _run(tree, "torch_training_job_multihost.sh", "slice_cond_2d", env=env, ok=False)
    assert proc.returncode != 0
    assert f"set {missing}" in proc.stderr
    assert not (tree / "argv.txt").exists()
