"""Whole runs of every cell on the CPU at tiny sizes (the harness's look for a
card skipped): sound runs are ``correct``; the control and each fault the
cell can have are not; new cells, mixes and metrics are found by name; no
module of JAX or of the JAX package is loaded."""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mrijax_torch.diffusion import GaussianDiffusion
from mrijax_torch.models import VAE3D

from benchmark_h100 import calibrate, harness

CPU = torch.device("cpu")
SEED = 2**31 + 12345
GEN = ["ldm3d.gen.ddim400.b8", "slice2d.gen.sweep155.ddim50"]
TRAIN = ["ldm3d.train_cached.b32", "slice2d.train.b64"]


def _run(tiny, cell, trace=False, seconds=0.2):
    bench, bdir = tiny
    return harness.run_cell(bench, cell, SEED, seconds, trace, CPU, root=Path("/"),
                            bench_dir=bdir, min_calls=2)


@pytest.mark.parametrize("cell", GEN + TRAIN)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(tiny, cell, trace):
    r = _run(tiny, cell, trace)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check" and r["failed"] == 0 and r["attempted"] > 0
    if trace:
        assert "setup_s" not in r["metrics"] and "breakdown" in r
    else:
        assert "setup_s" in r["metrics"]
        assert ("gen_samples_per_s" if cell in GEN else "train_samples_per_s") in r["metrics"]


def _cell_parts(tiny, cell):
    bench, bdir = tiny
    w = harness.find(bench["workloads"], cell, "workload")
    config = json.loads(Path(harness.find(bench["configs"], w["config"], "config")["file"])
                        .read_text())
    mix = json.loads((bdir / "traffic" / f"{w['traffic']}.json").read_text())
    return config, mix


@pytest.mark.parametrize("cell", GEN + TRAIN)
def test_control_is_not_correct(tiny, cell):
    """The reference in float8 (its DDIM update in bfloat16) in the
    program's place fails at least one of the cell's limits."""
    config, mix = _cell_parts(tiny, cell)
    traffic = harness.load_kind(mix["kind"], tiny[1])(config, mix, SEED, CPU)
    traffic.setup()
    traffic.window(0.0, mix.get("check", {}).get("calls", 0))
    traffic.release()
    numbers = traffic.judge(control=True)
    assert any(numbers[k] > limit for k, limit in mix["limits"].items()), numbers


@contextlib.contextmanager
def _patched(cls, name, wrap):
    original = getattr(cls, name)
    setattr(cls, name, wrap(original))
    try:
        yield
    finally:
        setattr(cls, name, original)


def _step_unchanged(original):
    def ddim_step(self, model_fn, x, t, t_prev):
        original(self, model_fn, x, t, t_prev)
        return x
    return ddim_step


def _answer_altered_2d(original):
    def ddim_step(self, model_fn, x, t, t_prev):
        out = original(self, model_fn, x, t, t_prev)
        if int(t_prev[0]) == 0:     # the step that produces the answer
            out = out.clone()
            out[0] += 0.05 * out[0].std()
        return out
    return ddim_step


def _answer_altered_3d(original):
    def decode_from_latent(self, z):
        out = original(self, z).clone()
        out[0] += 0.05 * out[0].std()
        return out
    return decode_from_latent


def _optimizer_skipped(original):
    def step(self, closure=None):
        return None
    return step


FAULTS = {
    # a step that returns its state unchanged
    ("ldm3d.gen.ddim400.b8", "unchanged"): (GaussianDiffusion, "ddim_step", _step_unchanged),
    ("slice2d.gen.sweep155.ddim50", "unchanged"): (GaussianDiffusion, "ddim_step", _step_unchanged),
    ("ldm3d.train_cached.b32", "unchanged"): (torch.optim.Adam, "step", _optimizer_skipped),
    ("slice2d.train.b64", "unchanged"): (torch.optim.Adam, "step", _optimizer_skipped),
    # an answer altered where it is produced
    ("ldm3d.gen.ddim400.b8", "altered"): (VAE3D, "decode_from_latent", _answer_altered_3d),
    ("slice2d.gen.sweep155.ddim50", "altered"):
        (GaussianDiffusion, "ddim_step", _answer_altered_2d),
}


@pytest.mark.parametrize("cell, fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny, cell, fault):
    cls, name, wrap = FAULTS[(cell, fault)]
    with _patched(cls, name, wrap):
        r = _run(tiny, cell)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_not_correct(tiny, cell):
    """Half of the batch left out, the mean taken over the rest."""
    with calibrate.half_batch():
        r = _run(tiny, cell)
    assert not r["correct"], r["check"]


def test_new_cell_mix_kind_and_metric_found_by_name(tiny):
    """A cell, a traffic mix, a traffic kind and a per-layer metric added as
    new files and entries, with no existing file edited."""
    bench, bdir = tiny
    (bdir / "kinds" / "sweep_2d_new.py").write_text(
        (bdir / "kinds" / "sweep_2d.py").read_text().replace("Sweep2D", "Sweep2DNew"))
    mix = json.loads((bdir / "traffic" / "sweep155.ddim50.json").read_text())
    mix.update(kind="sweep_2d_new", num_slices=3, ddim_steps=4)
    (bdir / "traffic" / "sweep3.ddim4.json").write_text(json.dumps(mix))
    (bdir / "metrics" / "calls_per_s.gen.py").write_text(
        "def read(ctx):\n    w = ctx['window']\n    return w['calls'] / w['seconds']\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "slice2d.gen.sweep3", "config": "slice2d_128",
                               "traffic": "sweep3.ddim4", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_per_s.gen", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "sampler",
                               "moves": "gen_samples_per_s", "workloads": ["slice2d.gen.sweep3"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("gen_samples_per_s", "gen_step_p95_ms"):
            m["workloads"].append("slice2d.gen.sweep3")
    r = harness.run_cell(bench, "slice2d.gen.sweep3", SEED, 0.2, True, CPU, root=Path("/"),
                         bench_dir=bdir, min_calls=2)
    assert harness.load_kind("sweep_2d_new", bdir).__name__ == "Sweep2DNew"
    assert r["correct"] and r["metrics"]["calls_per_s.gen"]["value"] > 0
    assert r["attempted"] % 3 == 0


def test_no_jax_module_loaded(tiny, tmp_path):
    """A run in a fresh process loads nothing named jax, jaxlib, flax or
    mrijax (whole top-level names), and the reference loads nothing of the
    program."""
    bench, bdir = tiny
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    repo = Path(__file__).resolve().parents[2]
    code = f"""
import json, sys
from pathlib import Path
sys.path.insert(0, {str(repo)!r})
import torch
import benchmark_h100.reference.nets, benchmark_h100.reference.diffusion
loaded = [m for m in sys.modules if m.split('.')[0] == 'mrijax_torch']
assert not loaded, 'the reference loads the program'
from benchmark_h100 import harness
bench = json.loads(Path({str(tmp_path / 'bench.json')!r}).read_text())
r = harness.run_cell(bench, 'slice2d.gen.sweep155.ddim50', 3, 0.1, False, torch.device('cpu'),
                     root=Path('/'), bench_dir=Path({str(bdir)!r}), min_calls=2)
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_sources_import_nothing_of_the_program():
    ref_dir = Path(__file__).resolve().parents[1] / "reference"
    for path in ref_dir.glob("*.py"):
        for line in path.read_text().splitlines():
            if line.startswith(("import ", "from ")):
                top = line.split()[1].split(".")[0]
                assert top not in ("mrijax", "mrijax_torch", "jax", "flax"), (path.name, line)


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the 2D sweep cell on the card, through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    repo = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "benchmark_h100/run.py", "--workload",
                          "slice2d.gen.sweep155.ddim50", "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=repo, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
