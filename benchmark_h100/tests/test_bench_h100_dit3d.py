"""The two cells of the DiT and data-parallel kinds on the CPU at tiny sizes:
``dit3d.gen.ddim50.b4`` (``kinds/generate_dit3d.py``) and
``ldm3d.train_cached.b32.ddp4`` (``kinds/train_cached_latent_ddp.py``, four
gloo processes); the frozen reference ``reference/dit3d.py`` against the
program's own plain reference; the counts of the published widths; and the
readers of declared spans, silent for a program that declares none."""

import json
from pathlib import Path

import pytest
import torch

from mrijax_torch.models import DiT3D
from mrijax_torch.models import dit3d_reference as program_ref

from benchmark_h100 import declared_spans, harness, seeding
from benchmark_h100.count import ops
from benchmark_h100.reference import dit3d

CPU = torch.device("cpu")
SEED = 2**31 + 777
DIT = "dit3d.gen.ddim50.b4"
DDP = "ldm3d.train_cached.b32.ddp4"
TINY_DIT = dict(latent=[4, 8, 8], in_channels=4, patch_size=2, hidden_size=48, depth=2,
                num_heads=4, frequency_embedding_size=32,
                vae=dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4),
                diffusion=dict(timesteps=20, schedule="linear", loss_type="mse", t_min=0))
DIT_METRICS = ("dit_msa_ms.gen", "dit_flash_ms.gen", "dit_mlp_ms.gen")


@pytest.fixture
def cells(tiny):
    """The tiny benchmark with the DiT configuration and both mixes cut
    down too."""
    bench, bdir = tiny
    path = bdir / "configs" / "dit3d_xl2.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_DIT}))
    for name, update in (("gen3d_dit.ddim50.b4", dict(batch=2, ddim_steps=6, decode_chunk=1)),
                         ("train_cached.b32.ddp4", dict(batch=8, ranks=4, pool_rows=12,
                                                        check={"micro_batch": 2}))):
        mix_path = bdir / "traffic" / f"{name}.json"
        mix = {**json.loads(mix_path.read_text()), **update}
        mix["profile"] = {"skip": 1, "active": 2}
        mix_path.write_text(json.dumps(mix))
    return bench, bdir


def _run(cells, cell, trace):
    bench, bdir = cells
    return harness.run_cell(bench, cell, SEED, 0.1, trace, CPU, root=Path("/"), bench_dir=bdir,
                            min_calls=2)


@pytest.mark.parametrize("trace", [False, True])
def test_dit_cell_runs_correct_and_reads_its_metrics(cells, trace):
    r = _run(cells, DIT, trace)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 4
    got = set(r["metrics"])
    if trace:
        # the device-trace shares read kernels, which the CPU has none of
        assert {"mfu.gen", "denoise_ms_per_step.gen", *DIT_METRICS} <= got
        assert "decode_ms_per_volume.gen" not in got and "gn_silu_roofline.gen" not in got
        for name in DIT_METRICS:
            assert r["metrics"][name]["value"] > 0, name
        # the attention core lies inside the attention branch
        ms = {name: r["metrics"][name]["value"] for name in DIT_METRICS}
        assert ms["dit_flash_ms.gen"] <= ms["dit_msa_ms.gen"]
    else:
        assert {"gen_samples_per_s", "gen_step_p95_ms", "setup_s"} <= got


def test_dit_control_is_not_correct(cells):
    bench, bdir = cells
    w = harness.find(bench["workloads"], DIT, "workload")
    config = json.loads(Path(harness.find(bench["configs"], w["config"], "config")["file"])
                        .read_text())
    mix = json.loads((bdir / "traffic" / f"{w['traffic']}.json").read_text())
    traffic = harness.load_kind(mix["kind"], bdir)(config, mix, SEED, CPU)
    traffic.setup()
    traffic.window(0.0, mix["check"]["calls"])
    traffic.release()
    numbers = traffic.judge(control=True)
    assert any(numbers[k] > limit for k, limit in mix["limits"].items()), numbers


@pytest.mark.parametrize("trace", [False, True])
def test_data_parallel_cell_over_four_gloo_processes(cells, trace):
    """Four processes, the children started by the kind: every run
    ``correct`` against the reference at the global batch; the traced run
    reads the all-reduce's span on rank 0; the children have exited."""
    r = _run(cells, DDP, trace)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    if trace:
        assert r["metrics"]["train_allreduce_ms.train"]["value"] > 0
        assert {"mfu.train", "train_backward_ms.train"} <= set(r["metrics"])
    else:
        assert r["metrics"]["train_samples_per_s"]["value"] > 0
    assert not torch.distributed.is_initialized()


def test_frozen_reference_is_the_programs_reference():
    torch.manual_seed(0)
    model = DiT3D(in_channels=4, patch=2, hidden=48, depth=2, heads=4, freq_dim=32)
    p = seeding.make_weights(seeding.param_spec(model), SEED, seeding.WEIGHTS_UNET, CPU)
    x, t = torch.randn(2, 4, 6, 6, 4), torch.tensor([0, 19])
    cfg = dict(patch_size=2, num_heads=4, depth=2, frequency_embedding_size=32)
    want = program_ref.dit3d_forward(p, x, t, patch=2, heads=4, freq_dim=32)
    assert torch.equal(dit3d.dit3d(p, cfg, x, t), want)
    assert not torch.equal(dit3d.dit3d(p, cfg, x, t, "fp8"), want)


def test_counts_of_the_published_widths():
    """673 921 280 parameters; a forward of one 6400-token sample counts
    11.0 TFLOP, 5.28 of them the 28 attention products 4·N²·C."""
    with torch.device("meta"):
        model = DiT3D()
    spec = seeding.param_spec(model)
    assert sum(p.numel() for p in model.parameters()) == 673_921_280
    assert {kind for _, _, kind in spec} == {"linear", "bias"}
    config = json.loads((Path(harness.BENCH_DIR) / "configs" / "dit3d_xl2.json").read_text())
    with ops.counting() as unit:
        dit3d.dit3d(seeding.make_weights(spec, 0, 0, "meta"), config,
                    torch.empty((1, 32, 40, 40, 16), device="meta"),
                    torch.zeros(1, dtype=torch.long, device="meta"))
    assert unit.attention == [(1, 6400, 1152)] * 28
    assert sum(ops.attention_flops(*a) for a in unit.attention) == pytest.approx(5.284e12,
                                                                                 rel=1e-3)
    assert unit.total_flops == pytest.approx(10.99e12, rel=2e-3)


def test_declared_span_readers_are_silent_without_the_declaration(monkeypatch):
    from mrijax_torch.models import dit3d as program
    from mrijax_torch.train import steps

    ctx = {"role": "gen", "trace": {"units": 1}}
    assert declared_spans.declared("mrijax_torch.models.dit3d", "dit.flash")
    assert declared_spans.declared("mrijax_torch.train.steps", "train.allreduce")
    assert not declared_spans.declared("mrijax_torch.no_such_module", "dit.flash")
    monkeypatch.delattr(program, "SPANS")
    monkeypatch.delattr(steps, "SPANS")
    for name in DIT_METRICS:
        assert harness.read_metric(name, ctx) is None
    assert harness.read_metric("train_allreduce_ms.train", {**ctx, "role": "train"}) is None
