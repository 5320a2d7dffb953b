"""The per-layer metrics that read the program's spans, in traced runs of
every cell on the CPU at tiny sizes: each cell reports exactly the span
metrics whose ``workloads`` list it, and the spans a traced unit records
match the model (one forward, backward and update a train step, which time
the stream; one GroupNorm+SiLU backward a norm and one convolution span a
convolution a denoise step, on the host only). A reader raises where the
program has spans and a listed cell's traced segment recorded none of its
own, and reads nothing from a program without them."""

import json
import math
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from mrijax_torch.models import UNet2D, UNet3D
from mrijax_torch.models.blocks import GroupNormSiLU, _Conv, _Downsample, _Upsample
from mrijax_torch.obs import profiling

from benchmark_h100 import harness, program_spans
from benchmark_h100.kind_base import UNET2D_KEYS, UNET3D_KEYS, _kw

CPU = torch.device("cpu")
SEED = 2**31 + 4242
CELLS = ["ldm3d.gen.ddim400.b8", "slice2d.gen.sweep155.ddim50", "ldm3d.train_cached.b32",
         "slice2d.train.b64"]
SPAN_METRICS = ("train_forward_ms.train", "train_backward_ms.train", "train_update_ms.train")


def _traced(tiny, cell):
    """A traced run's result, the spans it left and its traced units."""
    bench, bdir = tiny
    r = harness.run_cell(bench, cell, SEED, 0.1, True, CPU, root=Path("/"), bench_dir=bdir,
                         min_calls=2)
    mix = json.loads((bdir / "traffic" / f"{_cell(bench, cell)['traffic']}.json").read_text())
    return r, profiling.spans(), mix["profile"]["active"]


def _cell(bench, cell):
    return harness.find(bench["workloads"], cell, "workload")


def _net(tiny, cell):
    bench, _ = tiny
    config = json.loads(Path(harness.find(bench["configs"], _cell(bench, cell)["config"],
                                          "config")["file"]).read_text())
    if "latent" in config:
        return UNet3D(**_kw(config["unet"], UNET3D_KEYS)), config
    return UNet2D(**_kw(config["unet"], UNET2D_KEYS)), config


def _count(net, cls, but=()):
    return sum(isinstance(m, cls) and not isinstance(m, but) for m in net.modules())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_its_span_metrics_and_spans_match_the_model(tiny, cell):
    r, recorded, units = _traced(tiny, cell)
    bench, _ = tiny
    want = {m["name"] for m in bench["per_layer"]
            if m["name"] in SPAN_METRICS and harness.applies(m, _cell(bench, cell))}
    assert {name for name in r["metrics"] if name in SPAN_METRICS} == want
    for name in want:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)

    names = Counter(s.name for s in recorded)
    net, config = _net(tiny, cell)
    if cell.split(".")[1] == "gen":
        assert names["conv"] == units * _count(net, _Conv, (_Downsample,))
        assert names["conv.down"] == units * _count(net, _Downsample)
        assert names["conv.up"] == units * _count(net, _Upsample)
        assert not any(n.startswith(("train.", "gn_silu.", "sampler.")) for n in names)
    else:
        guard = config["train"]["nan_guard"]
        assert names["train.forward"] == names["train.backward"] == units
        assert names["train.update"] == units
        assert names["train.guard"] == (units if guard else 0)
        assert names["gn_silu.backward"] == units * _count(net, GroupNormSiLU) > 0
    timed = ("train.forward", "train.backward", "train.update")
    assert all(s.t0_ns <= s.t1_ns for s in recorded)
    assert all((s.stream_ms == s.host_ms) if s.name in timed else s.stream_ms is None
               for s in recorded)


def test_two_traced_runs_in_one_process_do_not_mix_their_spans(tiny):
    cell = "slice2d.train.b64"
    first, spans1, _ = _traced(tiny, cell)
    second, spans2, _ = _traced(tiny, cell)
    assert Counter(s.name for s in spans1) == Counter(s.name for s in spans2)
    assert max(s.t1_ns for s in spans1) < min(s.t0_ns for s in spans2)
    for name in SPAN_METRICS:
        assert name in first["metrics"] and name in second["metrics"]


def test_reader_raises_where_the_span_went_missing_and_is_silent_without_spans(monkeypatch):
    ctx = {"role": "train", "trace": {"units": 2}}
    with profiling.span("bench.off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("train.backward"):
            pass
    with pytest.raises(RuntimeError, match="no span 'train.forward'"):
        program_spans.stream_ms_per_unit(ctx, "train", "train.forward")
    with pytest.raises(RuntimeError, match="does not time the stream"):
        program_spans.stream_ms_per_unit(ctx, "train", "train.backward")
    assert program_spans.stream_ms_per_unit(ctx, "gen", "train.forward") is None
    monkeypatch.setitem(sys.modules, "mrijax_torch.obs.profiling", None)
    assert program_spans.stream_ms_per_unit(ctx, "train", "train.forward") is None
