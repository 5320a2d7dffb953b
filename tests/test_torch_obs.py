"""The rest of the port's ``obs`` — run analysis, energy accounting and
profiler traces — against ``mrijax.obs`` on the same inputs: the same report
from the same ``metrics.jsonl``, the same energy summary for the same power,
window and busy time. ``NvmlPowerSensor`` reads the card through NVML, which
is absent here; ``tests/test_torch_cli_cuda.py`` reads it on the card. The
span registry (``profiling.span``, ``spans``) has no JAX counterpart: its
tests hold it to the profiler's clock and sessions, and to the train step's
split."""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.obs import analyze as janalyze
from mrijax.obs import energy as jenergy
from mrijax.obs import timing as jtiming
from mrijax_torch.diffusion import GaussianDiffusion, linear_beta_schedule, make_schedule
from mrijax_torch.models import UNet2D
from mrijax_torch.models.blocks import GroupNormSiLU, _Conv, _Downsample, _Upsample
from mrijax_torch.obs import analyze, energy, profiling
from mrijax_torch.obs import timing
from mrijax_torch.train import TrainState, make_diffusion_train_step


def write_metrics(run_dir, seed=0):
    """A ``metrics.jsonl`` as the trainer and the CLI write it: per-epoch
    steps/s and epoch times of a one-stage and a two-stage run, losses,
    memory, the latent scale and an energy summary."""
    rng = np.random.default_rng(seed)
    run_dir.mkdir(parents=True, exist_ok=True)
    records, ts = [], 1.7e9
    for prefix in ("", "vae_", "ldm_"):
        for epoch in range(3):
            for key, value in (("steps_per_s", rng.uniform(2, 9)),
                               ("epoch_time_s", rng.uniform(10, 90)),
                               ("train_loss", rng.uniform(0.01, 1)),
                               ("val_loss", rng.uniform(0.01, 1)),
                               ("peak_mem_gib", rng.uniform(1, 70))):
                ts += float(rng.uniform(0.1, 30))
                records.append({"key": prefix + key, "value": float(value),
                                "step": epoch, "ts": ts})
    for key in ("latent_scale", "energy_runtime_s", "energy_avg_power_w", "energy_joules"):
        ts += 1.0
        records.append({"key": key, "value": float(rng.uniform(1, 500)), "step": None, "ts": ts})
    (run_dir / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    return run_dir


@pytest.mark.parametrize("seed", [0, 1])
def test_analyze_run_and_report_equal_jax(tmp_path, seed):
    run = write_metrics(tmp_path / "run", seed)
    want = janalyze.analyze_run(run)
    got = analyze.analyze_run(run)
    assert got == want
    assert analyze.format_report(got) == janalyze.format_report(want)
    assert {"train", "vae", "ldm", "max_log_gap_s"} <= set(got)


def test_analyze_main_writes_the_report(tmp_path, capsys):
    run = write_metrics(tmp_path / "run")
    out = tmp_path / "report.txt"
    assert analyze.main([str(run), "--out", str(out)]) == 0
    assert out.read_text() == janalyze.format_report(janalyze.analyze_run(run))
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        analyze.analyze_run(tmp_path / "missing")


@pytest.mark.parametrize("power_w,busy", [(170.0, 12.5), (612.25, 0.0), (0.0, 99.0)])
def test_energy_summary_equals_jax(monkeypatch, power_w, busy):
    """Same window, samples and busy time → the same summary, key for key."""
    monkeypatch.setattr(jtiming, "busy_seconds", lambda: 1000.0 + busy)
    monkeypatch.setattr(energy, "busy_seconds", lambda: 1000.0 + busy)
    monitors = [jenergy.EnergyMonitor(sensor=jenergy.ConstantPowerSensor(power_w)),
                energy.EnergyMonitor(sensor=energy.ConstantPowerSensor(power_w=power_w))]
    for mon in monitors:
        mon._t_start, mon._t_stop, mon._busy0 = 5.0, 105.25, 1000.0
        mon._samples = [mon.sensor.read_power_w()] * 7
    want, got = (m.summary() for m in monitors)
    assert got == want
    assert got["energy_joules"] == power_w * 100.25
    assert got["device_idle_fraction"] == max(0.0, 1 - busy / 100.25)


class RecordingLogger:
    def __init__(self):
        self.metrics = {}

    def log_metric(self, key, value, step=None):
        self.metrics[key] = value


def test_run_with_energy_logs_the_same_keys():
    loggers = RecordingLogger(), RecordingLogger()
    assert jenergy.run_with_energy(lambda: 3, logger=loggers[0],
                                   sensor=jenergy.ConstantPowerSensor(50.0)) == 3
    t0 = time.perf_counter()
    assert energy.run_with_energy(lambda: 3, logger=loggers[1],
                                  sensor=energy.ConstantPowerSensor(power_w=50.0)) == 3
    assert time.perf_counter() - t0 < 5
    assert loggers[1].metrics.keys() == loggers[0].metrics.keys()
    assert {k for k in loggers[1].metrics} == {
        f"energy_{k}" for k in ("runtime_s", "avg_power_w", "energy_joules", "energy_kwh",
                                "co2_kg", "cost_eur", "device_busy_s", "device_idle_fraction")}
    assert loggers[1].metrics["energy_avg_power_w"] == 50.0


class CounterSensor:
    """A sensor with an energy counter: 10 J a read, 200 W."""

    def __init__(self):
        self.joules = 0.0

    def read_power_w(self):
        return 200.0

    def read_energy_j(self):
        self.joules += 10.0
        return self.joules


def test_energy_counter_gives_the_energy_where_the_sensor_has_one():
    mon = energy.EnergyMonitor(sensor=CounterSensor(), interval_s=0.01)
    mon.start()
    time.sleep(0.05)
    summary = mon.stop()
    assert summary["energy_joules"] == 10.0      # stop − start of the counter
    assert summary["avg_power_w"] == 200.0
    assert summary["energy_kwh"] == 10.0 / 3.6e6


def test_busy_time_comes_from_the_step_timer():
    mon = energy.EnergyMonitor()
    mon.start()
    timing.add_busy_seconds(0.25)
    summary = mon.stop()
    assert summary["device_busy_s"] == pytest.approx(0.25)
    assert summary["avg_power_w"] == 0.0 and summary["energy_joules"] == 0.0


def test_nvml_sensor_says_why_it_cannot_be_made_here():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="NVML"):
        energy.NvmlPowerSensor(0)
    # without a power of its own, the constant sensor asks NVML for the limit
    with pytest.raises(RuntimeError, match="NVML"):
        energy.ConstantPowerSensor()


def test_trace_names_the_step_annotation(tmp_path):
    @profiling.annotate("decorated_fn")
    def work(x):
        return x * 2 + 1

    with profiling.trace(tmp_path / "prof") as log_dir:
        for step in range(2):
            with profiling.step_annotation("train_step", step):
                work(torch.ones(8))
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert log_dir == str(tmp_path / "prof") and len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"train_step#0", "train_step#1", "decorated_fn"} <= names
    assert work.__name__ == "work"


@contextlib.contextmanager
def profiled():
    """A CPU profiler session that starts a new span session: a span entered
    while no profiler records ends the one before."""
    with profiling.span("obs.off"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


def test_span_off_records_nothing_and_is_the_shared_noop():
    reg = profiling.SpanRegistry()
    first, second = reg.span("a"), reg.span("b")
    assert first is second is profiling.span("c")
    with first:
        torch.ones(4).sum()
    assert reg.records == [] and reg.spans() == [] and not reg.live


def test_span_brackets_its_operator_on_the_profilers_clock():
    a = torch.randn(64, 64)
    with profiled() as prof:
        with profiling.span("obs.mm", stream=True):
            time.sleep(2e-4)
            a @ a
            time.sleep(2e-4)
        with profiling.span("obs.mm.host"):
            a @ a
    s, host = profiling.spans("obs.mm")
    start = prof.profiler.kineto_results.trace_start_ns()
    mm, _ = [e for e in prof.events() if e.name == "aten::mm"]
    assert s.t0_ns < start + round(mm.time_range.start * 1e3)
    assert start + round(mm.time_range.end * 1e3) < s.t1_ns
    assert s.host_ms == s.stream_ms == (s.t1_ns - s.t0_ns) / 1e6 > 0.4
    assert host.name == "obs.mm.host" and host.stream_ms is None and host.host_ms > 0


def test_span_adds_no_event_to_the_profiler():
    with profiled() as prof:
        with profiling.span("obs.quiet"):
            torch.ones(8) + 1
    assert [s.name for s in profiling.spans("obs.")] == ["obs.quiet"]
    names = [e.name for e in prof.events()]
    assert "obs.quiet" not in names and "aten::add" in names
    assert not [e.name for e in prof.events() if e.is_user_annotation]


def test_a_second_session_hides_the_first():
    with profiled():
        with profiling.span("obs.first"):
            pass
    with profiling.span("obs.between"):
        pass
    assert [s.name for s in profiling.spans("obs.")] == ["obs.first"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("obs.second"):
            pass
        with profiling.span("obs.second"):
            pass
    assert [s.name for s in profiling.spans("obs.")] == ["obs.second"] * 2


def test_span_store_is_bounded_and_counts_what_it_drops():
    reg = profiling.SpanRegistry()
    reg.capacity = 3
    with profiled():
        for _ in range(5):
            with reg.span("obs.many"):
                pass
    assert len(reg.spans()) == 3 and reg.dropped == 2


class PlainStep:
    """A plain gradient step in Adam's place: the split under test is the
    train step's, and a torch optimizer's first construction imports
    ``torch._dynamo`` (seconds)."""

    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:
                p.sub_(self.lr * p.grad)


def test_train_step_records_its_split_once_and_a_backward_per_groupnorm():
    torch.manual_seed(0)
    net = UNet2D(base_channels=8, channel_mults=(1, 2), time_emb_dim=8)
    step = make_diffusion_train_step(net, GaussianDiffusion(make_schedule(linear_beta_schedule(20))),
                                     nan_guard=True)
    state = TrainState(net, PlainStep(net.parameters(), 1e-3))
    batch = {"image": torch.randn(1, 8, 8, 1), "z_pos": torch.rand(1)}
    g = torch.Generator().manual_seed(0)
    with profiled():
        step(state, batch, g)
    names = [s.name for s in profiling.spans()]
    for part in ("train.forward", "train.backward", "train.update", "train.guard"):
        assert names.count(part) == 1, part
    norms = sum(isinstance(m, GroupNormSiLU) for m in net.modules())
    assert norms > 0 and names.count("gn_silu.backward") == norms
    split = {s.name: s for s in profiling.spans("train.")}
    guard, update = split["train.guard"], split["train.update"]
    assert update.t0_ns <= guard.t0_ns <= guard.t1_ns <= update.t1_ns
    assert split["train.forward"].t1_ns <= split["train.backward"].t0_ns
    # the step's split times the stream; the guard and each norm stay on the host
    for part in ("train.forward", "train.backward", "train.update"):
        assert split[part].stream_ms == split[part].host_ms, part
    assert guard.stream_ms is None
    assert all(s.stream_ms is None for s in profiling.spans("gn_silu."))
    assert state.step == 1


def test_unet_forward_records_a_span_for_each_convolution_by_its_kind():
    torch.manual_seed(0)
    net = UNet2D(base_channels=8, channel_mults=(1, 2), time_emb_dim=8)
    with profiled():
        net(torch.randn(1, 8, 8, 1), torch.tensor([3]), torch.rand(1))
    names = [s.name for s in profiling.spans("conv")]
    downs = sum(isinstance(m, _Downsample) for m in net.modules())
    ups = sum(isinstance(m, _Upsample) for m in net.modules())
    convs = sum(isinstance(m, _Conv) and not isinstance(m, _Downsample) for m in net.modules())
    assert downs > 0 and names.count("conv.down") == downs
    assert ups > 0 and names.count("conv.up") == ups
    assert names.count("conv") == convs > 0 and len(names) == downs + ups + convs
    assert all(s.stream_ms is None for s in profiling.spans("conv"))
