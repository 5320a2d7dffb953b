"""The rest of the port's ``obs`` — run analysis, energy accounting and
profiler traces — against ``mrijax.obs`` on the same inputs: the same report
from the same ``metrics.jsonl``, the same energy summary for the same power,
window and busy time. ``NvmlPowerSensor`` reads the card through NVML, which
is absent here; ``tests/test_torch_cli_cuda.py`` reads it on the card."""

import json
import time

import numpy as np
import pytest
import torch

from mrijax.obs import analyze as janalyze
from mrijax.obs import energy as jenergy
from mrijax.obs import timing as jtiming
from mrijax_torch.obs import analyze, energy, profiling
from mrijax_torch.obs import timing


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
