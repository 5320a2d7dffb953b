"""Observability: metrics logging, preemption signals, step timing, device
memory, energy accounting (NVML on the card), profiler traces and run
analysis. Counterpart of ``mrijax/obs``, with its ``__all__`` and the span
registry's ``span`` and ``spans``."""

from mrijax_torch.obs.logger import MetricsLogger, NullLogger
from mrijax_torch.obs.signals import install_signal_handlers, reset_termination, should_terminate
from mrijax_torch.obs.timing import StepTimer, device_memory_stats
from mrijax_torch.obs.energy import EnergyMonitor, NullEnergySensor, run_with_energy
from mrijax_torch.obs.analyze import analyze_run, format_report
from mrijax_torch.obs.profiling import trace, step_annotation, annotate, span, spans

__all__ = [
    "MetricsLogger",
    "NullLogger",
    "install_signal_handlers",
    "should_terminate",
    "reset_termination",
    "StepTimer",
    "device_memory_stats",
    "EnergyMonitor",
    "NullEnergySensor",
    "run_with_energy",
    "analyze_run",
    "format_report",
    "trace",
    "step_annotation",
    "annotate",
    "span",
    "spans",
]
