"""Observability: metrics logging, preemption signals, step timing and
device memory. Counterpart of ``mrijax/obs`` (energy accounting, profiling
and run analysis are not ported yet)."""

from mrijax_torch.obs.logger import MetricsLogger, NullLogger
from mrijax_torch.obs.signals import install_signal_handlers, reset_termination, should_terminate
from mrijax_torch.obs.timing import StepTimer, device_memory_stats

__all__ = [
    "MetricsLogger",
    "NullLogger",
    "install_signal_handlers",
    "should_terminate",
    "reset_termination",
    "StepTimer",
    "device_memory_stats",
]
