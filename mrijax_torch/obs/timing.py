"""Step timing and device memory telemetry.

Counterpart of ``mrijax/obs/timing.py``. CUDA work is queued and runs after
the host call returns, so the timer accumulates the host's start→stop spans
and ``finalize`` stretches them to the first start → now wall once a value
readback has waited for every queued step. ``device_memory_stats`` reads
PyTorch's CUDA allocator statistics.
"""

import threading
import time
from typing import Dict, Optional, Union

import torch

# Process-wide accumulated device-busy wall time (every timed step adds its
# duration), for an energy monitor's busy/idle share.
_BUSY_LOCK = threading.Lock()
_BUSY_TOTAL_S = 0.0


def add_busy_seconds(dt: float) -> None:
    global _BUSY_TOTAL_S
    with _BUSY_LOCK:
        _BUSY_TOTAL_S += dt


def busy_seconds() -> float:
    with _BUSY_LOCK:
        return _BUSY_TOTAL_S


class StepTimer:
    """Accumulates step wall-times without forcing a device sync.

    The trainer's use: ``start()``/``stop()`` around each step's dispatch,
    then ``finalize()`` AFTER a value readback has forced all queued steps to
    complete — it stretches the accumulated time to the true first-dispatch →
    completion wall, so ``steps_per_s`` measures device execution rather than
    dispatch. ``stop(block_on=t)`` waits for the device of the CUDA tensor
    ``t`` first, for synchronous micro-timing."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.num_steps = 0
        self.total_s = 0.0
        self._t0 = None
        self._first = None

    def start(self):
        self._t0 = time.perf_counter()
        if self._first is None:
            self._first = self._t0

    def stop(self, block_on: Optional[torch.Tensor] = None):
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        dt = time.perf_counter() - self._t0
        self.num_steps += 1
        self.total_s += dt
        add_busy_seconds(dt)
        return dt

    def finalize(self):
        """Call after the timed work's results have been READ BACK: extends
        the accumulated time to cover device work that was still in flight
        when the per-step ``stop()`` calls returned."""
        if self._first is None:
            return
        wall = time.perf_counter() - self._first
        if wall > self.total_s:
            add_busy_seconds(wall - self.total_s)
            self.total_s = wall

    @property
    def steps_per_s(self) -> float:
        return self.num_steps / max(self.total_s, 1e-8)


def device_memory_stats(device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    """Current, peak and total device memory in GiB, under the keys of the JAX
    package. A CPU device gives zeros (no allocator statistics), as the JAX
    package's CPU devices do."""
    device = torch.device("cuda" if device is None else device)
    gib = 1024 ** 3
    if device.type != "cuda":
        return {"bytes_in_use_gib": 0.0, "peak_bytes_in_use_gib": 0.0,
                "bytes_limit_gib": 0.0}
    return {
        "bytes_in_use_gib": torch.cuda.memory_allocated(device) / gib,
        "peak_bytes_in_use_gib": torch.cuda.max_memory_allocated(device) / gib,
        "bytes_limit_gib": torch.cuda.get_device_properties(device).total_memory / gib,
    }
