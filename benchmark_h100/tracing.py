"""The traced segment of a ``--trace 1`` run, and what is read from it.

``Segment`` wraps ``torch.profiler``: a traffic calls ``unit()`` at the start
of every unit of its work (a denoise step, a train step) and ``finish()``
after the last. Units ``skip`` … ``skip + active − 1`` are traced: at the
first of them the device is synchronised, the profiler started and the host
clock read; at the end of the last the device is synchronised, the clock
read and the profiler stopped. ``window_s`` is that span of the host clock.

From the profiler's events (``prof.events()``; device events are those whose
``device_type`` is not the CPU: kernels, copies and fills):

* ``busy_s``: the union of the device events' intervals;
* ``kernel_s(*names)``: device seconds of the events whose name contains one
  of ``names``;
* ``device_ops``: the ten names with the most device time;
* ``idle_gaps``: the ten longest gaps between device events, each named by
  the innermost host event that was running when the gap began.
"""

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Segment:
    def __init__(self, device: torch.device, skip: int, active: int):
        self.device, self.skip, self.active = device, skip, active
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.units = 0          # units started
        self.traced = 0         # units inside the trace
        self.t0 = self.t1 = None

    def unit(self) -> None:
        if self.units == self.skip:
            _sync(self.device)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.units == self.skip + self.active:
            self._close()
        if self.t0 is not None and self.t1 is None:
            self.traced += 1
        self.units += 1

    def _close(self) -> None:
        if self.t0 is None or self.t1 is not None:
            return
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def finish(self) -> Optional[dict]:
        """Close the trace and read it: None where nothing was traced."""
        self._close()
        if self.t0 is None:
            return None
        return read_trace(self.prof.events(), self.t1 - self.t0, self.traced)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read_trace(events, window_s: float, units: int) -> dict:
    device, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            if not getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                host.append((span, e.name))
        else:
            device.append((span, e.name))
    by_name: Dict[str, float] = defaultdict(float)
    for (a, b), name in device:
        by_name[name] += (b - a) / 1e6
    merged = _union([span for span, _ in device])
    busy_s = sum(b - a for a, b in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    idle = []
    for length, start in gaps:
        around = [(b - a, name) for (a, b), name in host if a <= start < b]
        idle.append([min(around)[1] if around else "no host event", length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "units": units,
            "by_name": dict(by_name),
            "device_ops": [[name[:160], s] for name, s in top], "idle_gaps": idle}


def kernel_s(trace: dict, *names: str) -> float:
    return sum(s for name, s in trace["by_name"].items() if any(n in name for n in names))
