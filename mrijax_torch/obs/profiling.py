"""Profiler integration: ``torch.profiler`` traces and the port's one span
registry.

Counterpart of ``mrijax/obs/profiling.py``. The reference's tracing story is
Perun sampling + nvidia-smi side-logs (SURVEY.md §5); here it is PyTorch's
profiler, which records host events and, through CUPTI, every kernel the card
ran, and the spans of this module, which name the program's own parts.

``span(name)`` marks a part of the program (``train.forward``, ``conv.down``,
``gn_silu.backward`` …). It records only while a ``torch.profiler`` session
records; otherwise it returns one shared no-op context after a single flag
read, so the hot paths carry their spans at no measurable cost. A recorded
span keeps its host interval on ``time.time_ns()``, the clock of the
profiler's own events (``prof.profiler.kineto_results.trace_start_ns()`` plus
an event's ``time_range``). ``span(name, stream=True)`` also times the
current stream, with a pair of CUDA timing events recorded through
``libcuda``'s ``cuEventRecord``: each record puts a few microseconds of its
own between the kernels around it (PERF.md §6, PR 21), so only the coarse
spans of a step time the stream, and the fine ones (one a convolution or a
norm) stay on the host. A span opens no ``record_function``, so it adds no
event to the profiler's host or device timeline; inside ``trace()``, the
operator's Chrome-trace exporter, it does, so the written trace names it.

``spans(prefix)`` reads the recorded spans of the newest profiling session
whose names start with ``prefix``: ``(name, t0_ns, t1_ns, host_ms,
stream_ms)`` each, where ``stream_ms`` is the time the current stream took
from the span's entry to its exit (equal to ``host_ms`` without CUDA; None
for a span that does not time the stream). A span entered while no profiler
records ends the session; the next one entered while one records starts a
new one. At most ``SpanRegistry.capacity`` spans a session are kept;
``REGISTRY.dropped`` counts the rest.

Usage, to profile a run and read its spans:
    with trace("profiles/run1"):
        for step in range(10):
            with step_annotation("train_step", step):
                state, loss = train_step(state, batch, generator)
    for s in spans("train."):
        print(s.name, s.host_ms, s.stream_ms)
"""

import contextlib
import ctypes
import functools
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    host_ms: float
    stream_ms: Optional[float]


class _CuEvents:
    """Timing events through ``libcuda.so.1`` (with ``ctypes``): a record
    is one ``cuEventRecord`` call on the current stream's raw handle, where
    ``torch.cuda.Event.record`` makes a capture check and a device guard
    besides, each a call that a recording profiler intercepts. Events are
    created once and reused: ``free`` holds them by card."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        ptr = ctypes.c_void_p
        for name, args in (("cuEventCreate", [ctypes.POINTER(ptr), ctypes.c_uint]),
                           ("cuEventRecord", [ptr, ptr]),
                           ("cuEventElapsedTime", [ctypes.POINTER(ctypes.c_float), ptr, ptr])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        self._lib = lib
        self.free: Dict[int, List[int]] = {}

    @staticmethod
    def _check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what} failed with CUresult {err}")

    def take(self, device: int) -> int:
        free = self.free.setdefault(device, [])
        if free:
            return free.pop()
        ev = ctypes.c_void_p()
        self._check(self._lib.cuEventCreate(ctypes.byref(ev), 0), "cuEventCreate")
        return ev.value

    def record(self, ev: int, device: int) -> None:
        self._check(self._lib.cuEventRecord(ev, torch._C._cuda_getCurrentRawStream(device)),
                    "cuEventRecord")

    def elapsed_ms(self, ev0: int, ev1: int) -> float:
        ms = ctypes.c_float()
        self._check(self._lib.cuEventElapsedTime(ctypes.byref(ms), ev0, ev1),
                    "cuEventElapsedTime")
        return ms.value


class _Recorded:
    """One span entered while a profiler records."""

    __slots__ = ("name", "stream", "t0", "t1", "device", "ev0", "ev1", "events", "rf")

    def __init__(self, name: str, stream: bool, device: Optional[int],
                 events: Optional[_CuEvents], chrome: bool):
        self.name, self.stream, self.device, self.events = name, stream, device, events
        self.t1 = None
        if events is not None:
            self.ev0, self.ev1 = events.take(device), events.take(device)
        self.rf = record_function(name) if chrome else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.events is not None:
            self.events.record(self.ev0, self.device)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.events is not None:
            self.events.record(self.ev1, self.device)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class SpanRegistry:
    """The spans of the newest profiling session, and the CUDA timing events
    that sessions reuse."""

    capacity = 1 << 16           # spans kept a session

    def __init__(self):
        self.records: List[_Recorded] = []
        self.live = False        # a session is open
        self.dropped = 0         # spans of this session past ``capacity``
        self.chrome = 0          # depth of ``trace()`` calls
        self._events: Optional[_CuEvents] = None

    def span(self, name: str, stream: bool = False):
        """A context that records ``name`` while a profiler records, else the
        shared no-op; with ``stream``, it times the current stream too."""
        if not _autograd_profiler._is_profiler_enabled:
            self.live = False
            return _OFF
        if not self.live:
            self._new_session()
        if len(self.records) >= self.capacity:
            self.dropped += 1
            return _OFF
        device = events = None
        if stream and torch.cuda.is_initialized():
            if self._events is None:
                self._events = _CuEvents()
            device, events = torch.cuda.current_device(), self._events
        rec = _Recorded(name, stream, device, events, self.chrome > 0)
        self.records.append(rec)
        return rec

    def _new_session(self) -> None:
        for rec in self.records:
            if rec.events is not None:
                rec.events.free[rec.device] += [rec.ev0, rec.ev1]
        self.records, self.dropped, self.live = [], 0, True

    def spans(self, prefix: str = "") -> List[Span]:
        """The newest session's finished spans whose names start with
        ``prefix``, in the order they were entered. Waits once for each card
        whose spans time the stream."""
        done = [r for r in self.records if r.t1 is not None and r.name.startswith(prefix)]
        for device in sorted({r.device for r in done if r.events is not None}):
            torch.cuda.synchronize(device)
        out = []
        for r in done:
            host = (r.t1 - r.t0) / 1e6
            stream = None if not r.stream else (
                host if r.events is None else r.events.elapsed_ms(r.ev0, r.ev1))
            out.append(Span(r.name, r.t0, r.t1, host, stream))
        return out


REGISTRY = SpanRegistry()
span = REGISTRY.span
spans = REGISTRY.spans


@contextlib.contextmanager
def trace(log_dir, *, create_perfetto_link: bool = False):
    """Capture host events, the spans and, where CUDA is present, the card's
    kernels for the enclosed region; on exit the Chrome trace is written
    under ``log_dir`` (``trace_<time>.json``, viewable in Perfetto or
    ``chrome://tracing``) and ``spans()`` reads the region's spans. Yields
    ``log_dir``. ``create_perfetto_link`` is accepted for the JAX signature
    and does nothing: open the written file in Perfetto."""
    del create_perfetto_link
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    REGISTRY.live = False
    REGISTRY.chrome += 1
    try:
        with profile(activities=activities) as prof:
            yield str(log_dir)
    finally:
        REGISTRY.chrome -= 1
    prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns()}.json"))


def step_annotation(name: str, step: int = 0):
    """The span ``f"{name}#{step}"``."""
    return span(f"{name}#{step}")


def annotate(name: str):
    """Function decorator: each call runs inside the span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
