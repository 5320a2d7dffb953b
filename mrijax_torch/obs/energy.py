"""Pluggable energy/power accounting (the Perun-bridge equivalent).

Counterpart of ``mrijax/obs/energy.py``, with its interface, its summary keys
and its busy/idle rule. The reference wraps its train function in the Perun
profiler and walks the resulting data tree into MLflow metrics — energy
(J/kWh), runtime, CO₂, cost, average power, GPU utilization and idle-fraction
(`helpers/perun_utils.py:17-148`, `.perun.ini`). Sensors:

* ``NullEnergySensor``    — runtime only (default; honest zeros for power).
* ``ConstantPowerSensor`` — energy = a power the caller gives × runtime (a
  documented estimate for cost/CO₂ budgeting); without a value it takes the
  card's enforced power limit from NVML.
* ``NvmlPowerSensor``     — the card's own telemetry through the NVIDIA
  driver's ``libnvidia-ml.so.1`` (``ctypes``, no package): the power draw
  (``nvmlDeviceGetPowerUsage``, which the driver averages over about a second
  on Hopper) and the energy counter (``nvmlDeviceGetTotalEnergyConsumption``).
  It is what Perun measured for the reference. Made only when asked for.

``energy_joules`` is the difference of the sensor's energy counter over the
monitor's window where the sensor has one (``read_energy_j``, exact), else
the average of the power samples × runtime, as in the JAX package.
``avg_power_w`` is always the average of the power samples.

The idle-fraction is NOT derived from the power samples: it comes from the
trainer's own step timing — every ``StepTimer.stop`` (and ``finalize``) adds
its measured step duration to a process-wide busy counter
(``mrijax_torch.obs.timing.busy_seconds``), and the monitor reports
``1 − busy/runtime`` over its window. Untimed device work (validation,
sampling) counts as idle, so the figure is a lower bound on utilization.

Samples are polled on a background thread at ``interval_s`` (Perun's 1 s
default), and the summary mirrors the reference's metric names.
"""

import ctypes
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from mrijax_torch.obs.timing import busy_seconds


class NullEnergySensor:
    """No power telemetry available — reports zeros."""

    def read_power_w(self) -> float:
        return 0.0


_NVML = None
_NVML_LOCK = threading.Lock()


def _nvml() -> ctypes.CDLL:
    """The driver's NVML library, initialised once; raises where there is
    none (no NVIDIA driver on this machine)."""
    global _NVML
    with _NVML_LOCK:
        if _NVML is None:
            try:
                lib = ctypes.CDLL("libnvidia-ml.so.1")
            except OSError as e:
                raise RuntimeError(
                    "NVML (libnvidia-ml.so.1, part of the NVIDIA driver) cannot be "
                    f"loaded here: {e}; power telemetry needs an NVIDIA GPU"
                ) from e
            lib.nvmlErrorString.restype = ctypes.c_char_p
            _check(lib, lib.nvmlInit_v2(), "nvmlInit_v2")
            _NVML = lib
        return _NVML


def _check(lib: ctypes.CDLL, ret: int, what: str) -> None:
    if ret != 0:
        raise RuntimeError(f"{what} failed: NVML error {ret} "
                           f"({lib.nvmlErrorString(ret).decode()})")


class NvmlPowerSensor:
    """Power and energy of one NVIDIA card, read through NVML with ``ctypes``.

    ``device_index`` is NVML's index (``nvidia-smi``'s order; the CUDA index
    where ``CUDA_VISIBLE_DEVICES`` is not set). Raises ``RuntimeError`` when
    NVML or the card is not there."""

    def __init__(self, device_index: int = 0):
        self._lib = _nvml()
        self._handle = ctypes.c_void_p()
        _check(self._lib, self._lib.nvmlDeviceGetHandleByIndex_v2(
            ctypes.c_uint(device_index), ctypes.byref(self._handle)),
            f"nvmlDeviceGetHandleByIndex_v2({device_index})")
        self.device_index = device_index

    def _uint(self, fn: str) -> int:
        out = ctypes.c_uint()
        _check(self._lib, getattr(self._lib, fn)(self._handle, ctypes.byref(out)), fn)
        return out.value

    def read_power_w(self) -> float:
        """The card's power draw, W (NVML reports mW)."""
        return self._uint("nvmlDeviceGetPowerUsage") / 1000.0

    def read_energy_j(self) -> float:
        """Energy the card used since the driver was loaded, J (NVML: mJ)."""
        out = ctypes.c_ulonglong()
        _check(self._lib, self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(out)), "nvmlDeviceGetTotalEnergyConsumption")
        return out.value / 1000.0

    def power_limit_w(self) -> float:
        """The enforced power limit, W (what ``nvidia-smi`` prints as
        ``power.limit``)."""
        return self._uint("nvmlDeviceGetEnforcedPowerLimit") / 1000.0


@dataclass
class ConstantPowerSensor:
    """Assume a constant average power draw: ``power_w``, or where it is not
    given the enforced power limit of NVML card ``device_index`` (an upper
    bound of the draw)."""

    power_w: Optional[float] = None
    device_index: int = 0

    def __post_init__(self):
        if self.power_w is None:
            self.power_w = NvmlPowerSensor(self.device_index).power_limit_w()

    def read_power_w(self) -> float:
        return self.power_w


class EnergyMonitor:
    """Samples a sensor on a background thread and produces a Perun-style
    summary (energy J/kWh, CO₂ kg, cost €, average power)."""

    def __init__(
        self,
        sensor=None,
        interval_s: float = 1.0,
        emissions_g_per_kwh: float = 230.0,  # .perun.ini:  emissions factor
        price_per_kwh: float = 0.2678,       # .perun.ini:  energy price
    ):
        self.sensor = sensor or NullEnergySensor()
        self.interval_s = interval_s
        self.emissions_g_per_kwh = emissions_g_per_kwh
        self.price_per_kwh = price_per_kwh
        self._samples = []
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._t_start = None
        self._t_stop = None
        self._busy0 = 0.0
        self._energy = [None, None]   # the sensor's energy counter at start and stop

    def _read_energy(self) -> Optional[float]:
        read = getattr(self.sensor, "read_energy_j", None)
        return None if read is None else read()

    def _loop(self):
        while self._running:
            self._samples.append(self.sensor.read_power_w())
            time.sleep(self.interval_s)

    def start(self):
        self._t_start = time.time()
        self._busy0 = busy_seconds()
        self._energy[0] = self._read_energy()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> Dict[str, float]:
        self._running = False
        self._t_stop = time.time()
        self._energy[1] = self._read_energy()
        if self._thread:
            self._thread.join(timeout=2 * self.interval_s)
        return self.summary()

    def summary(self) -> Dict[str, float]:
        runtime_s = (self._t_stop or time.time()) - (self._t_start or time.time())
        avg_power_w = (
            sum(self._samples) / len(self._samples) if self._samples else 0.0
        )
        start, stop = self._energy
        if start is not None and stop is not None:
            energy_j = stop - start
        else:
            energy_j = avg_power_w * runtime_s
        energy_kwh = energy_j / 3.6e6
        # busy/idle from measured step time in this window, not from the
        # power samples — see module docstring
        busy_s = max(busy_seconds() - self._busy0, 0.0)
        idle = max(0.0, 1.0 - busy_s / runtime_s) if runtime_s > 0 else 1.0
        return {
            "runtime_s": runtime_s,
            "avg_power_w": avg_power_w,
            "energy_joules": energy_j,
            "energy_kwh": energy_kwh,
            "co2_kg": energy_kwh * self.emissions_g_per_kwh / 1000.0,
            "cost_eur": energy_kwh * self.price_per_kwh,
            "device_busy_s": busy_s,
            "device_idle_fraction": idle,
        }


def run_with_energy(fn: Callable, logger=None, sensor=None, prefix: str = "energy"):
    """Run ``fn()`` under an EnergyMonitor and log the summary — the
    equivalent of ``run_with_perun(fn, data_out=...)``
    (`helpers/perun_utils.py:132-148`)."""
    mon = EnergyMonitor(sensor=sensor)
    mon.start()
    try:
        result = fn()
    finally:
        summary = mon.stop()
        if logger is not None:
            for k, v in summary.items():
                logger.log_metric(f"{prefix}_{k}", v)
        else:
            print(f"[EnergyMonitor] {summary}")
    return result
