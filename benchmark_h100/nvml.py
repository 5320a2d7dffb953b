"""The card's energy counter and power limit through NVML (the driver's
``libnvidia-ml.so.1``, loaded with ``ctypes``).

Copied from ``mrijax_torch/obs/energy.py::NvmlPowerSensor`` so that the
benchmark reads the device itself: ``nvmlDeviceGetTotalEnergyConsumption``
(mJ since the driver was loaded) and ``nvmlDeviceGetEnforcedPowerLimit``
(mW). The card is found by its PCI bus id, so NVML's order and CUDA's need
not agree.
"""

import ctypes

import torch


class Nvml:
    def __init__(self, cuda_index: int = 0):
        self._lib = lib = ctypes.CDLL("libnvidia-ml.so.1")
        handle, out = ctypes.c_void_p, ctypes.POINTER
        for name, args, res in (
                ("nvmlErrorString", [ctypes.c_int], ctypes.c_char_p),
                ("nvmlInit_v2", [], ctypes.c_int),
                ("nvmlDeviceGetHandleByPciBusId_v2", [ctypes.c_char_p, out(handle)], ctypes.c_int),
                ("nvmlDeviceGetTotalEnergyConsumption", [handle, out(ctypes.c_ulonglong)],
                 ctypes.c_int),
                ("nvmlDeviceGetEnforcedPowerLimit", [handle, out(ctypes.c_uint)], ctypes.c_int)):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        props = torch.cuda.get_device_properties(cuda_index)
        bus = f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByPciBusId_v2(bus.encode(), ctypes.byref(self._handle)),
                    f"nvmlDeviceGetHandleByPciBusId_v2({bus})")

    def _check(self, ret: int, what: str) -> None:
        if ret != 0:
            raise RuntimeError(f"{what} failed: NVML error {ret} "
                               f"({self._lib.nvmlErrorString(ret).decode()})")

    def energy_j(self) -> float:
        out = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(self._handle, ctypes.byref(out)),
                    "nvmlDeviceGetTotalEnergyConsumption")
        return out.value / 1000.0

    def power_limit_w(self) -> float:
        out = ctypes.c_uint()
        self._check(self._lib.nvmlDeviceGetEnforcedPowerLimit(self._handle, ctypes.byref(out)),
                    "nvmlDeviceGetEnforcedPowerLimit")
        return out.value / 1000.0
