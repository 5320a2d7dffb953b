"""Exported sampling programs — the serving path, through ``torch.export``.

Counterpart of ``mrijax/aot.py``. A serving process should not need the run
directory or the model code's construction path: ``export-aot`` writes the
run's sampling pipeline once, as ``torch.export`` programs in one ``.pt2``
file, and every serving process loads it and samples.

Design rules:

* **Parameters stay arguments.** Each program takes the weights as a dict of
  tensors by ``state_dict`` name; the file holds the graph only (kilobytes to
  a few MB), and weights travel separately via checkpoints or the ``cli
  export`` npz. The model is held outside the exported module's registry and
  built on the ``meta`` device, and the example inputs are dropped before the
  save, so no weight reaches the file.
* **Per-step programs.** ``torch.export`` unrolls Python loops, so a T-step
  sampler exported whole would hold T copies of the denoiser (and full-T
  ancestral sampling could not be exported at all). The programs are the
  per-step denoiser (``denoise``) and, for the 3D family, the VAE decode
  (``decode``); the file also holds the sampler's settings (the run's config
  with its schedule, steps, sampler, latent scale, baked shapes, the
  parameters' names and shapes, and the exporting device type).
  ``load_exported`` returns a callable that runs the port's own samplers
  (``diffusion.fast_sample`` / ``p_sample_loop_auto``) over the loaded
  programs: the same function of ``(params, generator, z_pos)`` (2D) or
  ``(unet_params, vae_params, generator)`` (3D) as the eager pipeline.
* **Device-bound.** A program is traced for one device type (tensors made
  inside the model carry it); ``deserialize_exported`` raises ``ValueError``
  at once when asked to run it on another.
* **Kernels as custom ops.** The hand-written kernels of the forward pass
  are ``torch.library`` custom ops (``torch.ops.mrijax_torch.*``), which the
  programs call; importing this module registers them, so a fresh process
  can load a program.

CLI: ``python -m mrijax_torch.cli export-aot --run-dir RUN --out prog.pt2``;
a serving process then does::

    from mrijax_torch.aot import load_exported
    sample = load_exported("prog.pt2")        # device "cuda" by default
    volumes = sample(unet_params, vae_params, generator)
"""

import base64
import io
import json
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from mrijax_torch._device import require_device
from mrijax_torch.config import ExperimentConfig
from mrijax_torch.generate import _denoise
# registers the custom ops the programs call
from mrijax_torch.kernels import flash_attention as _flash_attention  # noqa: F401
from mrijax_torch.kernels import groupnorm as _groupnorm  # noqa: F401
from mrijax_torch.train.experiments import build_diffusion, build_unet2d, build_unet3d, build_vae3d

__all__ = [
    "export_callable",
    "save_exported",
    "deserialize_exported",
    "load_exported",
    "build_volume_sampler",
    "build_slice_sampler",
    "check_device",
    "read_settings",
    "file_bytes",
    "Exported",
    "ExportedSampler",
    "SamplerPrograms",
]

Device = Union[str, torch.device]
Params = Mapping[str, torch.Tensor]

SETTINGS_FILE = "mrijax_settings.json"
PROGRAM_FILE = "mrijax_{}.pt2.b64"   # programs beside the first, base64 in extra files


class _Call(torch.nn.Module):
    """``model.<method>(*args)``, so that ``functional_call`` can run a method
    other than ``forward``."""

    def __init__(self, model: torch.nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


class _Program(torch.nn.Module):
    """``forward(params, *args)`` = ``model.<method>(*args)`` run on
    ``params`` (``torch.func.functional_call``). The model is kept outside the
    module's registry: nothing of it is a parameter or buffer of the exported
    program."""

    def __init__(self, model: torch.nn.Module, method: str = "forward"):
        super().__init__()
        self.__dict__["_call"] = _Call(model, method)

    def forward(self, params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(
            self._call, {f"model.{k}": v for k, v in params.items()}, args)


@dataclass
class SamplerPrograms:
    """What ``build_*_sampler`` returns: the modules to export (name →
    ``_Program``), their example arguments on the exporting device, and the
    settings the sampler runs by."""

    programs: Dict[str, torch.nn.Module]
    example_args: Dict[str, tuple]
    settings: dict


def _param_specs(model: torch.nn.Module) -> Dict[str, list]:
    return {k: [list(p.shape), str(p.dtype).removeprefix("torch.")]
            for k, p in model.named_parameters()}


def _empty_params(model: torch.nn.Module, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Uninitialised tensors of the parameters' shapes and dtypes on ``dev``:
    export reads only their metadata."""
    return {k: torch.empty(p.shape, dtype=p.dtype, device=dev)
            for k, p in model.named_parameters()}


def export_callable(fn: torch.nn.Module, example_args: Sequence) -> torch.export.ExportedProgram:
    """``torch.export.export(fn, example_args)`` under ``torch.no_grad()``,
    at the example arguments' shapes, dtypes and device. The example inputs
    are dropped from the result (the file would otherwise carry them, with
    every weight)."""
    with torch.no_grad():
        ep = torch.export.export(fn, tuple(example_args))
    ep.example_inputs = None
    return ep


def save_exported(path, sampler: SamplerPrograms) -> Path:
    """Export every program of ``sampler`` and write one ``.pt2`` file: the
    first program as the file's own, the others and the settings as its
    extra files."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(sampler.programs)
    exported = {n: export_callable(sampler.programs[n], sampler.example_args[n]) for n in names}
    extra = {SETTINGS_FILE: json.dumps({**sampler.settings, "programs": names})}
    for n in names[1:]:
        buf = io.BytesIO()
        torch.export.save(exported[n], buf)
        extra[PROGRAM_FILE.format(n)] = base64.b64encode(buf.getvalue()).decode()
    torch.export.save(exported[names[0]], path, extra_files=extra)
    return path


def read_settings(path) -> dict:
    """The settings of an exported file, read without loading its programs."""
    with zipfile.ZipFile(path) as z:
        member = next((m for m in z.namelist() if m.rsplit("/", 1)[-1] == SETTINGS_FILE), None)
        if member is None:
            raise ValueError(f"{path}: no {SETTINGS_FILE} — not written by mrijax_torch.aot")
        return json.loads(z.read(member))


@dataclass
class Exported:
    """A loaded ``.pt2``: its programs by name and its settings."""

    programs: Dict[str, torch.export.ExportedProgram]
    settings: dict


def check_device(path, device: Device) -> dict:
    """The file's settings; ``ValueError`` when its programs were traced for
    another device type than ``device``'s."""
    settings = read_settings(path)
    want = torch.device(device).type
    if settings["device"] != want:
        raise ValueError(
            f"{path}: exported for device type {settings['device']!r} but asked to "
            f"run on {want!r} — re-export on this device (mrijax_torch.cli export-aot)")
    return settings


def deserialize_exported(path, device: Device = "cuda") -> Exported:
    """Load an exported file for ``device`` (device-checked).

    Raises ``ValueError`` at once when the programs were traced for another
    device type than ``device``'s — before loading them, not at the first
    call."""
    settings = check_device(path, device)
    require_device(device)
    names = settings["programs"]
    extra = {PROGRAM_FILE.format(n): "" for n in names[1:]}
    programs = {names[0]: torch.export.load(path, extra_files=extra)}
    for n in names[1:]:
        programs[n] = torch.export.load(io.BytesIO(base64.b64decode(extra[PROGRAM_FILE.format(n)])))
    return Exported(programs, settings)


class ExportedSampler:
    """The sampling pipeline over loaded programs (``load_exported``).

    2D: ``sampler(params, generator, z_pos)`` → (N, H, W, C) with ``z_pos``
    (N,); 3D: ``sampler(unet_params, vae_params, generator)`` → (N, D, H, W, C)
    volumes. ``params`` are dicts of tensors on the sampler's device by
    ``state_dict`` name; ``generator`` lives there too. The start noise and,
    for ancestral sampling, every step's noise come from ``generator``, as in
    ``generate.sample_2d`` / ``generate_3d_volumes``."""

    def __init__(self, exported: Exported, device: Device = "cuda"):
        self.device = require_device(device)
        self.settings = s = exported.settings
        self.family = s["family"]
        self.shape = tuple(s["shape"])
        self.batch = self.shape[0]
        cfg = ExperimentConfig.from_dict(s["config"])
        self.diffusion = build_diffusion(cfg.diffusion).to(self.device)
        self._modules = {n: ep.module() for n, ep in exported.programs.items()}

    def check_params(self, params: Params, which: str = "params") -> None:
        """Raise ``ValueError`` ("mismatch") unless ``params`` has the names,
        shapes and dtypes the programs were exported with."""
        want = self.settings[which]
        got = {k: [list(v.shape), str(v.dtype).removeprefix("torch.")] for k, v in params.items()}
        if got != want:
            missing = sorted(set(want) - set(got))[:3]
            extra = sorted(set(got) - set(want))[:3]
            wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])[:3]
            raise ValueError(
                f"{which} mismatch with the exported program: missing {missing}, "
                f"unexpected {extra}, other shape or dtype {wrong}")

    def _ordered(self, params: Params, which: str) -> Dict[str, torch.Tensor]:
        return {k: params[k] for k in self.settings[which]}

    def _sample(self, params, generator, *cond):
        s = self.settings
        denoise = self._modules["denoise"]
        params = self._ordered(params, "params")
        return _denoise(self.diffusion, lambda x, t: denoise(params, x, t, *cond), self.shape,
                        generator, None, s["ddim_steps"], s["sampler"])

    @torch.no_grad()
    def __call__(self, *args):
        if self.family == "ddpm_3d_ldm":
            unet_params, vae_params, generator = args
            z = self._sample(unet_params, generator)
            return self._modules["decode"](self._ordered(vae_params, "vae_params"),
                                           z / self.settings["latent_scale"])
        params, generator, z_pos = args
        return self._sample(params, generator, z_pos)


def load_exported(path, device: Device = "cuda") -> ExportedSampler:
    """Load an exported file and return its sampling callable."""
    return ExportedSampler(deserialize_exported(path, device), device)


# ------------------------------------------------ samplers of a run's config


def _settings(cfg: ExperimentConfig, dev: torch.device, shape, ddim_steps, sampler) -> dict:
    return {"family": cfg.family, "config": cfg.to_dict(), "shape": list(shape),
            "ddim_steps": ddim_steps, "sampler": sampler, "device": dev.type,
            "torch": torch.__version__}


def build_volume_sampler(
    cfg: ExperimentConfig,
    latent_scale: float,
    *,
    num_volumes: int = 8,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    device: Device = "cuda",
) -> SamplerPrograms:
    """3D-LDM family: the per-step ``UNet3D`` denoiser ``(unet_params, x, t)``
    and the VAE decode ``(vae_params, z)`` at ``num_volumes`` latents of the
    config's patch, with the settings of a ``ddim_steps``-step ``sampler``
    (full-T ancestral where ``ddim_steps`` is None) and ``latent_scale``:
    the pipeline of ``generate.generate_3d_volumes``."""
    dev = require_device(device)
    with torch.device("meta"):
        vae = build_vae3d(cfg.vae)
        unet = build_unet3d(cfg.unet)
    f = vae.spatial_downsample
    shape = (num_volumes, *(p // f for p in cfg.data.patch_size), cfg.vae.latent_channels)
    x = torch.zeros(shape, dtype=torch.float32, device=dev)
    t = torch.zeros((num_volumes,), dtype=torch.long, device=dev)
    settings = {**_settings(cfg, dev, shape, ddim_steps, sampler),
                "latent_scale": float(latent_scale),
                "params": _param_specs(unet), "vae_params": _param_specs(vae)}
    return SamplerPrograms(
        programs={"denoise": _Program(unet), "decode": _Program(vae, "decode_from_latent")},
        example_args={"denoise": (_empty_params(unet, dev), x, t),
                      "decode": (_empty_params(vae, dev), x)},
        settings=settings)


def build_slice_sampler(
    cfg: ExperimentConfig,
    *,
    num_samples: int = 16,
    ddim_steps: Optional[int] = None,
    sampler: str = "ddim",
    device: Device = "cuda",
) -> SamplerPrograms:
    """2D family: the per-step ``UNet2D`` denoiser ``(params, x, t, z_pos)``
    at ``num_samples`` slices, conditioned on the per-sample ``z_pos`` (N,),
    with the settings of a ``ddim_steps``-step ``sampler`` (full-T ancestral
    where ``ddim_steps`` is None): the pipeline of ``generate.sample_2d``.
    A 2.5D config is refused: its sampling needs real context slices, which
    are data, not parameters — serve it through ``generate.*``."""
    if cfg.unet.in_channels != cfg.unet.out_channels:
        raise ValueError(
            "build_slice_sampler covers the unconditional-context 2D "
            f"sampler; this config expects {cfg.unet.in_channels - cfg.unet.out_channels} "
            "context channels (2.5D) — serve it via generate.* instead"
        )
    dev = require_device(device)
    with torch.device("meta"):
        model = build_unet2d(cfg.unet)
    s = cfg.data.image_size
    shape = (num_samples, s, s, cfg.unet.out_channels)
    x = torch.zeros(shape, dtype=torch.float32, device=dev)
    t = torch.zeros((num_samples,), dtype=torch.long, device=dev)
    z = torch.zeros((num_samples,), dtype=torch.float32, device=dev)
    settings = {**_settings(cfg, dev, shape, ddim_steps, sampler),
                "params": _param_specs(model)}
    return SamplerPrograms(programs={"denoise": _Program(model)},
                           example_args={"denoise": (_empty_params(model, dev), x, t, z)},
                           settings=settings)


def file_bytes(path) -> Tuple[int, int]:
    """(bytes of the file, bytes of the largest tensor data it holds): a
    check that no weight went into it."""
    with zipfile.ZipFile(path) as z:
        data = [i.file_size for i in z.infolist() if "/data/" in i.filename
                and not i.filename.endswith(".json")]
    return Path(path).stat().st_size, max(data, default=0)
