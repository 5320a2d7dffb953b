"""Everything a run makes from its ``--seed``: weights, data pools and the
random streams of the traffic.

A stream is a ``torch.Generator`` on the run's device seeded with a number
mixed from (seed, stream id) by ``numpy.random.SeedSequence``, so any seed up
to 2**64 − 1 works and streams do not overlap. The same seed on the same
device gives the same tensors.

Weights are made on the device in one draw of normal numbers for all the
parameters of a network, then scaled in place a parameter at a time, in
float32: a convolution or linear weight N(0, 1/fan_in) (a transposed
convolution's fan-in is the input channels times the taps that reach one
output, k/stride a side), a GroupNorm scale 1 + N(0, 0.1²) and shift
N(0, 0.1²), any other bias N(0, 0.02²). The program's parameters are copied
from these (rounded where it holds them in bfloat16); the reference takes
the float32 values themselves, made again from the seed.
"""

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

WEIGHTS_UNET, WEIGHTS_VAE, POOL, TRAFFIC, CHECK = 1, 2, 3, 4, 5

Spec = List[Tuple[str, Tuple[int, ...], str]]   # (name, shape, kind)


def stream_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence((int(seed), stream)).generate_state(1, np.uint64)[0])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def check_rng(seed: int) -> np.random.Generator:
    """The host stream that draws which answers are checked."""
    return np.random.default_rng(stream_seed(seed, CHECK))


def param_spec(model: nn.Module) -> Spec:
    """(name, shape, kind) of every parameter, kind one of ``conv``,
    ``conv_t``, ``linear``, ``norm_weight``, ``norm_bias``, ``bias``."""
    spec = []
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            is_norm = "norm" in mod_name.rsplit(".", 1)[-1]   # norm, norm1, out_norm, …
            if p_name == "bias":
                kind = "norm_bias" if is_norm else "bias"
            elif isinstance(mod, nn.modules.conv._ConvTransposeNd):
                kind = "conv_t"
            elif isinstance(mod, nn.modules.conv._ConvNd):
                kind = "conv"
            elif isinstance(mod, nn.Linear):
                kind = "linear"
            else:
                kind = "norm_weight"
            spec.append((name, tuple(p.shape), kind))
    return spec


def _std_offset(shape: Tuple[int, ...], kind: str) -> Tuple[float, float]:
    if kind == "conv":
        return 1.0 / math.sqrt(shape[1] * math.prod(shape[2:])), 0.0
    if kind == "conv_t":   # (in, out, k, ...): stride 2 → (k/2)^d taps reach one output
        return 1.0 / math.sqrt(shape[0] * math.prod(k // 2 for k in shape[2:])), 0.0
    if kind == "linear":
        return 1.0 / math.sqrt(shape[1]), 0.0
    if kind == "norm_weight":
        return 0.1, 1.0
    if kind == "norm_bias":
        return 0.1, 0.0
    return 0.02, 0.0


@torch.no_grad()
def make_weights(spec: Spec, seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights of ``spec`` from (seed, stream), on ``device``."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    if torch.device(device).type != "meta":
        flat.normal_(generator=generator(seed, stream, device))
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        std, offset = _std_offset(shape, kind)
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(offset)
        at += n
    return out


@torch.no_grad()
def load_weights(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters (cast to their dtype)."""
    for name, p in model.named_parameters():
        p.copy_(weights[name])


def fill_pool(pool: torch.Tensor, seed: int, dist: str) -> torch.Tensor:
    """Fill ``pool`` (rows first) with normal numbers or uniform ones in
    [−1, 1], 64 rows a call."""
    g = generator(seed, POOL, pool.device)
    for i in range(0, pool.shape[0], 64):
        block = pool[i:i + 64]
        if dist == "normal":
            block.normal_(generator=g)
        else:
            block.uniform_(-1.0, 1.0, generator=g)
    return pool
