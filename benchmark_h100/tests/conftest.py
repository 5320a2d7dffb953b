"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
folder in which every configuration and mix is cut to a size the CPU runs in
seconds, and the cells of ``BENCHMARK.json`` pointing at it."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# 16 channels at the top level: two a GroupNorm group, so that, as at the
# published widths, no bias before a GroupNorm has a gradient of nought
TINY_CONFIGS = {
    "ldm3d_flagship": {
        "latent": [4, 8, 8],
        "unet": dict(in_channels=4, base_channels=16, channel_mults=[1, 2], time_emb_dim=16,
                     num_heads=2),
        "vae": dict(in_channels=2, base_channels=8, num_down=2, latent_channels=4),
        "diffusion": dict(timesteps=20),
    },
    "slice2d_128": {
        "image_size": 16,
        "unet": dict(base_channels=16, channel_mults=[1, 2], time_emb_dim=16),
        "diffusion": dict(timesteps=20),
    },
}
TINY_MIXES = {
    "gen3d.ddim400.b8": dict(batch=2, ddim_steps=20, decode_chunk=1),
    "sweep155.ddim50": dict(num_slices=5, ddim_steps=6),
    "train_cached.b32": dict(batch=4, pool_rows=12, check={"micro_batch": 2}),
    "train2d.b64": dict(batch=4, pool_rows=20, check={"micro_batch": 4}),
}


def _merge(base: dict, update: dict) -> dict:
    out = dict(base)
    for k, v in update.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def make_tiny(tmp: Path):
    """(bench dict, benchmark folder copy) at tiny sizes under ``tmp``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bdir = tmp / "benchmark_h100"
    shutil.copytree(REPO / "benchmark_h100", bdir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, update in TINY_CONFIGS.items():
        path = bdir / "configs" / f"{name}.json"
        path.write_text(json.dumps(_merge(json.loads(path.read_text()), update)))
    for name, update in TINY_MIXES.items():
        path = bdir / "traffic" / f"{name}.json"
        mix = _merge(json.loads(path.read_text()), update)
        mix["profile"] = {"skip": 1, "active": 2}
        path.write_text(json.dumps(mix))
    for c in bench["configs"]:
        c["file"] = str(bdir / "configs" / f"{c['name']}.json")
    return bench, bdir


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)
