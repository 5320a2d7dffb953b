"""The port's ``CheckpointManager`` and npz export: retention (the last N
steps plus ``best/`` with ``best.json``), a save that did not finish is never
the latest, restore in place and to the host, and the npz layout shared with
``mrijax.io`` in both directions — down to a JAX-exported ``UNet3D`` that
gives the JAX model's output in the port (float32 on the CPU, 3e-4 absolute,
the bar of ``tests/test_torch_port_models.py``)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax.io import load_params_npz as jload_params_npz
from mrijax.io import save_params_npz as jsave_params_npz
from mrijax.models import UNet3D as JUNet3D
from mrijax_torch.io import (
    CheckpointManager,
    load_params_npz,
    load_state,
    save_params_npz,
    unet3d_state_dict_from_flax,
)
from mrijax_torch.models import UNet3D
from mrijax_torch.train import create_train_state, ema_update

UNET_KW = dict(in_channels=4, base_channels=8, channel_mults=(1, 2), time_emb_dim=16,
               num_heads=2)


def small_state(seed=0, ema=True):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    return create_train_state(model, 1e-2, ema=ema, device="cpu")


def take_steps(state, n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n):
        state.optimizer.zero_grad(set_to_none=True)
        x = torch.randn(3, 4, generator=gen)
        state.model(x).square().mean().backward()
        state.optimizer.step()
        state.step += 1
        ema_update(state, 0.9)
    return state


def flat(state):
    opt = state.optimizer.state_dict()
    moments = [t for s in opt["state"].values() for t in s.values()]
    return ([p.detach() for p in state.model.parameters()] + moments
            + list(state.ema_params.values()))


def assert_same_state(a, b):
    assert a.step == b.step
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    for x, y in zip(flat(a), flat(b), strict=True):
        assert torch.equal(x, y)


def test_keeps_the_last_n_and_the_best(tmp_path):
    state = take_steps(small_state(), 2)
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    vals = {1: 0.5, 2: 0.25, 3: 0.75, 4: 0.375, 5: 0.3}
    for step, val in vals.items():
        mgr.save(step, state, {"epoch": step}, metrics={"val_loss": val})
    # a save without trusted validation never enters best/
    mgr.save(6, state, {"epoch": 6}, metrics={})
    assert mgr.latest_step == 6
    assert sorted(p.name for p in (tmp_path / "ck").glob("*.pt")) == ["5.pt", "6.pt"]
    assert mgr.best_step == 2
    assert json.loads((tmp_path / "ck" / "best.json").read_text()) == {"step": 2, "value": 0.25}
    assert [p.name for p in (tmp_path / "ck" / "best").iterdir()] == ["2.pt"]
    _, extra = mgr.restore_host(best=True)
    assert extra == {"epoch": 2}
    _, extra = mgr.restore_host(step=5)
    assert extra == {"epoch": 5}


def test_unfinished_save_and_truncated_record_are_ignored(tmp_path):
    state = take_steps(small_state(), 1)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, state, {"epoch": 0}, metrics={"val_loss": 1.0})
    # what a save killed midway leaves: a temporary file of a later step
    (tmp_path / "ck" / "7.pt.tmp").write_bytes(b"\x80\x02truncated")
    assert mgr.latest_step == 3
    assert CheckpointManager(tmp_path / "ck").latest_step == 3
    # a truncated best.json reads as "no record": the next save is the best
    (tmp_path / "ck" / "best.json").write_text('{"step": 3, "val')
    assert mgr.best_step is None
    mgr.save(4, state, {"epoch": 1}, metrics={"val_loss": 2.0})
    assert mgr.best_step == 4
    restored, extra = mgr.restore(small_state(seed=5))
    assert extra == {"epoch": 1}


def test_restore_in_place_and_to_the_host(tmp_path):
    state = take_steps(small_state(), 3)
    state.optimizer.param_groups[0]["lr"] = 2.5e-3   # a plateau-reduced rate
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, state, {"epoch": 0, "val": np.float32(0.5), "scale": torch.tensor(2.0)})

    fresh = small_state(seed=7)
    got, extra = mgr.restore(fresh)
    assert got is fresh
    assert extra == {"epoch": 0, "val": 0.5, "scale": 2.0}
    assert_same_state(fresh, state)
    # both go on identically
    take_steps(fresh, 2, seed=3)
    take_steps(state, 2, seed=3)
    assert_same_state(fresh, state)

    payload, extra = mgr.restore_host()
    assert extra["epoch"] == 0 and payload["step"] == 3
    assert all(t.device.type == "cpu" for t in payload["model"].values())
    other = load_state(small_state(seed=9), payload)
    assert other.step == 3
    with pytest.raises(ValueError, match="EMA"):
        load_state(small_state(seed=9, ema=False), payload)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(small_state())


def test_npz_layout_round_trips_with_mrijax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"Dense_0": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                                   "bias": np.zeros(2, np.float32)},
                       "Conv_0": {"kernel": rng.normal(size=(3, 3, 3, 2, 4)).astype(np.float32)}}}
    meta = {"family": "ddpm_3d_ldm", "base": 8}
    jsave_params_npz(tmp_path / "j.npz", jax.tree_util.tree_map(jnp.asarray, tree), meta)
    save_params_npz(tmp_path / "t.npz", tree, meta)
    for path in ("j.npz", "t.npz"):
        for load in (load_params_npz, jload_params_npz):
            got, got_meta = load(tmp_path / path)
            assert got_meta == meta
            assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
                np.testing.assert_array_equal(a, b)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert str(j["__keys__"]) == str(t["__keys__"])
    # a flat state_dict of tensors exports too
    save_params_npz(tmp_path / "sd.npz", {"a.weight": torch.ones(2, 3)})
    got, _ = jload_params_npz(tmp_path / "sd.npz")
    np.testing.assert_array_equal(got["a.weight"], np.ones((2, 3), np.float32))


def test_jax_exported_unet3d_npz_runs_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32)
    t = np.asarray([4, 12], np.int32)
    jm = JUNet3D(**UNET_KW, use_attention=True, use_flash_attention=False)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t)))
    params = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray((0.1 * rng.normal(size=leaf.shape)).astype(np.float32)), shapes)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t)))
    jsave_params_npz(tmp_path / "unet.npz", params, {"base_channels": 8})

    tree, meta = load_params_npz(tmp_path / "unet.npz")
    assert meta == {"base_channels": 8}
    model = UNet3D(**UNET_KW, use_attention=True).eval()
    model.load_state_dict(unet3d_state_dict_from_flax(tree, UNET_KW["channel_mults"]), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4)
