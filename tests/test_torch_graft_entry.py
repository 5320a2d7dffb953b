"""``mrijax_torch.graft_entry`` against ``__graft_entry__``.

``entry``: the port's flagship UNet3D has the JAX one's parameters (count and
tree, through ``io.flax_convert``), and its ``fn`` on the JAX ``entry()``'s
weights, carried across, matches the JAX ``fn`` in bf16 at a small latent.
The JAX side (34 s to build on the CPU, 11 s a forward) is computed once, in
a module-scoped fixture.

``dryrun_multichip``: the JAX dry run's checks, with its bars, on 2 gloo
processes (a (2, 1) data mesh) and on 4 (the (2, 2) data × sequence mesh);
8 is marked slow, as its JAX sibling in ``tests/test_graft_entry.py`` is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from mrijax_torch import graft_entry
from mrijax_torch.io import flax_convert

JAX_PARAMS = 136_482_704
SMALL_LATENT = (1, 8, 8, 8, 16)
T = 7
BF16_ULP = 2 ** -7   # of a value in [1, 2)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX ``entry()``'s weights as numpy and its ``fn`` at a seeded
    small latent."""
    import __graft_entry__

    fn, (params, _, _) = __graft_entry__.entry()
    x = np.random.default_rng(0).normal(size=SMALL_LATENT).astype(np.float32)
    out = fn(params, jnp.asarray(x, jnp.bfloat16), jnp.asarray([T], jnp.int32))
    return jax.tree.map(np.asarray, params), x, np.asarray(out)


@pytest.fixture(scope="module")
def port_entry():
    return graft_entry.entry(device="cpu")


def test_entry_has_the_jax_parameter_count_and_tree(jax_side, port_entry):
    jax_params, _, _ = jax_side
    _, (params, latent, t) = port_entry
    assert sum(a.size for a in jax.tree.leaves(jax_params)) == JAX_PARAMS
    assert sum(p.numel() for p in params.values()) == JAX_PARAMS
    carried = flax_convert.unet3d_state_dict_from_flax(jax_params, (1, 2, 4), True)
    assert {k: tuple(v.shape) for k, v in carried.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    assert all(p.dtype == torch.float32 for p in params.values())
    assert latent.dtype == torch.bfloat16 and tuple(latent.shape) == (1, 32, 40, 40, 16)
    assert t.dtype == torch.int64 and tuple(t.shape) == (1,)


def test_entry_fn_on_carried_weights_matches_jax_in_bf16(jax_side, port_entry):
    """Both compute in bf16 from float32 weights, rounding after every layer
    in their own order: the largest difference is held to 4 bf16 ulps of the
    output's largest value (measured: 2), the mean to 1 ulp (measured: 0.3)."""
    jax_params, x, want = jax_side
    fn, _ = port_entry
    carried = flax_convert.unet3d_state_dict_from_flax(jax_params, (1, 2, 4), True)
    got = fn(carried, torch.from_numpy(x).bfloat16(), torch.tensor([T]))
    assert got.dtype == torch.float32 and tuple(got.shape) == SMALL_LATENT
    got = got.numpy()
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert float(err.max()) <= 4 * BF16_ULP * scale, (float(err.max()), scale)
    assert float(err.mean()) <= BF16_ULP * scale, (float(err.mean()), scale)


def test_entry_weights_come_from_the_seed(port_entry):
    """The same seed (0, the default) gives the same weights, another seed
    others; the caller's RNG is left as it was."""
    _, (default, _, _) = port_entry
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    _, (same, _, _) = graft_entry.entry(device="cpu", seed=0)
    assert torch.equal(torch.rand(3), before)
    _, (other, _, _) = graft_entry.entry(device="cpu", seed=4)
    name = "mid_attn.qkv.weight"
    assert torch.equal(same[name], default[name]) and not torch.equal(other[name], default[name])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        graft_entry.dryrun_multichip(1)


@pytest.mark.parametrize("n,mesh", [(2, [2, 1]), (4, [2, 2])])
def test_dryrun_multichip_cpu(n, mesh):
    out = graft_entry.dryrun_multichip(n, "cpu")
    assert out["mesh"] == mesh
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert max(out["rel_l2"]) < 5e-5 and out["cached_rel_l2"] < 1e-5
    assert out["fsdp_sharded_dim"] is not None and out["fsdp_rel_l2"] < 5e-4
    assert out["sharded_sample_max_abs_err"] < 1e-5


@pytest.mark.slow
def test_dryrun_multichip_8_cpu():
    assert graft_entry.dryrun_multichip(8, "cpu")["mesh"] == [4, 2]
