"""Sequence-parallel attention (``mrijax_torch.parallel.sequence``) and the
flash kernels' plain versions at Nq ≠ Nk, against the JAX package.

The JAX Pallas kernels take the query length for the key length too
(``mrijax/kernels/flash_attention_pallas.py``: grid, key-block count, mask
and pad all follow q), so their sequence-parallel call of N/d query rows
against N keys would read only N/d keys or fail; on the CPU the JAX package
takes its exact chunked XLA attention, which is right, and that is what the
port is held against here. The port's kernels take Nq ≠ Nk (their CUDA
launches are held to these plain versions on the card by ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_threads import thread_budget  # noqa: F401  (autouse)
from _torch_mp_worker import launch
from mrijax.kernels.flash_attention import _chunked_attention_xla
from mrijax.parallel import make_mesh as jmake_mesh
from mrijax.parallel.sequence import sequence_parallel_attention as jsp_attention
from mrijax_torch.diffusion import GaussianDiffusion, cosine_beta_schedule, make_schedule
from mrijax_torch.kernels import flash_attention as fa
from mrijax_torch.models import UNet3D
from mrijax_torch.train import make_cached_latent_train_step
from mrijax_torch.train.state import TrainState

ATOL = 1e-5


def qkv(rng, b, nq, nk, h, d):
    q = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, nk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,nq,nk,h,d", [(2, 16, 32, 2, 32), (1, 8, 40, 3, 64),
                                         (2, 40, 24, 2, 32)])
def test_plain_versions_at_nq_ne_nk_match_jax(b, nq, nk, h, d):
    """The forward and its VJP (dq, dk, dv) of the plain versions — what a CPU
    tensor gets from ``flash_attention`` — at Nq ≠ Nk against JAX's
    ``_chunked_attention_xla`` and ``jax.vjp`` of it, float32, 1e-5."""
    rng = np.random.default_rng(b * nq + nk)
    q, k, v = qkv(rng, b, nq, nk, h, d)
    dout = rng.normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: _chunked_attention_xla(*a), *map(jnp.asarray, (q, k, v)))
    wants = [np.asarray(x) for x in vjp(jnp.asarray(dout))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for got, w in zip(grads, wants):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=0)


def test_query_chunks_assemble_full_attention():
    """d chunks of the query rows against all keys — the work of d ranks —
    stacked (out, lse, dq) and summed (dk, dv) equal the full attention's."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(x) for x in qkv(rng, 2, 48, 48, 2, 32))
    dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    out, lse = fa.flash_attention_forward(q, k, v)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, dout)
    for d in (2, 3, 4):
        c = 48 // d
        parts = []
        for i in range(d):
            sl = slice(i * c, (i + 1) * c)
            o, l = fa.flash_attention_forward(q[:, sl], k, v)
            parts.append((o, l.view(2, 2, c)) + fa.flash_attention_backward(
                q[:, sl], k, v, o, l, dout[:, sl]))
        torch.testing.assert_close(torch.cat([p[0] for p in parts], 1), out, atol=ATOL, rtol=0)
        torch.testing.assert_close(torch.cat([p[1] for p in parts], 2).reshape(lse.shape), lse,
                                   atol=ATOL, rtol=0)
        torch.testing.assert_close(torch.cat([p[2] for p in parts], 1), dq, atol=ATOL, rtol=0)
        torch.testing.assert_close(sum(p[3] for p in parts), dk, atol=ATOL, rtol=0)
        torch.testing.assert_close(sum(p[4] for p in parts), dv, atol=ATOL, rtol=0)


def test_wrappers_take_nq_ne_nk_and_refuse_other_mismatches():
    """Only the token counts of q and of k, v may differ: k and v must agree,
    and B, H and Dh must be q's."""
    q = torch.zeros(1, 8, 2, 32)
    kv = torch.zeros(1, 24, 2, 32)
    out, lse = fa.flash_attention_forward(q, kv, kv)
    assert out.shape == q.shape and lse.shape == (2, 8)
    dout = torch.zeros_like(q)
    delta = fa.flash_attention_delta(out, dout)
    dk, dv = fa.flash_attn_bwd_dkv(q, kv, kv, dout, lse, delta)
    assert dk.shape == dv.shape == kv.shape
    assert fa.flash_attn_bwd_dq(q, kv, kv, dout, lse, delta).shape == q.shape
    for bad_k, bad_v in ((torch.zeros(2, 24, 2, 32),) * 2, (torch.zeros(1, 24, 3, 32),) * 2,
                         (torch.zeros(1, 24, 2, 64),) * 2, (kv, torch.zeros(1, 23, 2, 32))):
        with pytest.raises(ValueError, match="share one"):
            fa.flash_attention_forward(q, bad_k, bad_v)
        with pytest.raises(ValueError, match="share one"):
            fa.flash_attn_bwd_dkv(q, bad_k, bad_v, dout, lse, delta)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attn_bwd_dq(q, kv, kv, dout, torch.zeros(2, 24), delta)


def test_sequence_parallel_attention_matches_jax(tmp_path):
    """Two processes on a ("data", "model") 1 × 2 mesh against the JAX
    function on the same mesh of 2 CPU devices: the output and dq, dk, dv
    through its VJP, float32, 1e-5; every rank holds the whole result."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 32, 2, 32)).astype(np.float32) for _ in range(3))
    dout = rng.normal(size=q.shape).astype(np.float32)
    mesh = jmake_mesh(("data", "model"), shape=(1, 2), devices=jax.devices()[:2])
    want, vjp = jax.vjp(lambda *a: jsp_attention(*a, mesh=mesh, axis="model", impl="xla"),
                        *map(jnp.asarray, (q, k, v)))
    wants = [np.asarray(x) for x in (want, *vjp(jnp.asarray(dout)))]
    outs, _ = launch("sequence", 2, tmp_path, {
        "mesh_shape": (1, 2), **{n: torch.from_numpy(x) for n, x in
                                 (("q", q), ("k", k), ("v", v), ("dout", dout))}})
    for out in outs:
        for name, w in zip(("out", "dq", "dk", "dv"), wants):
            np.testing.assert_allclose(out[name].numpy(), w, atol=ATOL, rtol=0, err_msg=name)


UNET_KW = dict(in_channels=4, base_channels=8, channel_mults=(1, 2), time_emb_dim=16,
               num_heads=2, use_attention=True)
LATENT = (4, 8, 8, 4)   # (D, H, W, C): 2·4·4 = 32 bottleneck tokens
STEPS, BATCH, LR = 2, 4, 0.05


def _sp_train_against_one_process(tmp_path, world, mesh_shape):
    """``world`` processes on a ("data", "model") mesh of ``mesh_shape``
    (None: ``make_mesh``'s default, every rank on ``data``) train a UNet3D
    with sequence-parallel attention for 2 SGD steps; one process runs the
    same steps at the global batch. The losses and parameters agree at 1e-5.
    Returns the ranks' results."""
    torch.manual_seed(0)
    unet = UNet3D(**UNET_KW)
    state_dict = {k: v.clone() for k, v in unet.state_dict().items()}
    betas = cosine_beta_schedule(10)
    rng = np.random.default_rng(4)
    batches = [{"latent": torch.from_numpy(rng.normal(size=(BATCH, *LATENT)).astype(np.float32))}
               for _ in range(STEPS)]
    ts = [torch.from_numpy(rng.integers(1, 10, BATCH)) for _ in range(STEPS)]
    noises = [torch.from_numpy(rng.normal(size=(BATCH, *LATENT)).astype(np.float32))
              for _ in range(STEPS)]

    state = TrainState(unet, torch.optim.SGD(unet.parameters(), lr=LR), 0, None)
    step = make_cached_latent_train_step(unet, GaussianDiffusion(make_schedule(betas)))
    losses = []
    for b, t, n in zip(batches, ts, noises):
        state, loss = step(state, b, None, 1.0, t=t, noise=n)
        losses.append(float(loss))

    outs, _ = launch("sequence", world, tmp_path, {
        "mesh_shape": mesh_shape, "unet_kw": UNET_KW, "unet_state": state_dict,
        "betas": betas, "lr": LR, "batches": batches, "ts": ts, "noises": noises})
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, atol=ATOL, rtol=0)
        for name, p in unet.state_dict().items():
            torch.testing.assert_close(out["params"][name], p, atol=ATOL, rtol=0, msg=name)
    return outs


def test_data_by_sequence_parallel_train_step_matches_one_process(tmp_path):
    """Four processes, a 2 × 2 ("data", "model") mesh: a UNet3D whose
    bottleneck attention splits its 32 tokens over ``model``, trained data
    parallel over ``data`` with SGD, against one process at the global batch
    of 4: losses and parameters after 2 steps at 1e-5 — so upstream
    gradients are scaled by the size of neither axis — and the ranks of a
    ``model`` group bitwise alike."""
    outs = _sp_train_against_one_process(tmp_path, 4, (2, 2))
    for a, b in ((0, 1), (2, 3)):
        for name in outs[a]["params"]:
            assert torch.equal(outs[a]["params"][name], outs[b]["params"][name]), name


def test_sequence_parallel_on_a_model_axis_of_one_matches_one_process(tmp_path):
    """Two processes on ``make_mesh(("data", "model"))``'s default layout,
    (2, 1): the attention's collectives run over the ``model`` group of one,
    not over the world, so each rank's output keeps its own rows and dK, dV
    are not summed over the samples of the other data rank."""
    _sp_train_against_one_process(tmp_path, 2, None)
