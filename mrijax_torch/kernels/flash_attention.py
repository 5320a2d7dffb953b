"""Flash (online-softmax) self-attention for the 3D latent UNet, forward and
backward.

Counterpart of ``mrijax/kernels/flash_attention_pallas.py`` and of the front
``mrijax/kernels/flash_attention.py::flash_attention``. Three hand-written
CUDA kernels:

* ``flash_attn_fwd`` (``mrijax_torch/csrc/flash_attention_fwd.cu``, for
  ``_flash_kernel``) streams KV tiles through shared memory, keeps running
  max / sum / accumulator in fp32 and writes the output together with the
  per-row logsumexp;
* ``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq``
  (``mrijax_torch/csrc/flash_attention_bwd.cu``, for ``_dkv_kernel`` and
  ``_dq_kernel``) recompute the probabilities from the saved logsumexp, one
  KV-major pass for dK and dV and one Q-major pass for dQ, without atomics.

For bfloat16 inputs all three run on the tensor cores (bf16 ``mma``, bf16
tiles in shared memory filled by 16-byte asynchronous copies). For float32
inputs all three are fp32-grade on the tensor cores: three TF32 passes
(x = hi + lo, hi cut to TF32; hi·hi + hi·lo + lo·hi) on Hopper's warpgroup
products, the TPU kernels' ``Precision.HIGHEST``; the forward owns 64 query
rows a block up to Dh 256 and 32 above, the backward 32 keys (dkv) or query
rows (dq). Every kernel reads its operands in 16-byte asynchronous copies.
The C entry picks by dtype. ``launch_plan`` chooses the bf16 forward's rows
per block and reports the others'.

API: q of shape (B, N, H, Dh), k and v of shape (B, Nk, H, Dh) → out
(B, N, H, Dh) in the input dtype, lse fp32 (B·H, N); Nk = N is
self-attention, Nk ≠ N a block of query rows against every key (what
``mrijax_torch.parallel.sequence`` gives each rank); scale = Dh**-0.5, folded into q and rounded to the input
dtype before the product, as in the TPU version.

Head dims: the wrappers take any Dh from 1 to ``MAX_HEAD_DIM`` (the grid's
limit of 65 535 column chunks; the Pallas kernel has no limit). The
kernels run Dh = 32, 64 and 128 in one piece (``SUPPORTED_HEAD_DIMS``) and
any multiple of ``COLUMN_CHUNK`` = 128 above that in column chunks: a block
owns one chunk of output columns (a grid axis), computes the logits over
all of Dh and accumulates P·V (dK, dV; dQ′) for its own columns only, so
its accumulators fit the register file at any Dh; every chunk recomputes
the logits. The float32 forward holds every column up to Dh 512 (one
chunk, the logits once) and takes chunks of 512 above (of 256 or 128 where
Dh is no multiple of 512), the float32 backward
chunks of 256 (of 128 where Dh is an odd multiple of 128; at Dh 256 its own
rows' terms stay whole); the three bfloat16 kernels chunks of
``BACKWARD_CHUNK`` = 256 (the last one 128 wide where Dh is an odd multiple
of 128) on Hopper's warpgroup products: the forward a
warpgroup of 64 query rows a chunk (one or two a block, ``launch_plan``),
with q′ staged once and K and V streamed past it; the backward two
warpgroups of 128 columns a block.
``flash_attention_column_chunks_reference`` and its two backward
counterparts (``width``: the chunk) are that decomposition in plain
PyTorch. Any other Dh is zero-padded up to the next size the kernels take
(``kernel_head_dim``) in q, k, v and dO and launched with the true scale
Dh**-0.5; zero columns change neither q′kᵀ nor the logsumexp, the padded
columns of out, dq, dk and dv are zero, and the wrappers slice them off
(``at_kernel_head_dim``). At 32, 64, 128 and the multiples of 128 nothing is
copied. ``flash_attention`` is a ``torch.autograd.Function``: its forward
saves (q, k, v, out, lse), its backward launches the two backward kernels.

For a CUDA tensor a wrapper launches its kernel or raises. The plain PyTorch
versions ``flash_attention_reference`` and
``flash_attention_backward_reference`` are what a CPU tensor gets, and what
the tests and ``chip_smoke.py`` hold the kernels against.

The forward kernel is also the ``torch.library`` custom op
``torch.ops.mrijax_torch.flash_attn_fwd`` (CUDA: the launch; CPU: the plain
version; a fake implementation for the shapes): an exported program
(``mrijax_torch.aot``) calls it, since ``torch.export`` cannot trace a
``ctypes`` call. ``flash_attention`` takes that route only while
``torch.compiler.is_exporting()``; the backward kernels are not ops.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mrijax_torch.kernels import _build

launches = _build.LaunchCounts("flash_attn_fwd", "flash_attn_bwd_dkv",
                               "flash_attn_bwd_dq")

SUPPORTED_HEAD_DIMS = (32, 64, 128)   # what the kernels run in one piece
COLUMN_CHUNK = 128                     # above that: multiples of this, one chunk a block
BACKWARD_CHUNK = 256                   # the chunk of the three bf16 kernels (the last may be 128)
MAX_GRID_YZ = 65535                    # blocks along grid y (B·H) and z (column chunks)
MAX_HEAD_DIM = COLUMN_CHUNK * MAX_GRID_YZ

SM_COUNT = 132                     # streaming multiprocessors of an H100
MAX_SHARED_BYTES = 232448          # dynamic shared memory a block may ask for
FORWARD_TILES = (128, 64)          # query rows per block of the bf16 forward
DKV_TILE = 64                      # keys per block of the bf16 dkv: 4 warps of 16
DQ_TILE = 64                       # query rows per block of the bf16 dq: 4 warps of 16
INNER_TILE = 64                    # keys (forward, dq) or query rows (dkv) per inner step
F32_BACKWARD_TILE = 32             # keys (dkv) or query rows (dq) a block of the float32 backward
F32_FORWARD_TILES = (64, 32)       # query rows a block of the float32 forward: Dh ≤ 256, above
F32_FORWARD_RESIDENT = 512         # the float32 forward holds every column up to this Dh
F32_FORWARD_CHUNKS = (512, 256, 128)   # above it: the largest of these that divides Dh
COPY_ALIGNMENT = 16                # bytes moved by one asynchronous copy


class LaunchPlan(NamedTuple):
    """How one of the three flash-attention kernels is launched."""
    tile: int          # query rows (forward, dq) or keys (dkv) owned by a block
    warps: int         # warps per block
    blocks: int        # B·H·⌈N/tile⌉·chunks
    shared_bytes: int  # dynamic shared memory per block, as the source computes it
    chunks: int = 1    # column chunks of output columns (grid z), Dh > 128


def runs_in_chunks(d: int) -> bool:
    """Whether the kernels take head dim ``d`` in column chunks."""
    return d > COLUMN_CHUNK and d % COLUMN_CHUNK == 0 and d <= MAX_HEAD_DIM


def launch_plan(kernel: str, b: int, n: int, h: int, d: int,
                dtype: torch.dtype) -> LaunchPlan:
    """Rows per block, warps and shared memory for one launch.

    bfloat16 (tensor-core kernels, 4 warps). A block reads all of K and V
    (Q and dO) of its (batch, head) from L2, so a larger tile means fewer
    bytes per flop — and fewer blocks. Forward: 128 query rows a block (a
    warp owns 32, and every K/V fragment feeds two products) where that still
    gives every SM a block and Dh ≥ 64, else 64 rows. At the 800-token
    bottleneck with B·H = 8 that is 64 rows and 104 blocks: 32 rows would
    cover all 132 SMs with 200 blocks but measured 15 % slower on an H100
    (PERF.md) and are not compiled, because a warp's critical path stays the
    same while the K/V traffic doubles; with B·H = 32 it is 128 rows and 224
    blocks. At Dh = 32 the softmax instructions bind, not the fragment reads,
    and 64 rows (more warps an SM) measured 2 % faster
    (``scripts/probe_torch_flash_tiles.py`` times 64 against 128).
    dkv: 64 keys, a constant of the source (32 measured 11–29 % slower, 128 no
    faster; its accumulators leave no registers for a second fragment of keys
    a warp); dq: 64 query rows, the same design turned Q-major. Their plans
    report blocks and shared memory and steer nothing.
    Tiles are bf16 with a pitch of Dh + 8:
    forward Q + 2 stages of K and V; dkv K, V + 2 stages of Q, dO and of the
    rows' lse and Δ; dq Q, dO + 2 stages of K and V.
    float32, 8 warps (two warpgroups), three TF32 passes on ``wgmma``. The
    forward (``_f32_forward_plan``): 64 query rows a block up to Dh 256, 32
    above, 225.5 KB of shared memory at Dh 128. dkv and dq:
    ``F32_BACKWARD_TILE`` = 32 keys or query rows a
    block, the other side streamed in tiles of 64 rows; in shared memory, in
    rows of 128 bytes and 1 KB of alignment, the own rows' TF32 hi and lo
    terms of two tensors (64 KB at Dh 128), two slots of a tile's two tensors
    as they are (64 KB each at Dh 128), the P and dU hi and lo terms of 32 ×
    64 (dq: dU's), and in dkv two slots of lse and Δ: 226 KB (dkv) and
    209 KB (dq) at Dh 128, one block an SM.

    Dh a multiple of 128 above 128: ``chunks`` blocks per tile (grid z).
    float32. The forward: one chunk up to Dh 512, above it chunks of 512
    (``F32_FORWARD_CHUNKS``). dkv and dq: chunks of 256
    (Dh/256 of them; 128 where Dh is an odd multiple of 128), 32 own rows a
    block; a tile of the other side comes as Dh/64 units of 64 logit
    columns (the tile's and the own rows' two tensors, the own rows' terms
    split anew into one of two 32 KB buffers) and one unit for each 128 of
    the chunk's columns of the tile: two 64 KB slots, the same 226 KB and
    209 KB. At Dh 256 the own rows' terms stay (128 KB) and the units carry
    the tile alone (two 32 KB slots; dkv's accumulating units 64 columns of
    both tensors, dq's 128 of K). bfloat16:
    ⌈Dh/256⌉ chunks of ``BACKWARD_CHUNK`` columns (at Dh 384 the last is 128
    wide) in 64-row blocks of 64 columns in the 128-byte swizzle, one block
    an SM.
    Forward: a warpgroup (4 warps) of 64 query rows a chunk; 64 rows a
    block where those blocks (chunks counted) fit the card in one wave, else
    128 (two warpgroups sharing each K and V tile): a block of 128 rows
    took 1.2–1.3× the time of one of 64 on an H100, so at (2, 6400, 1, 256)
    100 blocks of 128 beat 200 of 64 by 1.5×
    (``scripts/probe_torch_flash_tiles.py``). Shared memory: the rows' q′
    of the chunk (32 KB a warpgroup), a ring of two 64 KB slots of 64-key K
    and V tiles (or of 128-column pieces of K and q outside the chunk), 1 KB
    to align the swizzle. dkv and dq: 64 keys or query rows a block, 8
    warps (two warpgroups of 128 columns); the block's own 64 rows of the
    chunk (K and V, or q′ and dO: 64 KB), a ring of two 64 KB slots of the
    other side's 64-row tiles (or of 128-column pieces of both sides outside
    the chunk), the P and dU (dkv: 32 KB; dq: dU, 16 KB) bf16 hi and lo
    tiles, in dkv two slots of lse and Δ (1 KB), and the 1 KB of alignment.
    """
    if kernel not in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        raise ValueError(f"no launch plan for {kernel!r}")
    if runs_in_chunks(d):
        return _chunked_plan(kernel, b, n, h, d, dtype)
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash-attention kernels take head dims {SUPPORTED_HEAD_DIMS} or a multiple "
            f"of {COLUMN_CHUNK} up to {MAX_HEAD_DIM}, got {d}")
    forward = kernel == "flash_attn_fwd"
    if dtype == torch.float32 and forward:
        return _f32_forward_plan(b, n, h, d)
    if dtype == torch.float32:
        tile, warps = F32_BACKWARD_TILE, 8
        shared = _f32_backward_shared(kernel, d)
    elif dtype == torch.bfloat16:
        big, small = FORWARD_TILES
        if not forward:
            tile = DKV_TILE if kernel == "flash_attn_bwd_dkv" else DQ_TILE
        elif d >= 64 and b * h * -(-n // big) >= SM_COUNT:
            tile = big
        else:
            tile = small
        warps = 4
        rows = tile + 4 * INNER_TILE if forward else 2 * tile + 4 * INNER_TILE
        stats = 4 * 4 * INNER_TILE if kernel == "flash_attn_bwd_dkv" else 0
        shared = 2 * rows * (d + 8) + stats
    else:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"{kernel}: {shared} bytes of shared memory exceed {MAX_SHARED_BYTES}")
    return LaunchPlan(tile, warps, b * h * -(-n // tile), shared)


def _chunked_plan(kernel: str, b: int, n: int, h: int, d: int,
                  dtype: torch.dtype) -> LaunchPlan:
    """``launch_plan`` of the column-chunk kernels (Dh a multiple of 128)."""
    tile = 64
    if dtype == torch.float32:
        if kernel == "flash_attn_fwd":
            return _f32_forward_plan(b, n, h, d)
        chunks, warps = d // COLUMN_CHUNK, 8
        tile, shared = F32_BACKWARD_TILE, _f32_backward_shared(kernel, d)
        if d % BACKWARD_CHUNK == 0:
            chunks = d // BACKWARD_CHUNK
    elif dtype == torch.bfloat16:
        # csrc/flash_attention_{fwd,bwd}.cu, namespace wide: 64-row blocks of
        # 64 columns (8 KB); a slot and the backward's own rows 8 blocks
        chunks = -(-d // BACKWARD_CHUNK)
        block = 64 * 64 * 2
        if kernel == "flash_attn_fwd":
            big, small = FORWARD_TILES
            tile = small if b * h * -(-n // small) * chunks <= SM_COUNT else big
            warps = tile // 16
            shared = 1024 + tile // 64 * 4 * block + 2 * 8 * block
        else:
            warps = 8
            tiles = 4 * block + 2 * 2 * 64 * 4 if kernel == "flash_attn_bwd_dkv" else 2 * block
            shared = 1024 + 8 * block + 2 * 8 * block + tiles
    else:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return LaunchPlan(tile, warps, b * h * -(-n // tile) * chunks, shared, chunks)


def _f32_forward_plan(b: int, n: int, h: int, d: int) -> LaunchPlan:
    """``launch_plan`` of the float32 forward (``csrc/flash_attention_fwd.cu``,
    ``f32::Layout``): 8 warps; ``own`` = 64 query rows a block up to Dh 256,
    32 above. Shared memory from a 1 KB alignment on: the own rows' q′ hi and
    lo terms (own × Dh each; above ``F32_FORWARD_RESIDENT`` two buffers of a
    unit's, own × 128 each), a ring of 2 to 4 slots (as many as fit 227 KB)
    of units of 64 keys × min(Dh, 128) columns of K or V (above 512 with q's
    own rows of the unit's columns), P's hi and lo terms (own × 64 each), α
    and l of the own rows. 225.5 KB at Dh 128 and 256, 209.25 KB at 384 and
    512, 225.25 KB above."""
    own = F32_FORWARD_TILES[0] if d <= 2 * COLUMN_CHUNK else F32_FORWARD_TILES[1]
    resident = d <= F32_FORWARD_RESIDENT
    unit = min(d, COLUMN_CHUNK)
    own_bytes = (2 * own * d if resident else 4 * own * unit) * 4
    slot = (INNER_TILE + (0 if resident else own)) * unit * 4
    fixed = 1024 + own_bytes + 2 * own * INNER_TILE * 4 + 2 * own * 4
    ring = min(4, (MAX_SHARED_BYTES - fixed) // slot)
    chunks = 1 if resident else d // next(c for c in F32_FORWARD_CHUNKS if d % c == 0)
    return LaunchPlan(own, 8, b * h * -(-n // own) * chunks, fixed + ring * slot, chunks)


def _f32_backward_shared(kernel: str, d: int) -> int:
    """Shared bytes of the float32 backward kernels (``csrc/flash_attention_bwd.cu``,
    ``f32::Layout``): 1 KB of alignment; the own rows' hi and lo terms of two
    tensors, 32 rows of Dh columns (up to 256; above: two buffers of 64
    columns); the P and dU terms, 32 × 64 each (dq: dU's two); two slots of
    a tile's two tensors, 64 rows of Dh columns (at 256: of 64, above: of
    128); dkv's lse and Δ of two tiles."""
    own, rows = F32_BACKWARD_TILE, INNER_TILE
    dkv = kernel == "flash_attn_bwd_dkv"
    own_bytes = 4 * own * d * 4 if d <= 2 * COLUMN_CHUNK else 2 * 4 * own * 64 * 4
    slot = 2 * rows * (d if d <= COLUMN_CHUNK else 64 if d == 2 * COLUMN_CHUNK
                       else COLUMN_CHUNK) * 4
    stats = 2 * 2 * rows * 4 if dkv else 0
    return 1024 + own_bytes + (4 if dkv else 2) * own * rows * 4 + 2 * slot + stats


def _misalignment(t: torch.Tensor) -> Optional[str]:
    """What keeps ``t`` from being read in 16-byte copies, or None."""
    size = t.element_size()
    if t.data_ptr() % COPY_ALIGNMENT != 0:
        return (f"data pointer is not {COPY_ALIGNMENT}-byte aligned "
                f"(storage offset {t.storage_offset()} elements of {size} bytes)")
    for axis, stride in zip(("batch", "token", "head"), t.stride()[:3]):
        if stride * size % COPY_ALIGNMENT != 0:
            return (f"{axis} stride {stride} elements is {stride * size} bytes, "
                    f"not a multiple of {COPY_ALIGNMENT}")
    return None


def check_copy_alignment(name: str, t: torch.Tensor) -> None:
    """The kernels move rows of Dh values in 16-byte asynchronous copies:
    the data pointer and every (batch, token, head) stride must be multiples
    of 16 bytes. Raises a ``ValueError`` that names the operand."""
    fault = _misalignment(t)
    if fault:
        raise ValueError(f"{name}: {fault}")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns ``(out, lse)``.

    Rounds where the kernel rounds: q·scale (default Dh^-1/2) to the input
    dtype before the q′kᵀ product, the unnormalised probabilities to the input
    dtype before the p·v product; logits, softmax statistics and both
    accumulations in fp32. Materialises the (B, H, N, M) logits, so it is for
    tests and comparisons; k and v may hold another number of tokens M than
    q, as the kernel does.
    """
    b, n, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhnm,bmhd->bhnd", p.to(q.dtype).float(), v.float())
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, n)
    return out.contiguous(), lse


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in fp32, laid out like ``lse``: (B·H, N)."""
    b, n, h, _ = out.shape
    delta = (dout.float() * out.float()).sum(dim=-1)            # (B, N, H)
    return delta.permute(0, 2, 1).reshape(b * h, n).contiguous()


def _logits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnhd,bmhd->bhnm", a, b)


def _p_and_du_blocks(q, k, v, dout, lse, delta, q_block, scale, logits=_logits):
    """Per block of query rows: (rows, q′, dO, p, dU), all fp32, with
    q′ = q·scale rounded to the input dtype, p = exp(q′kᵀ − lse) and
    dU = p∘(dO·Vᵀ − Δ) as (B, H, rows, N); ``logits`` takes the products."""
    b, n, h, d = q.shape
    step = n if q_block is None else q_block
    kf, vf = k.float(), v.float()
    lse, delta = lse.reshape(b, h, n), delta.reshape(b, h, n)
    for start in range(0, n, step):
        rows = slice(start, start + step)
        qs = (q[:, rows].float() * scale).to(q.dtype).float()
        p = torch.exp(logits(qs, kf) - lse[:, :, rows, None])
        dp = logits(dout[:, rows].to(v.dtype).float(), vf)
        du = p * (dp - delta[:, :, rows, None])
        yield rows, qs, dout[:, rows].float(), p, du


def flash_attn_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q_block: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``flash_attn_bwd_dkv``: ``(dk, dv)`` with
    dV = pᵀ·dO and dK = dUᵀ·q′, p and dU fp32, summed in fp32 over blocks of
    ``q_block`` query rows and rounded once; ``scale`` defaults to Dh^-1/2."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for _, qs, do, p, du in _p_and_du_blocks(q, k, v, dout, lse, delta, q_block, scale):
        dv += torch.einsum("bhnm,bnhd->bmhd", p, do)
        dk += torch.einsum("bhnm,bnhd->bmhd", du, qs)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q_block: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attn_bwd_dq``: dQ′ = dU·K, rounded to
    the input dtype, multiplied by ``scale`` (default Dh^-1/2) in fp32 and
    rounded again (the two casts of the TPU wrapper)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kf = k.float()
    for rows, _, _, _, du in _p_and_du_blocks(q, k, v, dout, lse, delta, q_block, scale):
        dq_prime = torch.einsum("bhnm,bmhd->bnhd", du, kf)
        dq[:, rows] = (dq_prime.to(q.dtype).float() * scale).to(q.dtype)
    return dq


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, q_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``(dq, dk, dv)`` in the input
    dtype from the forward's saved ``out`` and ``lse``.

    Rounds where the kernels round, which is not where the forward does:
    q′ = q·Dh^-1/2 rounded to the input dtype (the q′ of the forward);
    p = exp(q′kᵀ − lse) and dU = p∘(dO·Vᵀ − Δ) stay fp32 for the products
    that consume them; Δ = rowsum(dO∘O) in fp32. Materialises (B, H, rows, N)
    logits: ``q_block`` runs it on that many query rows at a time, so a long
    sequence can be checked.
    """
    delta = flash_attention_delta(out, dout)
    dk, dv = flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta, q_block)
    return flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta, q_block), dk, dv


def _piecewise_logits(a: torch.Tensor, b: torch.Tensor,
                      width: int = COLUMN_CHUNK) -> torch.Tensor:
    """(B, H, N, M) fp32 logits a·bᵀ of fp32 (B, N, H, D) and (B, M, H, D),
    summed over pieces of ``width`` columns in order, as the column-chunk
    kernels sum them."""
    s = None
    for cols in _column_chunks(a.shape[-1], width):
        part = torch.einsum("bnhd,bmhd->bhnm", a[..., cols], b[..., cols])
        s = part if s is None else s + part
    return s


def _column_chunks(d: int, width: int = COLUMN_CHUNK):
    return [slice(c0, c0 + width) for c0 in range(0, d, width)]


def flash_attention_column_chunks_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    width: int = BACKWARD_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-chunk forward in plain PyTorch: ``(out, lse)``.

    For each chunk of ``width`` output columns (the last may be narrower),
    as a block of the kernel does: the logits over all of Dh, summed piece
    by piece; max, the probabilities (rounded to the input dtype for the
    product, the row sum unrounded) and P·V over that chunk's columns of V
    only; lse from the first chunk. Rounds where
    ``flash_attention_reference`` rounds.
    """
    b, n, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    outs, lse = [], None
    for cols in _column_chunks(d, width):
        s = _piecewise_logits(qs, kf, width)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhnm,bmhd->bhnd", p.to(q.dtype).float(), vf[..., cols])
        outs.append(acc / l)
        if lse is None:
            lse = (m + torch.log(l)).reshape(b * h, n)
    out = torch.cat(outs, dim=-1).permute(0, 2, 1, 3).to(q.dtype)
    return out.contiguous(), lse


def flash_attn_bwd_dkv_column_chunks_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: Optional[float] = None,
    width: int = BACKWARD_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-chunk ``flash_attn_bwd_dkv`` in plain PyTorch: for each
    chunk of ``width`` columns (the last may be narrower), p and dU over all
    of Dh (logits summed piece by piece), then dV and dK of that chunk's
    columns only."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    logits = functools.partial(_piecewise_logits, width=width)
    for cols in _column_chunks(q.shape[-1], width):
        for _, qs, do, p, du in _p_and_du_blocks(q, k, v, dout, lse, delta, None, scale,
                                                 logits=logits):
            dv[..., cols] += torch.einsum("bhnm,bnhd->bmhd", p, do[..., cols])
            dk[..., cols] += torch.einsum("bhnm,bnhd->bmhd", du, qs[..., cols])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_dq_column_chunks_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: Optional[float] = None,
    width: int = BACKWARD_CHUNK,
) -> torch.Tensor:
    """The column-chunk ``flash_attn_bwd_dq`` in plain PyTorch: for each
    chunk of ``width`` columns, dU over all of Dh, then dQ′ = dU·K of that
    chunk's columns, rounded to the input dtype, times ``scale`` and rounded
    again."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kf = k.float()
    logits = functools.partial(_piecewise_logits, width=width)
    for cols in _column_chunks(q.shape[-1], width):
        for rows, _, _, _, du in _p_and_du_blocks(q, k, v, dout, lse, delta, None, scale,
                                                  logits=logits):
            dq_prime = torch.einsum("bhnm,bmhd->bnhd", du, kf[..., cols])
            dq[:, rows, :, cols] = (dq_prime.to(q.dtype).float() * scale).to(q.dtype)
    return dq


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_fwd")
    if lib.flash_attn_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_fwd.argtypes = (
            [p] * 5 + [i] * 7 + [ll] * 9 + [ctypes.c_double, p]
        )
        lib.flash_attn_fwd.restype = i
    return lib


_BwdStrides = ctypes.c_longlong * 12


def _backward_library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    if lib.flash_attn_bwd_dkv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_double, p]
        lib.flash_attn_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + tail
        lib.flash_attn_bwd_dkv.restype = i
        lib.flash_attn_bwd_dq.argtypes = [p] * 7 + [i] * 6 + tail
        lib.flash_attn_bwd_dq.restype = i
    return lib


def _token_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, token, head) strides in elements; the kernels read rows of Dh
    contiguous values and take any layout of the other three axes."""
    if t.stride(3) != 1:
        raise ValueError(
            f"{name}: the head dimension must be contiguous, got strides {t.stride()}"
        )
    return t.stride(0), t.stride(1), t.stride(2)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, N, H, Dh) against k and v of one (B, Nk, H, Dh) shape: the
    token counts may differ, nothing else may."""
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3])):
        raise ValueError(
            f"k and v must share one (B, Nk, H, Dh) shape, and q (B, N, H, Dh) "
            f"its B, H and Dh; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share dtype and device")


def _check_kernel_operands(**operands: torch.Tensor) -> None:
    """Sizes the kernels take, and the alignment their 16-byte copies need,
    of q and of every strided operand given by name."""
    q = operands["q"]
    _check_kernel_sizes(q, operands["k"].shape[1])
    for name, t in operands.items():
        check_copy_alignment(name, t)


def _check_kernel_sizes(q: torch.Tensor, nk: int) -> None:
    b, n, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS and not runs_in_chunks(d):
        raise ValueError(
            f"flash-attention kernels take head dims {SUPPORTED_HEAD_DIMS} or a multiple "
            f"of {COLUMN_CHUNK} up to {MAX_HEAD_DIM}, got {d}"
        )
    if n < 1 or nk < 1 or b * h < 1 or b * h > MAX_GRID_YZ:
        raise ValueError(f"unsupported sizes: N={n}, Nk={nk}, B*H={b * h} (1..{MAX_GRID_YZ})")


def kernel_head_dim(d: int) -> int:
    """The head dim a true head dim ``d`` is launched at: up to 128 the least
    of ``SUPPORTED_HEAD_DIMS`` that holds it, above 128 the least multiple of
    ``COLUMN_CHUNK``. A ``ValueError`` outside 1..``MAX_HEAD_DIM``."""
    for size in SUPPORTED_HEAD_DIMS:
        if 1 <= d <= size:
            return size
    if SUPPORTED_HEAD_DIMS[-1] < d <= MAX_HEAD_DIM:
        return -(-d // COLUMN_CHUNK) * COLUMN_CHUNK
    raise ValueError(f"flash-attention kernels take head dims 1..{MAX_HEAD_DIM}, got {d}")


def at_kernel_head_dim(launch, *operands: torch.Tensor):
    """``launch(*operands, scale)`` at ``kernel_head_dim`` with the TRUE
    scale Dh^-1/2, Dh the operands' last axis.

    At a compiled head dim the operands go as they are. Otherwise each is
    zero-padded along its last axis (a new contiguous tensor) and every
    four-axis result is cut back to its first Dh columns, contiguous; other
    results (the (B·H, N) logsumexp) come back as they are. The CUDA wrappers
    launch through this; a test can hand it a plain version instead.
    """
    d = operands[0].shape[-1]
    size = kernel_head_dim(d)
    scale = float(d ** -0.5)
    if size == d:
        return launch(*operands, scale)
    result = launch(*(F.pad(t, (0, size - d)) for t in operands), scale)

    def cut(t: torch.Tensor) -> torch.Tensor:
        return t[..., :d].contiguous() if t.dim() == 4 else t

    return tuple(map(cut, result)) if isinstance(result, tuple) else cut(result)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention output and logsumexp: ``(out (B,N,H,Dh), lse (B·H,N) fp32)``,
    with no gradient recorded (``flash_attention`` is the differentiable
    front).

    On CUDA: the ``flash_attn_fwd`` kernel (``at_kernel_head_dim``), or an
    error for what it does not take (a dtype other than float32/bfloat16, a
    head dimension above ``MAX_HEAD_DIM``, a strided last axis, rows that are
    not 16-byte aligned). On the CPU: ``flash_attention_reference``.
    """
    _check_qkv(q, k, v)
    q, k, v = q.detach(), k.detach(), v.detach()
    if not q.is_cuda:
        return flash_attention_reference(q, k, v)
    return at_kernel_head_dim(_launch_forward, q, k, v)


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_attn_fwd`` at q's own (compiled) head dim."""
    code = _build.dtype_code(q.dtype)
    _check_kernel_operands(q=q, k=k, v=v)
    b, n, h, d = q.shape
    plan = launch_plan("flash_attn_fwd", b, n, h, d, q.dtype)
    nk = k.shape[1]
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _token_strides(name, t)]
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), code, b, n, nk, h, d, plan.tile, *strides, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_launch(err, "flash_attn_fwd")
    launches.bump("flash_attn_fwd")
    return out, lse


def _check_backward_operands(q, k, v, dout, lse, delta) -> None:
    _check_qkv(q, k, v)
    b, n, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(
            f"dout must be {q.dtype} {tuple(q.shape)} beside q, got "
            f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b * h, n) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {(b * h, n)} tensor beside "
                f"q, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_backward(entry: str, q, k, v, dout, lse, delta, outputs, scale: float) -> None:
    """Launch ``flash_attn_bwd_dkv`` or ``flash_attn_bwd_dq`` on checked CUDA
    operands at their own (compiled) head dim; ``outputs`` are the contiguous
    tensors the kernel writes."""
    b, n, h, d = q.shape
    nk = k.shape[1]
    code = _build.dtype_code(q.dtype)
    _check_kernel_operands(q=q, k=k, v=v, dout=dout)
    strides = _BwdStrides(*[
        s for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout))
        for s in _token_strides(name, t)])
    fn = getattr(_backward_library(), entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
                 code, b, n, nk, h, d, strides, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, entry)
    launches.bump(entry)


def flash_attn_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, contiguous (B, Nk, H, Dh) like k in the input dtype, from
    the forward's ``lse`` and Δ = rowsum(dO∘O), both fp32 (B·H, N). q, k, v and
    ``dout`` are read through their (batch, token, head) strides. On CUDA the
    ``flash_attn_bwd_dkv`` kernel (``at_kernel_head_dim``) or an error; on the
    CPU its plain version."""
    _check_backward_operands(q, k, v, dout, lse, delta)
    if not q.is_cuda:
        return flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)

    def launch(q, k, v, dout, scale):
        dk, dv = torch.empty(k.shape, dtype=q.dtype, device=q.device), \
            torch.empty(k.shape, dtype=q.dtype, device=q.device)
        _launch_backward("flash_attn_bwd_dkv", q, k, v, dout, lse, delta, (dk, dv), scale)
        return dk, dv

    return at_kernel_head_dim(launch, q, k, v, dout)


def flash_attn_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> torch.Tensor:
    """``dq``, contiguous (B, N, H, Dh) in the input dtype; operands as for
    ``flash_attn_bwd_dkv``. On CUDA the ``flash_attn_bwd_dq`` kernel
    (``at_kernel_head_dim``) or an error; on the CPU its plain version."""
    _check_backward_operands(q, k, v, dout, lse, delta)
    if not q.is_cuda:
        return flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)

    def launch(q, k, v, dout, scale):
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch_backward("flash_attn_bwd_dq", q, k, v, dout, lse, delta, (dq,), scale)
        return dq

    return at_kernel_head_dim(launch, q, k, v, dout)


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the output
    gradient ``dout``: Δ = rowsum(dO∘O) in plain PyTorch (the TPU wrapper
    computes it outside its kernels too), then ``flash_attn_bwd_dkv`` and
    ``flash_attn_bwd_dq``. ``dout`` is copied only if its last axis is not
    contiguous (an expanded gradient), its dtype is not the inputs' or its
    rows are not 16-byte aligned (both kernels read it in 16-byte copies)."""
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(
            f"out and dout must be {tuple(q.shape)}, got {tuple(out.shape)} "
            f"and {tuple(dout.shape)}")
    if dout.dtype != q.dtype or dout.stride(3) != 1 or _misalignment(dout):
        dout = torch.empty(q.shape, dtype=q.dtype, device=q.device).copy_(dout)
    delta = flash_attention_delta(out, dout)
    dk, dv = flash_attn_bwd_dkv(q, k, v, dout, lse, delta)
    return flash_attn_bwd_dq(q, k, v, dout, lse, delta), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse) as the TPU version's ``_fwd`` does;
    backward is ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return flash_attention_backward(*ctx.saved_tensors, dout)


@torch.library.custom_op("mrijax_torch::flash_attn_fwd", mutates_args=(), device_types="cpu")
def flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_forward`` as a custom op: ``(out, lse)`` from the
    plain version on the CPU, from the kernel on CUDA."""
    return flash_attention_forward(q, k, v)


@flash_attn_fwd_op.register_kernel("cuda")
def _(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_forward(q, k, v)


@flash_attn_fwd_op.register_fake
def _(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    b, n, h, d = q.shape
    return (q.new_empty((b, n, h, d)), q.new_empty((b * h, n), dtype=torch.float32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Memory-efficient attention, differentiable. q (B, N, H, Dh) against
    k, v (B, Nk, H, Dh) → (B, N, H, Dh). A call that records no gradient (sampling) goes straight to
    the forward kernel; inside ``torch.export`` it is the custom op."""
    if torch.compiler.is_exporting():
        return flash_attn_fwd_op(q, k, v)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_attention_forward(q, k, v)[0]
