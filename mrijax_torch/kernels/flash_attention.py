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
tiles in shared memory filled by 16-byte asynchronous copies); for float32
inputs every product is fp32 FMAs. The C entry picks by dtype.
``launch_plan`` chooses the forward's rows per block and reports the others'.

API: q, k, v of shape (B, N, H, Dh) → out (B, N, H, Dh) in the input dtype,
lse fp32 (B·H, N); scale = Dh**-0.5, folded into q and rounded to the input
dtype before the product, as in the TPU version. ``flash_attention`` is a
``torch.autograd.Function``: its forward saves (q, k, v, out, lse), its
backward launches the two backward kernels.

For a CUDA tensor a wrapper launches its kernel or raises. The plain PyTorch
versions ``flash_attention_reference`` and
``flash_attention_backward_reference`` are what a CPU tensor gets, and what
the tests and ``chip_smoke.py`` hold the kernels against.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from mrijax_torch.kernels import _build

launches = _build.LaunchCounts("flash_attn_fwd", "flash_attn_bwd_dkv",
                               "flash_attn_bwd_dq")

SUPPORTED_HEAD_DIMS = (32, 64, 128)

SM_COUNT = 132                     # streaming multiprocessors of an H100
MAX_SHARED_BYTES = 232448          # dynamic shared memory a block may ask for
FORWARD_TILES = (128, 64)          # query rows per block of the bf16 forward: 4 warps of 32 or 16
DKV_TILE = 64                      # keys per block of the bf16 dkv: 4 warps of 16
DQ_TILE = 64                       # query rows per block of the bf16 dq: 4 warps of 16
INNER_TILE = 64                    # keys (forward, dq) or query rows (dkv) per inner step
COPY_ALIGNMENT = 16                # bytes moved by one asynchronous copy


class LaunchPlan(NamedTuple):
    """How one of the three flash-attention kernels is launched."""
    tile: int          # query rows (forward, dq) or keys (dkv) owned by a block
    warps: int         # warps per block
    blocks: int        # B·H·⌈N/tile⌉
    shared_bytes: int  # dynamic shared memory per block, as the source computes it


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
    float32 (FMA kernels): fixed 64 rows and 256 threads, fp32 tiles of pitch
    Dh + 4 and (64, 68) P (and, in dkv, dU) tiles.
    """
    if kernel not in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        raise ValueError(f"no launch plan for {kernel!r}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash-attention kernels take head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    forward = kernel == "flash_attn_fwd"
    if dtype == torch.float32:
        tile, warps = 64, 8
        floats = {"flash_attn_fwd": 2 * 64 * (d + 4) + 64 * d + 64 * 68,
                  "flash_attn_bwd_dkv": 4 * 64 * (d + 4) + 2 * 64 * 68,
                  "flash_attn_bwd_dq": 4 * 64 * (d + 4) + 64 * 68}[kernel]
        shared = 4 * floats
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
    """The bf16 kernels move rows of Dh values in 16-byte asynchronous copies:
    the data pointer and every (batch, token, head) stride must be multiples
    of 16 bytes. Raises a ``ValueError`` that names the operand."""
    fault = _misalignment(t)
    if fault:
        raise ValueError(f"{name}: {fault}")


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns ``(out, lse)``.

    Rounds where the kernel rounds: q·Dh^-1/2 to the input dtype before the
    q′kᵀ product, the unnormalised probabilities to the input dtype before the
    p·v product; logits, softmax statistics and both accumulations in fp32.
    Materialises the (B, H, N, M) logits, so it is for tests and comparisons;
    k and v may hold another number of tokens M than q, which lets a caller
    check a long sequence a block of query rows at a time.
    """
    b, n, h, d = q.shape
    scale = d ** -0.5
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


def _p_and_du_blocks(q, k, v, dout, lse, delta, q_block):
    """Per block of query rows: (rows, q′, dO, p, dU), all fp32, with
    p = exp(q′kᵀ − lse) and dU = p∘(dO·Vᵀ − Δ) as (B, H, rows, N)."""
    b, n, h, d = q.shape
    scale = d ** -0.5
    step = n if q_block is None else q_block
    kf, vf = k.float(), v.float()
    lse, delta = lse.reshape(b, h, n), delta.reshape(b, h, n)
    for start in range(0, n, step):
        rows = slice(start, start + step)
        qs = (q[:, rows].float() * scale).to(q.dtype).float()
        p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qs, kf)
                      - lse[:, :, rows, None])
        dp = torch.einsum("bnhd,bmhd->bhnm", dout[:, rows].to(v.dtype).float(), vf)
        du = p * (dp - delta[:, :, rows, None])
        yield rows, qs, dout[:, rows].float(), p, du


def flash_attn_bwd_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``flash_attn_bwd_dkv``: ``(dk, dv)`` with
    dV = pᵀ·dO and dK = dUᵀ·q′, p and dU fp32, summed in fp32 over blocks of
    ``q_block`` query rows and rounded once."""
    dk = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, qs, do, p, du in _p_and_du_blocks(q, k, v, dout, lse, delta, q_block):
        dv += torch.einsum("bhnm,bnhd->bmhd", p, do)
        dk += torch.einsum("bhnm,bnhd->bmhd", du, qs)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, q_block: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attn_bwd_dq``: dQ′ = dU·K, rounded to
    the input dtype, multiplied by Dh^-1/2 in fp32 and rounded again (the two
    casts of the TPU wrapper)."""
    scale = q.shape[-1] ** -0.5
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kf = k.float()
    for rows, _, _, _, du in _p_and_du_blocks(q, k, v, dout, lse, delta, q_block):
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


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_fwd")
    if lib.flash_attn_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_fwd.argtypes = (
            [p] * 5 + [i] * 6 + [ll] * 9 + [ctypes.c_double, p]
        )
        lib.flash_attn_fwd.restype = i
    return lib


_BwdStrides = ctypes.c_longlong * 12


def _backward_library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    if lib.flash_attn_bwd_dkv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_double, p]
        lib.flash_attn_bwd_dkv.argtypes = [p] * 8 + [i] * 5 + tail
        lib.flash_attn_bwd_dkv.restype = i
        lib.flash_attn_bwd_dq.argtypes = [p] * 7 + [i] * 5 + tail
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
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, N, H, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share dtype and device")


def _check_kernel_operands(**operands: torch.Tensor) -> None:
    """Sizes the kernels take and, for bfloat16, the alignment their 16-byte
    copies need, of q and of every strided operand given by name."""
    q = operands["q"]
    _check_kernel_sizes(q)
    if q.dtype == torch.bfloat16:
        for name, t in operands.items():
            check_copy_alignment(name, t)


def _check_kernel_sizes(q: torch.Tensor) -> None:
    b, n, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash-attention kernels take head dims {SUPPORTED_HEAD_DIMS}, got {d}"
        )
    if n < 1 or b * h < 1 or b * h > 65535:
        raise ValueError(f"unsupported sizes: N={n}, B*H={b * h} (1..65535)")


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention output and logsumexp: ``(out (B,N,H,Dh), lse (B·H,N) fp32)``,
    with no gradient recorded (``flash_attention`` is the differentiable
    front).

    On CUDA: the ``flash_attn_fwd`` kernel, or an error for what it does not
    take (a dtype other than float32/bfloat16, a head dimension outside
    ``SUPPORTED_HEAD_DIMS``, a strided last axis, bfloat16 rows that are not
    16-byte aligned). On the CPU: ``flash_attention_reference``.
    """
    _check_qkv(q, k, v)
    q, k, v = q.detach(), k.detach(), v.detach()
    if not q.is_cuda:
        return flash_attention_reference(q, k, v)
    code = _build.dtype_code(q.dtype)
    _check_kernel_operands(q=q, k=k, v=v)
    b, n, h, d = q.shape
    plan = launch_plan("flash_attn_fwd", b, n, h, d, q.dtype)
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _token_strides(name, t)]
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), code, b, n, h, d, plan.tile, *strides, float(d ** -0.5),
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


def _launch_backward(entry: str, q, k, v, dout, lse, delta, outputs) -> None:
    """Launch ``flash_attn_bwd_dkv`` or ``flash_attn_bwd_dq`` on checked CUDA
    operands; ``outputs`` are the contiguous tensors the kernel writes."""
    b, n, h, d = q.shape
    code = _build.dtype_code(q.dtype)
    _check_kernel_operands(q=q, k=k, v=v, dout=dout)
    strides = _BwdStrides(*[
        s for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout))
        for s in _token_strides(name, t)])
    fn = getattr(_backward_library(), entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
                 code, b, n, h, d, strides, float(d ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, entry)
    launches.bump(entry)


def flash_attn_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, contiguous (B, N, H, Dh) in the input dtype, from the
    forward's ``lse`` and Δ = rowsum(dO∘O), both fp32 (B·H, N). q, k, v and
    ``dout`` are read through their (batch, token, head) strides. On CUDA the
    ``flash_attn_bwd_dkv`` kernel or an error; on the CPU its plain version."""
    _check_backward_operands(q, k, v, dout, lse, delta)
    if not q.is_cuda:
        return flash_attn_bwd_dkv_reference(q, k, v, dout, lse, delta)
    dk, dv = torch.empty(q.shape, dtype=q.dtype, device=q.device), \
        torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_backward("flash_attn_bwd_dkv", q, k, v, dout, lse, delta, (dk, dv))
    return dk, dv


def flash_attn_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> torch.Tensor:
    """``dq``, contiguous (B, N, H, Dh) in the input dtype; operands as for
    ``flash_attn_bwd_dkv``. On CUDA the ``flash_attn_bwd_dq`` kernel or an
    error; on the CPU its plain version."""
    _check_backward_operands(q, k, v, dout, lse, delta)
    if not q.is_cuda:
        return flash_attn_bwd_dq_reference(q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_backward("flash_attn_bwd_dq", q, k, v, dout, lse, delta, (dq,))
    return dq


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the output
    gradient ``dout``: Δ = rowsum(dO∘O) in plain PyTorch (the TPU wrapper
    computes it outside its kernels too), then ``flash_attn_bwd_dkv`` and
    ``flash_attn_bwd_dq``. ``dout`` is copied only if its last axis is not
    contiguous (an expanded gradient), its dtype is not the inputs' or, for
    bfloat16, its rows are not 16-byte aligned."""
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(
            f"out and dout must be {tuple(q.shape)}, got {tuple(out.shape)} "
            f"and {tuple(dout.shape)}")
    if (dout.dtype != q.dtype or dout.stride(3) != 1
            or (q.dtype == torch.bfloat16 and _misalignment(dout))):
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Memory-efficient attention, differentiable. q, k, v: (B, N, H, Dh) →
    (B, N, H, Dh). A call that records no gradient (sampling) goes straight to
    the forward kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_attention_forward(q, k, v)[0]
