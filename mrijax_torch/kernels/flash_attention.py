"""Flash (online-softmax) self-attention forward for the 3D latent UNet.

Counterpart of ``mrijax/kernels/flash_attention_pallas.py`` (forward:
``_flash_kernel`` / ``_flash_forward_lse``) and of the front
``mrijax/kernels/flash_attention.py::flash_attention``. The hand-written CUDA
kernel ``flash_attn_fwd`` (``mrijax_torch/csrc/flash_attention_fwd.cu``)
streams KV tiles through shared memory, keeps running max / sum / accumulator
in fp32 and writes the output together with the per-row logsumexp, which the
backward of the training slice will need.

API: q, k, v of shape (B, N, H, Dh) → out (B, N, H, Dh) in the input dtype,
lse fp32 (B·H, N); scale = Dh**-0.5, folded into q and rounded to the input
dtype before the product, as in the TPU version.

For a CUDA tensor the wrapper launches the kernel or raises. The plain PyTorch
version ``flash_attention_reference`` is what a CPU tensor gets, and what the
tests and ``chip_smoke.py`` hold the kernel against. Forward only.
"""

import ctypes
from typing import Tuple

import torch

from mrijax_torch.kernels import _build

launches = _build.LaunchCounts("flash_attn_fwd")

SUPPORTED_HEAD_DIMS = (32, 64, 128)


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


def _library() -> ctypes.CDLL:
    lib = _build.library("flash_attention_fwd")
    if lib.flash_attn_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attn_fwd.argtypes = (
            [p] * 5 + [i] * 5 + [ll] * 9 + [ctypes.c_double, p]
        )
        lib.flash_attn_fwd.restype = i
    return lib


def _token_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, token, head) strides in elements; the kernel reads rows of Dh
    contiguous values and takes any layout of the other three axes."""
    if t.stride(3) != 1:
        raise ValueError(
            f"{name}: the head dimension must be contiguous, got strides {t.stride()}"
        )
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention output and logsumexp: ``(out (B,N,H,Dh), lse (B·H,N) fp32)``.

    On CUDA: the ``flash_attn_fwd`` kernel, or an error for what it does not
    take (a dtype other than float32/bfloat16, a head dimension outside
    ``SUPPORTED_HEAD_DIMS``, a strided last axis, tensors that need a
    gradient). On the CPU: ``flash_attention_reference``.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, N, H, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share dtype and device")
    if not q.is_cuda:
        return flash_attention_reference(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention kernel is forward only: call it under "
            "torch.no_grad() (its backward kernels are not ported yet)"
        )
    b, n, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash-attention kernel takes head dims {SUPPORTED_HEAD_DIMS}, got {d}"
        )
    if n < 1 or b * h < 1 or b * h > 65535:
        raise ValueError(f"unsupported sizes: N={n}, B*H={b * h} (1..65535)")
    code = _build.dtype_code(q.dtype)
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _token_strides(name, t)]
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), code, b, n, h, d, *strides, float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_launch(err, "flash_attn_fwd")
    launches.bump("flash_attn_fwd")
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Memory-efficient attention. q, k, v: (B, N, H, Dh) → (B, N, H, Dh)."""
    return flash_attention_forward(q, k, v)[0]
