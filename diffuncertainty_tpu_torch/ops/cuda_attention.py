"""The fused-qkv attention kernel (``csrc/qkv_attention.cu``) and its plain twin.

Port of ``diffuncertainty_tpu/ops/pallas_attention.py``: the TPU kernel
``_qkv_kernel`` becomes a CUDA C++ kernel for sm_90a, built with plain
``nvcc`` and called through ctypes (``ops/_build.py``).
``qkv_attention_reference`` computes the same math in PyTorch; the wrapper
uses it only for tensors on the CPU. For a CUDA tensor the wrapper launches
the kernel or raises: the kernel takes the head widths in ``HEAD_DIMS`` (every
width the repo's networks give with 4 heads) and any token count.

Backward: when grad is enabled and ``qkv`` requires it, the wrapper goes
through :class:`QKVAttentionFn`, whose forward is the kernel and whose
backward is :func:`qkv_attention_vjp`, the VJP of the plain twin's math on
the saved ``qkv`` (the JAX ``custom_vjp`` of ``pallas_attention.py:86-102``
differentiates its XLA twin the same way). Under ``no_grad`` the wrapper
launches the kernel alone, as serving does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 24, 32, 48, 64, 96, 128, 192)  # head widths the kernel is instantiated for
_launches = 0
_vjps = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def vjp_count() -> int:
    """Backward VJPs since the last :func:`reset_launch_count`."""
    return _vjps


def reset_launch_count() -> None:
    global _launches, _vjps
    _launches = _vjps = 0


def _scale2(ch: int) -> float:
    # the JAX call passes scale = ch**-0.25 as a python float and squares it
    return (float(ch) ** -0.25) ** 2


def qkv_attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: legacy split, f32 scores scaled after
    the product, f32 softmax statistics, PV on e cast to the input dtype,
    division by the row sum after PV."""
    return _attention_math(qkv, num_heads)


def qkv_attention_vjp(qkv: torch.Tensor, num_heads: int, grad_out: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(qkv) from d(loss)/d(out), by autograd through the twin's math
    on ``qkv``; in ``qkv``'s dtype."""
    global _vjps
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(_attention_math(x, num_heads), x, grad_out)
    _vjps += 1
    return grad.to(qkv.dtype)


def _attention_math(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    qkv_h = qkv.reshape(b, t, num_heads, 3 * ch)
    acc = torch.promote_types(qkv.dtype, torch.float32)  # float32, or float64 for gradcheck
    q = qkv_h[..., :ch].to(acc)
    k = qkv_h[..., ch : 2 * ch].to(acc)
    v = qkv_h[..., 2 * ch :].to(acc)
    s = torch.einsum("bthc,bshc->bhts", q, k) * _scale2(ch)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1).transpose(1, 2).unsqueeze(-1)  # (B, T, H, 1)
    o = torch.einsum("bhts,bshc->bthc", e.to(qkv.dtype).to(acc), v) / denom
    return o.reshape(b, t, c).to(qkv.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("qkv_attention")
    fn = lib.qkv_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


class QKVAttentionFn(torch.autograd.Function):
    """The kernel forward with the twin's VJP as its backward."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _forward(qkv, num_heads)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return qkv_attention_vjp(qkv, ctx.num_heads, grad_out), None


def qkv_attention_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, T, 3C)`` bf16 -> ``(B, T, C)`` bf16 through the CUDA kernel;
    differentiable through :class:`QKVAttentionFn` when grad is enabled.

    A CPU tensor goes through :func:`qkv_attention_reference`.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return QKVAttentionFn.apply(qkv, num_heads)
    return _forward(qkv, num_heads)


def _forward(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    global _launches
    if qkv.device.type == "cpu":
        return qkv_attention_reference(qkv, num_heads)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv_attention_cuda takes bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % num_heads:
        raise ValueError(f"qkv shape {tuple(qkv.shape)} is not (B, T, 3C) with C % {num_heads} == 0")
    b, t, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    if ch not in HEAD_DIMS:
        raise ValueError(f"kernel has no head width {ch}; it is built for {HEAD_DIMS}")
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv_attention_cuda: unsupported device {qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv_attention_cuda needs a contiguous, 16-byte aligned qkv")
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    err = _library().qkv_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), b, t, c, num_heads, _scale2(ch),
        torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    if err != 0:
        raise RuntimeError(f"qkv_attention kernel launch failed: cudaError_t {err}")
    _launches += 1
    return out
