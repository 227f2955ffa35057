"""The fused-qkv attention kernels (``csrc/qkv_attention.cu``) and their plain twins.

Port of ``diffuncertainty_tpu/ops/pallas_attention.py``: the TPU kernel
``_qkv_kernel`` becomes a CUDA C++ kernel for sm_90a, built with plain
``nvcc`` and called through ctypes (``ops/_build.py``).
``qkv_attention_reference`` computes the same math in PyTorch; the wrapper
uses it only for tensors on the CPU. For a CUDA tensor the wrapper launches
the kernel or raises: the kernel takes the head widths in ``HEAD_DIMS`` (every
width the repo's networks give with 4 heads) and any token count.

Backward: when grad is enabled and ``qkv`` requires it, the wrapper goes
through :class:`QKVAttentionFn`. Its forward is the kernel, which then also
writes each row's max of the scaled scores ``m`` and sum of ``e`` ``l``
(``(B, H, T)`` float32; the output is the same bits as without them). Its
backward is the hand-written backward kernel of the same source
(FlashAttention-2's split: a pass for ``delta``, a dK/dV kernel over key
tiles, a dQ kernel over query tiles, no atomics), the VJP of the twin's math
from the saved ``qkv``, output, ``m`` and ``l``; on the CPU it is
:func:`qkv_attention_backward_reference`, the same closed form in PyTorch.
The JAX ``custom_vjp`` of ``pallas_attention.py:86-102`` differentiates its
XLA twin; the gradient is the same function. :func:`qkv_attention_vjp`
(autograd through the twin) stays as the yardstick ``chip_smoke.py`` times
and holds the kernel to; no training path calls it. Under ``no_grad`` the
wrapper launches the forward kernel alone and saves nothing, as serving does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 24, 32, 48, 64, 96, 128, 192)  # head widths the kernel is instantiated for
_launches = 0
_backward_launches = 0
_vjps = 0


def launch_count() -> int:
    """Forward kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def backward_launch_count() -> int:
    """Backward kernel launches since the last :func:`reset_launch_count`."""
    return _backward_launches


def vjp_count() -> int:
    """Twin VJPs (:func:`qkv_attention_vjp`) since the last :func:`reset_launch_count`."""
    return _vjps


def reset_launch_count() -> None:
    global _launches, _backward_launches, _vjps
    _launches = _backward_launches = _vjps = 0


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


def _attention_math(qkv: torch.Tensor, num_heads: int, stats: bool = False):
    """The output, and with ``stats`` also the row max of the scaled scores
    ``m`` and the row sum of ``e`` (l; ``(B, H, T)``, float32 or float64)."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    qkv_h = qkv.reshape(b, t, num_heads, 3 * ch)
    acc = torch.promote_types(qkv.dtype, torch.float32)  # float32, or float64 for gradcheck
    q = qkv_h[..., :ch].to(acc)
    k = qkv_h[..., ch : 2 * ch].to(acc)
    v = qkv_h[..., 2 * ch :].to(acc)
    s = torch.einsum("bthc,bshc->bhts", q, k) * _scale2(ch)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    lsum = e.sum(dim=-1)  # (B, H, T)
    o = torch.einsum("bhts,bshc->bthc", e.to(qkv.dtype).to(acc), v)
    o = (o / lsum.transpose(1, 2).unsqueeze(-1)).reshape(b, t, c).to(qkv.dtype)
    return (o, m.squeeze(-1), lsum) if stats else o


def qkv_attention_backward_reference(qkv: torch.Tensor, out: torch.Tensor, m: torch.Tensor,
                                     lsum: torch.Tensor, grad_out: torch.Tensor,
                                     num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: d(loss)/d(qkv) in ``qkv``'s
    dtype from the forward's ``out``, row max ``m`` and row sum ``lsum`` (l) and
    d(loss)/d(out), in float32 (float64 for float64 inputs). With
    e = exp(s - m): dV = (bf16(e) / l)^T dO, delta = rowsum(dO * out) / l,
    dS = e (dO V^T / l - delta), dQ = scale2 dS K, dK = scale2 dS^T Q. The
    twin's gradient through the row max is zero in exact arithmetic and left
    out, as the kernel leaves it out."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    qkv_h = qkv.reshape(b, t, num_heads, 3 * ch).to(acc).transpose(1, 2)  # (B, H, T, 3ch)
    q, k, v = qkv_h[..., :ch], qkv_h[..., ch : 2 * ch], qkv_h[..., 2 * ch :]
    d_o = grad_out.reshape(b, t, num_heads, ch).to(acc).transpose(1, 2)
    o = out.reshape(b, t, num_heads, ch).to(acc).transpose(1, 2)
    scale2 = _scale2(ch)
    linv = 1.0 / lsum.to(acc)
    e = torch.exp(q @ k.transpose(-1, -2) * scale2 - m.to(acc).unsqueeze(-1))
    dv = (e.to(qkv.dtype).to(acc) * linv.unsqueeze(-1)).transpose(-1, -2) @ d_o
    delta = (d_o * o).sum(-1) * linv
    ds = e * ((d_o @ v.transpose(-1, -2)) * linv.unsqueeze(-1) - delta.unsqueeze(-1))
    dq = (ds @ k) * scale2
    dk = (ds.transpose(-1, -2) @ q) * scale2
    return torch.cat([dq, dk, dv], dim=-1).transpose(1, 2).reshape(b, t, c3).to(qkv.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("qkv_attention")
    fn = lib.qkv_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # m, l (or null), B
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,  # T, C, H
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_int]  # scale2, stream, device
        fn.restype = ctypes.c_int
        bwd = lib.qkv_attention_backward_bf16
        bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
        bwd.restype = ctypes.c_int
    return lib


class QKVAttentionFn(torch.autograd.Function):
    """The kernel forward, saving its row statistics, with the backward
    kernel as its backward."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        out, m, lsum = _forward(qkv, num_heads, stats=True)
        ctx.save_for_backward(qkv, out, m, lsum)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        qkv, out, m, lsum = ctx.saved_tensors
        return _backward(qkv, out, m, lsum, grad_out, ctx.num_heads), None


def qkv_attention_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, T, 3C)`` bf16 -> ``(B, T, C)`` bf16 through the CUDA kernel;
    differentiable through :class:`QKVAttentionFn` when grad is enabled.

    A CPU tensor goes through :func:`qkv_attention_reference`.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return QKVAttentionFn.apply(qkv, num_heads)
    return _forward(qkv, num_heads)


def _forward(qkv: torch.Tensor, num_heads: int, stats: bool = False):
    """The output; with ``stats`` (the autograd forward) also ``m`` and
    ``lsum``, each row's max of the scaled scores and sum of e."""
    global _launches
    if qkv.device.type == "cpu":
        if stats:
            return _attention_math(qkv, num_heads, stats=True)
        return qkv_attention_reference(qkv, num_heads)
    _check(qkv, num_heads)
    b, t, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    m = lsum = None
    if stats:
        m = torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
        lsum = torch.empty_like(m)
    if out.numel() == 0:
        return (out, m, lsum) if stats else out
    err = _library().qkv_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), m.data_ptr() if stats else None,
        lsum.data_ptr() if stats else None, b, t, c, num_heads, _scale2(c // num_heads),
        torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    if err != 0:
        raise RuntimeError(f"qkv_attention kernel launch failed: cudaError_t {err}")
    _launches += 1
    return (out, m, lsum) if stats else out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, copied only if it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _backward(qkv, out, m, lsum, grad_out, num_heads):
    """d(loss)/d(qkv): the backward kernel on a CUDA tensor, its plain twin
    on the CPU."""
    global _backward_launches
    if qkv.device.type == "cpu":
        return qkv_attention_backward_reference(qkv, out, m, lsum, grad_out, num_heads)
    _check(qkv, num_heads)
    b, t, c3 = qkv.shape
    c = c3 // 3
    grad_out = _aligned(grad_out.to(qkv.dtype))
    if grad_out.shape != out.shape or m.shape != (b, num_heads, t) or lsum.shape != m.shape:
        raise ValueError(f"qkv_attention backward: grad {tuple(grad_out.shape)}, out "
                         f"{tuple(out.shape)}, m {tuple(m.shape)}, l {tuple(lsum.shape)} do "
                         f"not fit qkv {tuple(qkv.shape)}")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    rows = torch.empty((b, num_heads, t, 4), dtype=torch.float32, device=qkv.device)
    err = _library().qkv_attention_backward_bf16(
        qkv.data_ptr(), out.data_ptr(), grad_out.data_ptr(), m.data_ptr(), lsum.data_ptr(),
        rows.data_ptr(), dqkv.data_ptr(), b, t, c, num_heads, _scale2(c // num_heads),
        torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    if err != 0:
        raise RuntimeError(f"qkv_attention backward kernel launch failed: cudaError_t {err}")
    _backward_launches += 1
    return dqkv


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    """Raises unless the kernels take ``qkv`` (a contiguous, aligned bf16
    CUDA tensor of an instantiated head width)."""
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
