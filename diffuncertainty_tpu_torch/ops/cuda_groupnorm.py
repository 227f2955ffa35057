"""The GroupNorm32 + activation kernel (``csrc/group_norm_act.cu``) and its twin.

Port of ``diffuncertainty_tpu/ops/pallas_groupnorm.py``: the TPU kernel
``_kernel`` (wrapper ``fused_group_norm_act``) becomes a CUDA C++ kernel for
sm_90a, built with plain ``nvcc`` and called through ctypes
(``ops/_build.py``). ``group_norm_act_reference`` is ``group_norm_32``
followed by the activation, taken in float32 before the cast back, as the
TPU kernel does; the wrapper uses it only for tensors on the CPU. For a CUDA
tensor the wrapper launches the kernel or raises. No backward: this slice
only serves.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .norm import group_norm_f32, num_groups_for

# limits of the CUDA source, pinned to it by a CPU test
VECTOR_BYTES = 16  # one load or store per thread: 8 bf16 or 4 fp32 values
MAX_THREADS = 512  # kMaxThreads
MAX_CHANNELS = 1024  # kMaxChannels
ACTS = {"none": 0, "silu": 1, "relu": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launches = 0


def block_threads(c: int, dtype: torch.dtype) -> int | None:
    """Threads per block for ``c`` channels of ``dtype``, or None if the
    kernel does not take them: a multiple of 32 and of the vector slots per
    pixel (``c`` / values per 16 bytes), at most ``MAX_THREADS``."""
    if dtype not in DTYPES or c <= 0 or c > MAX_CHANNELS:
        return None
    per_vec = VECTOR_BYTES // torch.empty((), dtype=dtype).element_size()
    if c % per_vec:
        return None
    step = math.lcm(32, c // per_vec)
    if step > MAX_THREADS:
        return None
    return MAX_THREADS // step * step


def kernel_supports(c: int, dtype: torch.dtype) -> bool:
    return block_threads(c, dtype) is not None


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "none":
        return y
    raise ValueError(f"unsupported activation {act!r}; expected one of {sorted(ACTS)}")


def group_norm_act_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             act: str = "silu", *, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: GroupNorm32 with float32 statistics,
    the activation in float32, the result in the input dtype."""
    y = group_norm_f32(x, scale, bias, num_groups=num_groups_for(x.shape[-1]), eps=eps)
    return _activate(y, act).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("group_norm_act")
    fn = lib.group_norm_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   act: str = "silu", *, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm32 + ``act`` over the channels of ``(B, ..., C)``, bf16 or
    fp32, through the CUDA kernel; affine ``(C,)``.

    A CPU tensor goes through :func:`group_norm_act_reference`.
    """
    global _launches
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, act, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"group_norm_act takes bfloat16 or float32, got {x.dtype}")
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}; expected one of {sorted(ACTS)}")
    if x.ndim < 2:
        raise ValueError(f"group_norm_act needs (B, ..., C), got shape {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % VECTOR_BYTES:
        raise ValueError("group_norm_act needs a contiguous, 16-byte aligned channels-last x")
    c = x.shape[-1]
    threads = block_threads(c, x.dtype)
    if threads is None:
        raise ValueError(f"kernel does not take C={c} in {x.dtype}")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine shapes {tuple(scale.shape)}, {tuple(bias.shape)} != ({c},)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b = x.shape[0]
    err = _library().group_norm_act(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
        ACTS[act], b, x.numel() // b, c, num_groups_for(c), threads, eps,
        torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed: cudaError_t {err}")
    _launches += 1
    return out
