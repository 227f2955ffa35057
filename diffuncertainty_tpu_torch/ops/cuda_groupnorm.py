"""The GroupNorm32 + activation kernel (``csrc/group_norm_act.cu``) and its twin.

Port of ``diffuncertainty_tpu/ops/pallas_groupnorm.py``: the TPU kernel
``_kernel`` (wrapper ``fused_group_norm_act``) becomes a CUDA C++ kernel for
sm_90a, built with plain ``nvcc`` and called through ctypes
(``ops/_build.py``). One thread-block cluster of K blocks takes each batch
element; :func:`cluster_plan` chooses K, the block size and how much of each
block's slice its shared memory holds, from the shape alone.
``group_norm_act_reference`` is ``group_norm_32`` followed by the
activation, taken in float32 before the cast back, as the TPU kernel does;
the wrapper uses it only for tensors on the CPU. For a CUDA tensor the
wrapper launches the kernel or raises. No backward: this slice only serves.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .norm import group_norm_f32, num_groups_for

# limits of the CUDA source, pinned to it by a CPU test
VECTOR_BYTES = 16  # one load or store per thread: 8 bf16 or 4 fp32 values
MAX_THREADS = 512  # kMaxThreads
MAX_CHANNELS = 2048  # kMaxChannels
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 (kMaxCluster) is a non-portable cluster size
SMEM_LIMIT = 232448  # kSmemLimit: dynamic shared memory one block may use (227 KB)
CHUNKS = 4  # kChunks: bulk copies, each on its own mbarrier, per cached slice
ACTS = {"none": 0, "silu": 1, "relu": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# The H100's SMs and the shared memory of one SM, of which each resident block
# also takes 1 KB for the system. A block of THIRD_SMEM runs three to an SM, of
# PAIR_SMEM two: then one block loads while another normalises and stores.
SMS = 132
SM_SMEM = 233472
THIRD_SMEM = SM_SMEM // 3 - 1024
PAIR_SMEM = SM_SMEM // 2 - 1024
# A smaller grid doubles K up to this many blocks (measured on the H100: past
# it, at 16 rows, the larger clusters cost more than the SMs they fill)
FILL_BLOCKS = 64
_launches = 0
_clusters: dict[tuple, int] = {}  # plan key -> cudaOccupancyMaxActiveClusters


class Plan(NamedTuple):
    cluster: int  # K blocks per batch element
    smem: int  # dynamic shared memory bytes per block
    threads: int
    mode: str  # "resident": read once; "stream": pixels past cache_pix read twice
    slice_pix: int  # pixels of one block
    cache_pix: int  # of them held in shared memory


def _vector(dtype: torch.dtype) -> int:
    return VECTOR_BYTES // ELEMENT_BYTES[dtype]


def block_threads(c: int, dtype: torch.dtype, most: int = MAX_THREADS) -> int | None:
    """Threads per block for ``c`` channels of ``dtype``, or None if the
    kernel does not take them: the largest multiple of 32 and of the packets
    per pixel (``c`` / values per 16 bytes) up to ``most``, so every thread
    keeps fixed channels; where no such multiple exists, ``most`` (the
    threads past the last whole pixel then idle) if it covers a pixel."""
    if dtype not in DTYPES or c <= 0 or c > MAX_CHANNELS or c % _vector(dtype):
        return None
    cv = c // _vector(dtype)
    step = math.lcm(32, cv)
    if step <= most:
        return most // step * step
    return most if cv <= most else None


def kernel_supports(c: int, dtype: torch.dtype) -> bool:
    return block_threads(c, dtype) is not None


def fixed_smem(c: int, dtype: torch.dtype, threads: int) -> int:
    """Shared memory of a block besides its cached pixels (``smem_layout``):
    the mbarriers, the table of partials (``part_rows`` x ``c`` floats), two
    per-channel and four per-group float arrays."""
    cv = c // _vector(dtype)
    part_rows = threads // 32 if 32 % cv == 0 else threads // cv
    return CHUNKS * 8 + part_rows * c * 4 + 2 * c * 4 + 4 * num_groups_for(c) * 4


def plan_for(s: int, c: int, dtype: torch.dtype, k: int, threads: int, budget: int) -> Plan:
    """K blocks of ``threads`` threads, each caching what of its slice fits
    ``budget`` bytes of shared memory."""
    pix = c * ELEMENT_BYTES[dtype]
    fixed = fixed_smem(c, dtype, threads)
    slice_pix = -(-s // k)
    cache_pix = min(slice_pix, (budget - fixed) // pix)
    return Plan(cluster=k, smem=fixed + cache_pix * pix, threads=threads,
                mode="resident" if cache_pix == slice_pix else "stream",
                slice_pix=slice_pix, cache_pix=cache_pix)


@functools.lru_cache(maxsize=None)
def cluster_plan(s: int, c: int, dtype: torch.dtype, rows: int) -> Plan | None:
    """The launch of ``rows`` batch elements of ``s`` pixels and ``c``
    channels, or None if the kernel does not take ``c`` in ``dtype``.

    The smallest cluster whose blocks of (about) 256 threads hold their
    whole slice ("resident", read from device memory once) three to an SM,
    else two; then K doubles while the grid has fewer than ``FILL_BLOCKS``
    blocks and every block keeps a pixel. An element that even 16 blocks of
    two to an SM do not hold takes K = 16 blocks of 512 threads in "stream"
    mode: each block holds what fits and reads the rest of its slice twice,
    the second time from L2."""
    wide = block_threads(c, dtype)
    if wide is None or s <= 0 or rows <= 0:
        return None
    threads = block_threads(c, dtype, 256) or wide
    for budget in (THIRD_SMEM, PAIR_SMEM):
        fits = [k for k in CLUSTER_SIZES
                if plan_for(s, c, dtype, k, threads, budget).mode == "resident"]
        if fits:
            break
    else:
        return plan_for(s, c, dtype, CLUSTER_SIZES[-1], wide, PAIR_SMEM)
    k = fits[0]
    while k < CLUSTER_SIZES[-1] and rows * k < FILL_BLOCKS and 2 * k <= s:
        k *= 2
    return plan_for(s, c, dtype, k, threads, budget)


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
    if lib.group_norm_act.argtypes is None:
        plan = [ctypes.c_int] * 5  # cluster, threads, slice_pix, cache_pix, smem
        lib.group_norm_act.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, bias, y
            ctypes.c_int, ctypes.c_int,  # dtype, act
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # rows, s, c, groups
            *plan, ctypes.c_float, ctypes.c_void_p, ctypes.c_int]  # eps, stream, device
        lib.group_norm_act.restype = ctypes.c_int
        lib.group_norm_act_clusters.argtypes = [
            ctypes.c_int, ctypes.c_int,  # dtype, act
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # s, c, groups
            *plan, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]  # device, the answer
        lib.group_norm_act_clusters.restype = ctypes.c_int
    return lib


def _plan_args(s: int, c: int, plan: Plan) -> tuple:
    return (s, c, num_groups_for(c), plan.cluster, plan.threads, plan.slice_pix, plan.cache_pix,
            plan.smem)


def max_active_clusters(s: int, c: int, dtype: torch.dtype, act: str, plan: Plan,
                        device: torch.device) -> int:
    """How many clusters of ``plan`` the card runs at once
    (``cudaOccupancyMaxActiveClusters``), asked once per plan and device."""
    index = torch.device(device).index or 0
    key = (index, DTYPES[dtype], ACTS[act], c, plan)
    if key not in _clusters:
        out = ctypes.c_int(0)
        err = _library().group_norm_act_clusters(DTYPES[dtype], ACTS[act], *_plan_args(s, c, plan),
                                                 index, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"group_norm_act: cudaOccupancyMaxActiveClusters failed for "
                               f"{plan}: cudaError_t {err}")
        _clusters[key] = out.value
    return _clusters[key]


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   act: str = "silu", *, eps: float = 1e-5, plan: Plan | None = None
                   ) -> torch.Tensor:
    """GroupNorm32 + ``act`` over the channels of ``(B, ..., C)``, bf16 or
    fp32, through the CUDA kernel; affine ``(C,)``. ``plan`` replaces
    :func:`cluster_plan`'s launch (to measure another one).

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
    if not kernel_supports(c, x.dtype):
        raise ValueError(f"kernel does not take C={c} in {x.dtype}")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"affine shapes {tuple(scale.shape)}, {tuple(bias.shape)} != ({c},)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows = x.shape[0]
    s = x.numel() // (rows * c)
    plan = plan or cluster_plan(s, c, x.dtype, rows)
    if max_active_clusters(s, c, x.dtype, act, plan, x.device) == 0:
        raise RuntimeError(f"group_norm_act: no cluster of {plan} fits on {x.device}")
    err = _library().group_norm_act(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
        ACTS[act], rows, *_plan_args(s, c, plan), eps,
        torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed for {plan}: cudaError_t {err}")
    _launches += 1
    return out
