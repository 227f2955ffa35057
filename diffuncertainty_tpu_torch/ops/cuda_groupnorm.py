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
wrapper launches the kernel or raises. The affine is ``(C,)``, or ``(M, C)``
for member-folded rows (row ``r`` of ``B`` takes member ``r // (B / M)``'s
row of it; ``B % M != 0`` raises), as the JAX ``group_norm_32`` takes it.

Backward: when grad is enabled and ``x``, ``scale`` or ``bias`` requires
it, the wrapper goes through :class:`GroupNormActFn`. Its forward is the
kernel, which then also writes each row's group mean and variance
E[x^2] - mean^2 before its clamp at 0 (``(B, G)`` float32; the output is the
same bits as without them; the clamp's gradient needs the variance's sign).
Its backward is the hand-written backward kernel of the same source, one
launch a call: one cluster per element as the forward, planned by the
forward's planner with x and dy both cached (:func:`backward_plan`), whose
last cluster of each member adds the member's rows into dscale and dbias in
a fixed order. It is the VJP of the twin's math (float32 statistics, the
activation in float32) from the saved inputs and statistics: dx in ``x``'s
dtype, dscale and dbias in the affine's shape and dtype. On the CPU it is
:func:`group_norm_act_backward_reference`, the same closed form in PyTorch.
The JAX package trains on its plain ``group_norm_32``; its Pallas kernel has
no backward.
:func:`group_norm_act_vjp` (autograd through the twin) stays as the
yardstick ``chip_smoke.py`` times and holds the kernel to; no training path
calls it. Under ``no_grad`` the wrapper launches the forward kernel alone and
saves nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .norm import group_norm_f32, group_stats, member_rows, num_groups_for

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
_backward_launches = 0
_vjps = 0
_clusters: dict[tuple, int] = {}  # plan key -> cudaOccupancyMaxActiveClusters
# (device index, stream) -> the backward's per-member counters (int32, zero
# between launches: the kernel sets each back to 0)
_counters: dict[tuple, torch.Tensor] = {}


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


def fixed_smem(c: int, dtype: torch.dtype, threads: int, backward: bool = False) -> int:
    """Shared memory of a block besides its cached pixels: the mbarriers,
    the table of partials (``part_rows`` x ``c`` floats), then for the
    forward (``smem_layout``) two per-channel and four per-group float
    arrays, for the backward (``bwd_layout``) six and five."""
    cv = c // _vector(dtype)
    part_rows = threads // 32 if 32 % cv == 0 else threads // cv
    arrays = (6 * c + 5 * num_groups_for(c)) if backward else (2 * c + 4 * num_groups_for(c))
    return CHUNKS * 8 + part_rows * c * 4 + arrays * 4


def plan_for(s: int, c: int, dtype: torch.dtype, k: int, threads: int, budget: int,
             backward: bool = False) -> Plan:
    """K blocks of ``threads`` threads, each caching what of its slice fits
    ``budget`` bytes of shared memory: a pixel of x, or for the
    ``backward`` a pixel of x and one of dy."""
    pix = c * ELEMENT_BYTES[dtype] * (2 if backward else 1)
    fixed = fixed_smem(c, dtype, threads, backward)
    slice_pix = -(-s // k)
    cache_pix = max(0, min(slice_pix, (budget - fixed) // pix))
    return Plan(cluster=k, smem=fixed + cache_pix * pix, threads=threads,
                mode="resident" if cache_pix == slice_pix else "stream",
                slice_pix=slice_pix, cache_pix=cache_pix)


@functools.lru_cache(maxsize=None)
def cluster_plan(s: int, c: int, dtype: torch.dtype, rows: int,
                 backward: bool = False) -> Plan | None:
    """The launch of ``rows`` batch elements of ``s`` pixels and ``c``
    channels, or None if the kernel does not take ``c`` in ``dtype``;
    ``backward``: the backward kernel's, which caches x and dy.

    The smallest cluster whose blocks of (about) 256 threads hold their
    whole slice ("resident", read from device memory once) three to an SM,
    else two; then K doubles while the grid has fewer than ``FILL_BLOCKS``
    blocks and every block keeps a pixel. An element that even 16 blocks of
    two to an SM do not hold takes K = 16 blocks of 512 threads in "stream"
    mode: each block holds what fits and reads the rest of its slice twice,
    the second time from L2.

    The backward keeps three blocks of (about) 256 threads to an SM
    throughout: resident at ``THIRD_SMEM`` where that holds the slice, else
    K = 16 streaming past ``THIRD_SMEM``. Its kernel is compiled for three
    such blocks, and it computes more than it moves: on the H100 a third
    block an SM beat a larger cache at every training site (PERF.md)."""
    wide = block_threads(c, dtype)
    if wide is None or s <= 0 or rows <= 0:
        return None
    threads = block_threads(c, dtype, 256) or wide
    budgets = (THIRD_SMEM,) if backward else (THIRD_SMEM, PAIR_SMEM)
    for budget in budgets:
        fits = [k for k in CLUSTER_SIZES
                if plan_for(s, c, dtype, k, threads, budget, backward).mode == "resident"]
        if fits:
            break
    else:
        if backward:
            return plan_for(s, c, dtype, CLUSTER_SIZES[-1], threads, THIRD_SMEM, backward)
        return plan_for(s, c, dtype, CLUSTER_SIZES[-1], wide, PAIR_SMEM)
    k = fits[0]
    while k < CLUSTER_SIZES[-1] and rows * k < FILL_BLOCKS and 2 * k <= s:
        k *= 2
    return plan_for(s, c, dtype, k, threads, budget, backward)


def backward_plan(s: int, c: int, dtype: torch.dtype, rows: int) -> Plan | None:
    """The backward kernel's launch: :func:`cluster_plan` costing a cached
    pixel of x and one of dy."""
    return cluster_plan(s, c, dtype, rows, backward=True)


def vjp_count() -> int:
    """Twin VJPs (:func:`group_norm_act_vjp`) since the last :func:`reset_launch_count`."""
    return _vjps


def launch_count() -> int:
    """Forward kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def backward_launch_count() -> int:
    """Backward kernel launches since the last :func:`reset_launch_count`."""
    return _backward_launches


def reset_launch_count() -> None:
    global _launches, _backward_launches, _vjps
    _launches = _backward_launches = _vjps = 0


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
    return _group_norm_act_math(x, scale, bias, act, eps)


def _group_norm_act_math(x, scale, bias, act, eps):
    y = group_norm_f32(x, scale, bias, num_groups=num_groups_for(x.shape[-1]), eps=eps)
    return _activate(y, act).to(x.dtype)


def group_norm_act_backward_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                      mean: torch.Tensor, var: torch.Tensor,
                                      grad_out: torch.Tensor, act: str = "silu", *,
                                      eps: float = 1e-5) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the backward kernel: (dx, dscale, dbias) from
    the forward's inputs, its group ``mean`` and ``var`` (E[x^2] - mean^2
    before the clamp) and d(loss)/d(out), in float32 (float64 for float64
    inputs), each in its input's dtype and the affine's shape.

    The closed form is the twin's derivative as autograd takes it, step by
    step with the same operations in the same order, so that on the CPU it
    equals autograd of the twin bit for bit (a gradient that is exactly 0,
    such as a bias before a group of one channel, is a rounding residue that
    AdamW turns into steps of the learning rate: its rounding is part of the
    result). With r = 1/sqrt(max(var, 0) + eps), a = r scale, b = bias -
    mean a, y = x a + b, dy' = dy act'(y) and n the group's element count:
    gb = sum dy', ga = sum dy' x - gb mean; dbias = gb, dscale = ga r;
    g_r = sum_c ga scale, g_var = -r^3 g_r / 2 (0 where var < 0: the
    clamp's gradient), g_mean = -sum_c gb a - 2 mean g_var (in that order);
    dx = dy' a + 2 x g_var / n + g_mean / n, which is the centred
    r (scale dy' - mean_g(scale dy') - xh mean_g(scale dy' xh)) in exact
    arithmetic."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b, c = x.shape[0], x.shape[-1]
    groups = num_groups_for(c)
    cpg = c // groups
    spatial = tuple(range(1, x.ndim - 1))
    bshape = (b,) + (1,) * len(spatial) + (c,)
    n = float(x[0].numel() // c * cpg)
    xf = x.to(acc)
    mean, var = mean.to(acc), var.to(acc)

    def channels(t):  # (B, G) -> (B, C), as repeat_interleave
        return t.repeat_interleave(cpg, dim=-1)

    def group_sum(t):  # (B, C) -> (B, G), as repeat_interleave's backward
        return t.view(b, groups, cpg).sum(-1)

    members = scale.shape[0] if scale.ndim == 2 else 1

    def affine_sum(t):  # (B, C) -> the affine's shape, as member_rows' backward
        return t.view(members, b // members, c).sum(1).reshape(scale.shape)

    r = torch.rsqrt(torch.clamp(var, min=0.0) + eps)  # the forward's, bit for bit
    inv = channels(r)
    gam = member_rows(scale.to(acc), b)
    a = inv * gam
    mean_c = channels(mean)
    y = xf * a.view(bshape) + (member_rows(bias.to(acc), b) - mean_c * a).view(bshape)
    g = grad_out.to(acc)
    if act == "silu":
        g = torch.ops.aten.silu_backward(g, y)
    elif act == "relu":
        g = torch.ops.aten.threshold_backward(g, y, 0)
    elif act != "none":
        raise ValueError(f"unsupported activation {act!r}; expected one of {sorted(ACTS)}")
    gb = g.sum(dim=spatial, keepdim=True).view(b, c)
    ga = (g * xf).sum(dim=spatial, keepdim=True).view(b, c) + (-gb) * mean_c
    dscale = affine_sum(ga * inv)
    g_var = torch.where(var >= 0, -0.5 * group_sum(ga * gam) * r.pow(3), 0.0)
    g_mean = group_sum((-gb) * a) + (-g_var) * mean + (-g_var) * mean
    dx = g * a.view(bshape)
    sq = channels(g_var / n).view(bshape) * xf
    dx = dx + sq + sq + channels(g_mean / n).view(bshape)
    return dx.to(x.dtype), dscale.to(scale.dtype), affine_sum(gb).to(bias.dtype)


def group_norm_act_vjp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, act: str,
                       eps: float, grad_out: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(dx, dscale, dbias) from d(loss)/d(out), by autograd through the
    twin's math on the inputs; each in its input's dtype."""
    global _vjps
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        grads = torch.autograd.grad(_group_norm_act_math(*leaves, act, eps), leaves, grad_out)
    _vjps += 1
    return tuple(g.to(t.dtype) for g, t in zip(grads, (x, scale, bias)))


class GroupNormActFn(torch.autograd.Function):
    """The kernel forward, saving its group statistics, with the backward
    kernel as its backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, act: str, eps: float, plan):
        y, mean, var = _forward(x, scale, bias, act, eps, plan, stats=True)
        ctx.save_for_backward(x, scale, bias, mean, var)
        ctx.act, ctx.eps = act, eps
        return y

    @staticmethod
    def backward(ctx, grad_out):
        x, scale, bias, mean, var = ctx.saved_tensors
        dx, dscale, dbias = _backward(x, scale, bias, mean, var, grad_out, ctx.act, ctx.eps)
        return dx, dscale, dbias, None, None, None


def _library() -> ctypes.CDLL:
    lib = _build.load("group_norm_act")
    if lib.group_norm_act.argtypes is None:
        plan = [ctypes.c_int] * 5  # cluster, threads, slice_pix, cache_pix, smem
        lib.group_norm_act.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, bias, y
            ctypes.c_void_p, ctypes.c_void_p,  # mean, var (or null)
            ctypes.c_int, ctypes.c_int,  # dtype, act
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # rows, s, c, groups
            ctypes.c_int,  # rows per member
            *plan, ctypes.c_float, ctypes.c_void_p, ctypes.c_int]  # eps, stream, device
        lib.group_norm_act.restype = ctypes.c_int
        lib.group_norm_act_clusters.argtypes = [
            ctypes.c_int, ctypes.c_int,  # dtype, act
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # s, c, groups
            *plan, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]  # device, the answer
        lib.group_norm_act_clusters.restype = ctypes.c_int
        lib.group_norm_act_backward.argtypes = [
            *[ctypes.c_void_p] * 9,  # x, dy, scale, bias, mean, var, dx, grads, counters
            ctypes.c_int, ctypes.c_int,  # dtype, act
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # rows, s, c, groups
            ctypes.c_int,  # rows per member
            *plan, ctypes.c_float, ctypes.c_void_p, ctypes.c_int]  # eps, stream, device
        lib.group_norm_act_backward.restype = ctypes.c_int
        lib.group_norm_act_backward_clusters.argtypes = lib.group_norm_act_clusters.argtypes
        lib.group_norm_act_backward_clusters.restype = ctypes.c_int
    return lib


def _plan_args(s: int, c: int, plan: Plan) -> tuple:
    return (s, c, num_groups_for(c), plan.cluster, plan.threads, plan.slice_pix, plan.cache_pix,
            plan.smem)


def _launch_args(s: int, c: int, rows_per_member: int, plan: Plan) -> tuple:
    """:func:`_plan_args` with the rows per member after the groups, as the
    launch takes them."""
    args = _plan_args(s, c, plan)
    return args[:3] + (rows_per_member,) + args[3:]


def max_active_clusters(s: int, c: int, dtype: torch.dtype, act: str, plan: Plan,
                        device: torch.device, backward: bool = False) -> int:
    """How many clusters of ``plan`` (the forward's, or with ``backward``
    the backward kernel's) the card runs at once
    (``cudaOccupancyMaxActiveClusters``), asked once per plan and device."""
    index = torch.device(device).index or 0
    key = (index, DTYPES[dtype], ACTS[act], c, plan, backward)
    if key not in _clusters:
        out = ctypes.c_int(0)
        lib = _library()
        ask = lib.group_norm_act_backward_clusters if backward else lib.group_norm_act_clusters
        err = ask(DTYPES[dtype], ACTS[act], *_plan_args(s, c, plan), index, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"group_norm_act: cudaOccupancyMaxActiveClusters failed for "
                               f"{plan}: cudaError_t {err}")
        _clusters[key] = out.value
    return _clusters[key]


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   act: str = "silu", *, eps: float = 1e-5, plan: Plan | None = None
                   ) -> torch.Tensor:
    """GroupNorm32 + ``act`` over the channels of ``(B, ..., C)``, bf16 or
    fp32, through the CUDA kernel; affine ``(C,)`` or ``(M, C)``. ``plan`` replaces
    :func:`cluster_plan`'s launch (to measure another one).

    A CPU tensor goes through :func:`group_norm_act_reference`.
    Differentiable through :class:`GroupNormActFn` when grad is enabled.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return GroupNormActFn.apply(x, scale, bias, act, eps, plan)
    return _forward(x, scale, bias, act, eps, plan)


def _forward(x, scale, bias, act, eps, plan, stats: bool = False):
    """The output; with ``stats`` (the autograd forward) also each row's group
    mean and variance before its clamp."""
    global _launches
    if x.device.type == "cpu":
        y = group_norm_act_reference(x, scale, bias, act, eps=eps)
        return (y, *group_stats(x, num_groups_for(x.shape[-1]))) if stats else y
    scale, bias, members = _check(x, scale, bias, act)
    rows, c = x.shape[0], x.shape[-1]
    out = torch.empty_like(x)
    mean = var = None
    if stats:
        mean = torch.empty((rows, num_groups_for(c)), dtype=torch.float32, device=x.device)
        var = torch.empty_like(mean)
    if x.numel() == 0:
        return (out, mean, var) if stats else out
    s = x.numel() // (rows * c)
    plan = plan or cluster_plan(s, c, x.dtype, rows)
    if max_active_clusters(s, c, x.dtype, act, plan, x.device) == 0:
        raise RuntimeError(f"group_norm_act: no cluster of {plan} fits on {x.device}")
    err = _library().group_norm_act(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        mean.data_ptr() if stats else None, var.data_ptr() if stats else None, DTYPES[x.dtype],
        ACTS[act], rows, *_launch_args(s, c, rows // members, plan), eps,
        torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed for {plan}: cudaError_t {err}")
    _launches += 1
    return (out, mean, var) if stats else out


def _member_counters(index: int, stream: int, members: int) -> torch.Tensor:
    """The backward's per-member counters for launches on ``stream`` of
    device ``index``: one int32 buffer per device and stream, zeroed once
    when made (a larger member count makes a larger one); the kernel leaves
    every counter 0."""
    counters = _counters.get((index, stream))
    if counters is None or counters.numel() < members:
        counters = torch.zeros(max(members, 64), dtype=torch.int32, device=f"cuda:{index}")
        _counters[(index, stream)] = counters
    return counters


@functools.lru_cache(maxsize=None)
def _backward_args(s: int, c: int, dtype: torch.dtype, rows: int, members: int, act: str,
                   index: int, plan: Plan | None = None) -> tuple:
    """The backward launch's arguments from the dtype to the plan
    (:func:`backward_plan`'s unless ``plan`` is given), for ``rows``
    elements of ``s`` pixels on device ``index``, once the plan is known to
    fit there (one occupancy query per plan)."""
    plan = plan or backward_plan(s, c, dtype, rows)
    if max_active_clusters(s, c, dtype, act, plan, torch.device("cuda", index),
                           backward=True) == 0:
        raise RuntimeError(f"group_norm_act backward: no cluster of {plan} fits on cuda:{index}")
    return (DTYPES[dtype], ACTS[act], rows, *_launch_args(s, c, rows // members, plan))


def _backward(x, scale, bias, mean, var, grad_out, act, eps, plan: Plan | None = None):
    """(dx, dscale, dbias): the backward kernel on a CUDA tensor (one
    launch; dscale and dbias are views of one float32 buffer that also holds
    the rows' partials), its plain twin on the CPU. ``plan`` replaces
    :func:`backward_plan`'s launch (to measure another one)."""
    global _backward_launches
    if x.device.type == "cpu":
        return group_norm_act_backward_reference(x, scale, bias, mean, var, grad_out, act,
                                                 eps=eps)
    scale32, bias32, members = _check(x, scale, bias, act)
    rows, c = x.shape[0], x.shape[-1]
    if grad_out.dtype != x.dtype or not grad_out.is_contiguous():
        grad_out = grad_out.to(x.dtype).contiguous()
    if grad_out.data_ptr() % VECTOR_BYTES:
        grad_out = grad_out.clone()
    if grad_out.shape != x.shape or mean.shape != (rows, num_groups_for(c)) or \
            var.shape != mean.shape:
        raise ValueError(f"group_norm_act backward: grad {tuple(grad_out.shape)}, mean "
                         f"{tuple(mean.shape)}, var {tuple(var.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    dx = torch.empty_like(x)
    # dscale and dbias, then each row's share of both (the kernel's scratch)
    grads = torch.empty((2 * (members + rows), c), dtype=torch.float32, device=x.device)
    if x.numel() > 0:
        index, s = x.device.index, x.numel() // (rows * c)
        args = _backward_args(s, c, x.dtype, rows, members, act, index, plan)
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = _library().group_norm_act_backward(
            x.data_ptr(), grad_out.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
            mean.data_ptr(), var.data_ptr(), dx.data_ptr(), grads.data_ptr(),
            _member_counters(index, stream, members).data_ptr(), *args, eps, stream, index)
        if err != 0:
            raise RuntimeError(f"group_norm_act backward kernel launch failed for "
                               f"{plan or backward_plan(s, c, x.dtype, rows)}: cudaError_t {err}")
        _backward_launches += 1
    else:
        grads.zero_()  # no rows: the affine's gradients are 0
    if scale.ndim == 1:
        dscale, dbias = grads[0], grads[1]
    else:
        dscale, dbias = grads[:members], grads[members:2 * members]
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


def _check(x, scale, bias, act):
    """Raises unless the kernels take ``x`` and its affine; returns the
    affine as contiguous float32 on x's device and the member count."""
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
    rows = x.shape[0]
    if scale.shape != bias.shape or scale.shape not in ((c,), (scale.shape[0], c)):
        raise ValueError(f"affine shapes {tuple(scale.shape)}, {tuple(bias.shape)}: expected "
                         f"({c},) or (M, {c})")
    members = scale.shape[0] if scale.ndim == 2 else 1
    if members < 1 or rows % members:
        raise ValueError(f"folded rows ({rows}) not divisible by the member count ({members}): "
                         f"a member's affine would reach another member's rows")
    return scale, bias, members
