"""The GroupNorm+activation backward kernel's plan, launch and C interface,
held to its CUDA source (``csrc/group_norm_act.cu``) on the CPU.

The backward runs one cluster an element, planned by the forward's planner
with x and dy both cached (``ops/cuda_groupnorm.py::backward_plan``), and
folds dscale and dbias into the same launch: the last cluster of each
member, elected by a per-member counter, adds the member's rows of the
partials in row order. These tests parse the source's limits and layout and
check every training site's plan against them, the single launch and the
one atomic, and the ctypes signature; the CPU path's gradients stay the
plain version's, which ``test_torch_port_backward.py`` holds to JAX.
"""

import ctypes
import math
import re
from pathlib import Path

import pytest
import torch

from diffuncertainty_tpu_torch.ops import _build
from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
from diffuncertainty_tpu_torch.ops.norm import num_groups_for
from diffuncertainty_tpu_torch.tools.groupnorm_sites import model_sites
from torch_threads import one_torch_thread  # noqa: F401

SRC = (Path(_build.CSRC) / "group_norm_act.cu").read_text()
BWD = SRC[SRC.index("// Backward."):]
LIMIT = int(re.search(r"kSmemLimit = (\d+)", SRC).group(1))
MAX_THREADS = int(re.search(r"kMaxThreads = (\d+)", SRC).group(1))
MAX_CLUSTER = int(re.search(r"kMaxCluster = (\d+)", SRC).group(1))
CHUNKS = int(re.search(r"kChunks = (\d+)", SRC).group(1))


def source_bwd_layout(cache_bytes: int, threads: int, v: int, c: int, groups: int) -> int:
    """``bwd_layout(...).total`` evaluated from the source's own lines."""
    body = re.search(r"inline BwdLayout bwd_layout\(.*?\{(.*?)return l;", SRC, re.S).group(1)
    rows = re.search(r"int part_rows\(int threads, int cv\) \{\s*return (.*?);", SRC, re.S).group(1)
    env = {"cache_bytes": cache_bytes, "threads": threads, "v": v, "c": c, "groups": groups,
           "kChunks": CHUNKS}
    env["part_rows"] = lambda threads, cv: eval(
        re.sub(r"(.+) \? (.+) : (.+)", r"(\2) if (\1) else (\3)", rows).replace("/", "//"),
        {}, {"threads": threads, "cv": cv})
    for name, expr in re.findall(r"l\.(\w+) = (.*?);", body):
        env[name] = eval(expr.replace("l.", "").replace("/", "//"), {}, env)
    return env["total"]


def check_plan(s: int, c: int, dtype: torch.dtype, rows: int) -> gn.Plan:
    """The backward plan for ``rows`` elements of ``s`` pixels and ``c``
    channels passes the source's launch checks (``configure_bwd``) and its
    shared memory, both caches included, is the source's layout."""
    v = gn.VECTOR_BYTES // gn.ELEMENT_BYTES[dtype]
    plan = gn.backward_plan(s, c, dtype, rows)
    assert plan == gn.cluster_plan(s, c, dtype, rows, backward=True)
    assert plan.cluster in (1, 2, 4, 8, MAX_CLUSTER) and rows * plan.cluster < 2 ** 31
    assert plan.slice_pix == -(-s // plan.cluster) and plan.slice_pix * plan.cluster >= s
    assert plan.threads % 32 == 0 and c // v <= plan.threads <= MAX_THREADS
    assert 0 <= plan.cache_pix <= plan.slice_pix
    cache = plan.cache_pix * c * gn.ELEMENT_BYTES[dtype]
    assert 2 * cache <= LIMIT
    assert plan.smem == source_bwd_layout(cache, plan.threads, v, c, num_groups_for(c))
    # three blocks an SM, unless the fixed arrays alone pass that (widths
    # whose groups are single channels, near 2048)
    assert plan.smem <= LIMIT and (plan.smem <= gn.THIRD_SMEM or plan.cache_pix == 0)
    assert (plan.mode == "resident") is (plan.cache_pix == plan.slice_pix)
    return plan


def training_sites() -> set[tuple]:
    """(shape without the batch, dtype) of every GroupNorm site of the
    softmax, SSN and prob-U-Net training forwards (the prob-U-Net's with
    its posterior encoder)."""
    return {(shape, dt) for model in ("softmax", "ssn", "prob_unet")
            for shape, dt, _ in model_sites(model, training=True)[0]}


SITES = sorted(training_sites())


@pytest.mark.parametrize("shape,dt", SITES)
def test_backward_plan_fits_the_source_at_every_training_site(shape, dt):
    """At batch 16 (the trainers'), 32 and 256 rows (member-folded stacks
    of 2 and 16 members) and 160 rows (ten folded members), the plan fits
    the source's limits; an element that 16 blocks three to an SM can hold
    is held whole (x and dy read from device memory once)."""
    s, c = math.prod(shape[:-1]), shape[-1]
    dtype = getattr(torch, dt)
    pix = 2 * c * gn.ELEMENT_BYTES[dtype]
    for rows in (16, 32, 160, 256):
        plan = check_plan(s, c, dtype, rows)
        threads = gn.block_threads(c, dtype, 256) or gn.block_threads(c, dtype)
        held = gn.fixed_smem(c, dtype, threads, backward=True) + -(-s // 16) * pix
        assert (plan.mode == "stream") is (held > gn.THIRD_SMEM)
        assert plan.mode == "resident" or (plan.cluster == 16 and plan.threads == threads)


@pytest.mark.parametrize("c", [8, 16, 24, 32, 48, 64])
def test_backward_plan_fits_the_source_at_the_studys_fp32_sites(c):
    """The study's fp32 nets (8-64 channels at 32x32, 16x16 and 8x8, batch
    8, the attention norm at 256 tokens) are resident everywhere."""
    for s in (1024, 256, 64):
        assert check_plan(s, c, torch.float32, 8).mode == "resident"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_plan_fits_the_source_at_every_width(dtype):
    """Every width the kernel takes, up to MAX_CHANNELS, at small and
    large elements: the plan passes the source's checks (at 2048 fp32
    channels the fixed arrays leave room for no cached pixel: all stream)."""
    v = gn.VECTOR_BYTES // gn.ELEMENT_BYTES[dtype]
    for c in range(v, gn.MAX_CHANNELS + 1, 8 * v):
        for s, rows in ((1, 1), (7, 3), (256, 16), (16384, 16)):
            check_plan(s, c, dtype, rows)


@pytest.mark.parametrize("c,dtype", [
    (8, torch.bfloat16), (96, torch.bfloat16), (1536, torch.bfloat16), (2048, torch.bfloat16),
    (8, torch.float32), (36, torch.float32), (1280, torch.float32), (2048, torch.float32),
])
def test_backward_fixed_smem_matches_source_layout(c, dtype):
    """``fixed_smem(..., backward=True)`` plus two caches is the source's
    ``bwd_layout`` total, which the C launch requires exactly."""
    v = gn.VECTOR_BYTES // gn.ELEMENT_BYTES[dtype]
    for threads in {gn.block_threads(c, dtype), gn.block_threads(c, dtype, 256)} - {None}:
        for cache_pix in (0, 3, 64):
            cache = cache_pix * c * gn.ELEMENT_BYTES[dtype]
            assert (source_bwd_layout(cache, threads, v, c, num_groups_for(c))
                    == gn.fixed_smem(c, dtype, threads, backward=True) + 2 * cache)


def test_backward_host_function_launches_once():
    """``launch_bwd`` makes one launch, the cluster kernel, and no other
    device work: no second reduce kernel, no fill, no copy."""
    body = re.search(r"cudaError_t launch_bwd\(.*?\n}\n", SRC, re.S).group(0)
    assert body.count("cudaLaunchKernelEx(") == 1 and "<<<" not in body
    assert re.search(r"cudaMemset|cudaMemcpy", body) is None
    assert "group_norm_affine_grad_kernel" not in SRC and "<<<" not in BWD
    # dscale and dbias lie in the one grads buffer before the rows' partials
    assert re.search(r"float\* dbias = dscale \+ members \* c;", body)
    assert re.search(r"float\* part_dbeta = part_dgamma \+ rows \* c;", body)


def test_backward_sums_no_float_with_atomics_and_resets_its_counter():
    """The only atomic adds 1 to an unsigned per-member counter; the member's
    dscale and dbias are sums in row order by the cluster that counted the
    last row, which sets the counter back to 0."""
    assert re.findall(r"\batomic\w*\s*\(", SRC) == ["atomicAdd("]
    assert "atomicAdd(&counters[member], 1u)" in BWD
    assert "unsigned* __restrict__ counters" in BWD
    elected = BWD[BWD.index("atomicAdd(&counters[member]"):]
    assert "for (long long r = r0; r < r0 + rows_per_member; ++r)" in elected
    assert "counters[member] = 0u;" in elected
    assert elected.index("__threadfence()") < elected.index("__syncthreads_or(")


def test_backward_caches_x_and_dy_with_the_forwards_bulk_copies():
    """Both inputs land in shared memory through cp.async.bulk on the
    chunks' mbarriers, one barrier a chunk of both; pass two reads the
    cache."""
    assert BWD.count("bulk_copy(xs + a * cv, xg + a * cv, bytes, &bars[i]);") == 1
    assert BWD.count("bulk_copy(gs + a * cv, gg + a * cv, bytes, &bars[i]);") == 1
    assert "mbar_expect(&bars[i], 2 * bytes);" in BWD
    assert re.search(r"input_grad<V, ACT>\(xs, gs, dg,", BWD)
    assert re.search(r"accumulate_grad<V, ACT>\(xs, gs,", BWD)


def _c_params(name: str) -> list[str]:
    sig = re.search(rf"int {name}\(([^)]*)\)", SRC).group(1)
    return [" ".join(p.split()[:-1]) for p in sig.replace("\n", " ").split(",")]


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "int*": ctypes.POINTER(ctypes.c_int)}


class _Fn:
    argtypes = None
    restype = None

    def __call__(self, *args):
        raise AssertionError("the library was called")


class _Lib:
    def __init__(self):
        for name in ("group_norm_act", "group_norm_act_clusters", "group_norm_act_backward",
                     "group_norm_act_backward_clusters"):
            setattr(self, name, _Fn())


@pytest.mark.parametrize("name", ["group_norm_act_backward", "group_norm_act_backward_clusters"])
def test_backward_ctypes_signature_matches_the_c_interface(monkeypatch, name):
    """``_library`` declares every backward function's arguments before any
    call, one ctypes type per C parameter in order: pointers and the stream
    as c_void_p, element counts as 64-bit."""
    lib = _Lib()
    monkeypatch.setattr(gn._build, "load", lambda source: lib)
    assert gn._library() is lib
    declared = getattr(lib, name).argtypes
    assert declared == [C_TYPES[t] for t in _c_params(name)]
    assert getattr(lib, name).restype is ctypes.c_int


def test_backward_args_ask_occupancy_once_and_raise_when_nothing_fits(monkeypatch):
    """The launch's arguments come from the plan once per shape; a plan of
    which no cluster fits the card raises rather than falls back."""
    asked = []

    def clusters(s, c, dtype, act, plan, device, backward=False):
        asked.append((s, c, plan, backward))
        return 0 if c == 64 else 3

    monkeypatch.setattr(gn, "max_active_clusters", clusters)
    gn._backward_args.cache_clear()
    try:
        args = gn._backward_args(4096, 32, torch.bfloat16, 16, 1, "silu", 0)
        assert gn._backward_args(4096, 32, torch.bfloat16, 16, 1, "silu", 0) == args
        plan = gn.backward_plan(4096, 32, torch.bfloat16, 16)
        assert asked == [(4096, 32, plan, True)]
        assert args == (gn.DTYPES[torch.bfloat16], gn.ACTS["silu"], 16, 4096, 32, 32, 16,
                        plan.cluster, plan.threads, plan.slice_pix, plan.cache_pix, plan.smem)
        assert len(args) + 9 + 3 == len(_c_params("group_norm_act_backward"))
        with pytest.raises(RuntimeError, match="no cluster"):
            gn._backward_args(4096, 64, torch.bfloat16, 32, 2, "silu", 0)
    finally:
        gn._backward_args.cache_clear()


@pytest.mark.parametrize("members", [0, 2])
def test_cpu_backward_reaches_the_plain_version(monkeypatch, members):
    """On the CPU the wrapper returns the plain version's gradients, bit for
    bit, in the affine's shape, without reaching the library or counting a
    launch; through autograd too."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(gn, "_library", no_library)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 6, 5, 32, generator=gen)
    lead = (members,) if members else ()
    scale = torch.randn(lead + (32,), generator=gen)
    bias = torch.randn(lead + (32,), generator=gen)
    gy = torch.randn(x.shape, generator=gen)
    y, mean, var = gn._forward(x, scale, bias, "silu", 1e-5, None, stats=True)
    gn.reset_launch_count()
    got = gn._backward(x, scale, bias, mean, var, gy, "silu", 1e-5)
    plain = gn.group_norm_act_backward_reference(x, scale, bias, mean, var, gy, "silu")
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert got[1].shape == scale.shape and got[2].shape == bias.shape
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    grads = torch.autograd.grad(gn.group_norm_act(*leaves, "silu"), leaves, gy)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    assert gn.launch_count() == gn.backward_launch_count() == 0
