"""Port parity: the GroupNorm+activation kernel's twin, its limits, its
cluster plan, and the DiffUnet's use of it.

The twin runs against the JAX package's Pallas kernel in interpret mode on
the same numpy inputs, at the JAX package's own kernel tolerance, 2e-6
(tests/test_pallas_ops.py). The CUDA kernel itself needs the card; its
limits and shared-memory layout, which the wrapper mirrors in Python, are
pinned to the source here, and the plan that picks each launch's cluster is
pinned at every norm site of unet16 and at unet256's widest.
"""

import math
import re
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.models import unet as junet
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.ops.norm import group_norm_32 as j_group_norm_32
from diffuncertainty_tpu.ops.pallas_groupnorm import fused_group_norm_act
from diffuncertainty_tpu_torch.core.config import load_config
from diffuncertainty_tpu_torch.models import unet as tunet
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.ops import _build
from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
from diffuncertainty_tpu_torch.tools.groupnorm_sites import norm_sites

SRC = (Path(_build.CSRC) / "group_norm_act.cu").read_text()


def _inputs(rng, shape):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    return x, rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)


@pytest.mark.parametrize("act", ["silu", "relu", "none"])
@pytest.mark.parametrize("shape", [(2, 6, 6, 32), (2, 6, 6, 48), (2, 6, 6, 64), (3, 49, 32)])
def test_twin_matches_pallas_kernel_interpret(rng, shape, act):
    x, s, b = _inputs(rng, shape)
    ref = fused_group_norm_act(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), act=act,
                               interpret=True)
    got = gn.group_norm_act_reference(torch.from_numpy(x), torch.from_numpy(s),
                                      torch.from_numpy(b), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


def test_twin_bf16_matches_pallas_kernel_interpret(rng):
    """bf16: both take the statistics and the SiLU in f32 and round once at
    the end, so they agree to one bf16 step (2^-7 relative + 4e-3)."""
    x, s, b = _inputs(rng, (2, 8, 8, 64))
    xb = torch.from_numpy(x).bfloat16()
    ref = fused_group_norm_act(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                               jnp.asarray(s), jnp.asarray(b), act="silu", interpret=True)
    got = gn.group_norm_act_reference(xb, torch.from_numpy(s), torch.from_numpy(b), "silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=4e-3, rtol=2 ** -7)


def test_wrapper_uses_twin_only_on_cpu(rng):
    x, s, b = (torch.from_numpy(a) for a in _inputs(rng, (2, 4, 4, 64)))
    gn.reset_launch_count()
    for act in gn.ACTS:
        torch.testing.assert_close(gn.group_norm_act(x, s, b, act),
                                   gn.group_norm_act_reference(x, s, b, act), atol=0, rtol=0)
    assert gn.launch_count() == 0  # the twin is not a launch
    with pytest.raises(ValueError, match="unsupported device"):
        gn.group_norm_act(torch.empty(2, 4, 4, 64, device="meta"), s, b)
    with pytest.raises(ValueError, match="unsupported activation"):
        gn.group_norm_act(x, s, b, "gelu")


@pytest.mark.parametrize("c,dtype,threads", [
    (32, torch.bfloat16, 512), (96, torch.bfloat16, 480), (384, torch.bfloat16, 480),
    (512, torch.bfloat16, 512), (1024, torch.bfloat16, 512), (32, torch.float32, 512),
    (36, torch.float32, 288), (1024, torch.float32, 512), (1025, torch.float32, None),
    (20, torch.bfloat16, None), (1000, torch.bfloat16, 512), (64, torch.float16, None),
])
def test_block_threads(c, dtype, threads):
    assert gn.block_threads(c, dtype) == threads
    assert gn.kernel_supports(c, dtype) is (threads is not None)


def test_unet16_channels_all_fit_the_kernel():
    """Every channel count of unet16 (model_channels 32, mult 1,2,4,8, concat
    skips) gives a block whose threads see fixed channels."""
    for c in (32, 64, 96, 128, 192, 256, 384, 512):
        for dtype in (torch.bfloat16, torch.float32):
            t = gn.block_threads(c, dtype)
            per_vec = gn.VECTOR_BYTES // torch.empty((), dtype=dtype).element_size()
            assert t is not None and t % 32 == 0 and t % (c // per_vec) == 0, (c, dtype)


def test_kernel_source_matches_python_limits():
    assert int(re.search(r"kMaxThreads = (\d+)", SRC).group(1)) == gn.MAX_THREADS
    assert int(re.search(r"kMaxChannels = (\d+)", SRC).group(1)) == gn.MAX_CHANNELS >= 1536
    assert int(re.search(r"kMaxCluster = (\d+)", SRC).group(1)) == max(gn.CLUSTER_SIZES) == 16
    assert int(re.search(r"kSmemLimit = (\d+)", SRC).group(1)) == gn.SMEM_LIMIT == 227 * 1024
    assert int(re.search(r"kChunks = (\d+)", SRC).group(1)) == gn.CHUNKS
    vec = dict(re.findall(r"struct VecOf<(\w+)> \{\s*static constexpr int N = (\d+);", SRC))
    assert {k: int(v) for k, v in vec.items()} == {"float": 4, "__nv_bfloat16": 8}
    assert all(int(n) * {"float": 4, "__nv_bfloat16": 2}[k] == gn.VECTOR_BYTES
               for k, n in vec.items())
    acts = dict(re.findall(r"k(None|Silu|Relu) = (\d)", SRC))
    assert {k.lower(): int(v) for k, v in acts.items()} == gn.ACTS
    dtypes = re.findall(r"case (\d):\s*\n\s*return launch<([\w_]+)>", SRC)
    assert {int(k): v for k, v in dtypes} == {0: "float", 1: "__nv_bfloat16"}
    assert gn.DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    assert "threads % 32 != 0 || threads < c / V" in SRC
    assert "cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||" in SRC
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in SRC
    assert "extern \"C\"" in SRC and "cudaGetLastError()" in SRC


def _source_smem_layout(cache_bytes: int, threads: int, v: int, c: int, groups: int) -> int:
    """``smem_layout(...).total`` evaluated from the source's own lines."""
    body = re.search(r"inline Layout smem_layout\(.*?\{(.*?)return l;", SRC, re.S).group(1)
    rows = re.search(r"int part_rows\(int threads, int cv\) \{\s*return (.*?);", SRC, re.S).group(1)
    env = {"cache_bytes": cache_bytes, "threads": threads, "v": v, "c": c, "groups": groups,
           "kChunks": gn.CHUNKS}
    env["part_rows"] = lambda threads, cv: eval(
        re.sub(r"(.+) \? (.+) : (.+)", r"(\2) if (\1) else (\3)", rows).replace("/", "//"),
        {}, {"threads": threads, "cv": cv})
    for name, expr in re.findall(r"l\.(\w+) = (.*?);", body):
        env[name] = eval(expr.replace("l.", "").replace("/", "//"), {}, env)
    return env["total"]


@pytest.mark.parametrize("c,dtype", [
    (8, torch.bfloat16), (32, torch.bfloat16), (96, torch.bfloat16), (192, torch.bfloat16),
    (1000, torch.bfloat16), (1536, torch.bfloat16), (2048, torch.bfloat16),
    (8, torch.float32), (36, torch.float32), (256, torch.float32), (384, torch.float32),
    (1280, torch.float32), (2048, torch.float32),
])
def test_fixed_smem_matches_source_layout(c, dtype):
    """The plan's shared-memory size is the source's ``smem_layout`` total,
    which the C launch requires exactly."""
    v = gn.VECTOR_BYTES // gn.ELEMENT_BYTES[dtype]
    groups = gn.num_groups_for(c)
    for threads in {gn.block_threads(c, dtype), gn.block_threads(c, dtype, 256)} - {None}:
        for cache_pix in (0, 3, 64):
            cache = cache_pix * c * gn.ELEMENT_BYTES[dtype]
            assert (_source_smem_layout(cache, threads, v, c, groups)
                    == gn.fixed_smem(c, dtype, threads) + cache)


def test_ctypes_signature_is_declared_before_calls():
    """Pointers and the stream go as c_void_p; the element counts as 64-bit."""
    import inspect

    src = inspect.getsource(gn._library)
    assert "ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p" in src
    assert "ctypes.c_longlong, ctypes.c_longlong" in src
    c_sig = re.search(r"int group_norm_act\(([^)]*)\)", SRC).group(1)
    assert c_sig.count("void*") == 5 and c_sig.count("long long") == 2
    q_sig = re.search(r"int group_norm_act_clusters\(([^)]*)\)", SRC).group(1)
    assert q_sig.count("long long") == 1 and q_sig.count("int*") == 1
    assert "ctypes.POINTER(ctypes.c_int)" in src


@pytest.mark.parametrize("model", ["softmax", "diffusion"])
def test_diffunet_calls_group_norm_act_at_all_56_sites(monkeypatch, model):
    """Full-width unet16 at 32x32: every GroupNorm goes through
    ``group_norm_act`` with a contiguous channels-last input; SiLU is fused
    at the 44 ResBlock norms and the head, none at the 11 attention norms."""
    calls = []

    def counting(x, scale, bias, act="silu", **kw):
        calls.append((tuple(x.shape), x.dtype, act, x.is_contiguous()))
        return gn.group_norm_act(x, scale, bias, act, **kw)

    monkeypatch.setattr(tunet, "group_norm_act", counting)
    eu = "dropout" if model == "softmax" else "none"
    built = build_model(load_config(model=model, eu_method=eu, precision="bf16"), device="cpu")
    n_modules = sum(isinstance(m, tunet.GroupNorm32) for m in built.module.modules())
    x = torch.randn(2, 32, 32, built.module.input_conv.weight.shape[1])
    kw = {"timesteps": torch.tensor([0.3, 0.7])} if model == "diffusion" else {}
    with torch.no_grad():
        built.module(x, torch.Generator().manual_seed(0), **kw)
    assert len(calls) == n_modules == 56
    assert sum(act == "silu" for _, _, act, _ in calls) == 45
    assert sum(act == "none" for _, _, act, _ in calls) == 11
    assert all(contig for *_, contig in calls)
    assert [dt for _, dt, _, _ in calls].count(torch.float32) == 1  # the head, on f32 features
    assert calls[-1][:3] == ((2, 32, 32, 32), torch.float32, "silu")


@pytest.mark.parametrize("model,n_sites,n_attention", [("ssn", 58, 11), ("prob_unet", 81, 16)])
def test_ssn_and_prob_unet_call_group_norm_act_at_all_their_sites(monkeypatch, model, n_sites,
                                                                  n_attention):
    """Full-width bf16 SSN and prob-U-Net at 32x32: every GroupNorm goes
    through ``group_norm_act`` with a contiguous channels-last input, SiLU
    fused everywhere but at the attention norms; the float32 ones are the
    heads on f32 features (out, ssn_cov, ssn_factor; the base's out)."""
    calls = []

    def counting(x, scale, bias, act="silu", **kw):
        calls.append((tuple(x.shape), x.dtype, act, x.is_contiguous()))
        return gn.group_norm_act(x, scale, bias, act, **kw)

    monkeypatch.setattr(tunet, "group_norm_act", counting)
    built = build_model(load_config(model=model, eu_method="none", precision="bf16"),
                        device="cpu")
    with torch.no_grad():
        built.module(torch.randn(2, 32, 32, 3))
    assert len(calls) == n_sites
    assert sum(act == "none" for _, _, act, _ in calls) == n_attention
    assert sum(act == "silu" for _, _, act, _ in calls) == n_sites - n_attention
    assert all(contig for *_, contig in calls)
    heads = [c for c in calls if c[1] == torch.float32]
    assert heads == [((2, 32, 32, 32), torch.float32, "silu", True)] * (
        3 if model == "ssn" else 1)


def jax_norm_sites(network: str, hw: int, model: str = "softmax") -> list[tuple]:
    """(shape without batch, dtype name) of every GroupNorm in one bf16
    forward of the JAX package's ``network`` for ``model`` at hw x hw (for
    the prob-U-Net: the base, then the prior encoder), in call order, traced
    with ``jax.eval_shape`` (no compute)."""
    cfg = j_load_config(network=network, model=model, eu_method="none",
                        overrides=["trainer.precision=bf16"])
    module = j_build_model(cfg).module
    sites = []

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, junet.GroupNorm32):
            sites.append((tuple(args[0].shape[1:]), str(args[0].dtype)))
        return next_fun(*args, **kwargs)

    x = jnp.zeros((1, hw, hw, cfg.network.in_channels))
    with nn.intercept_methods(record):
        jax.eval_shape(lambda: module.init(jax.random.key(0), x))
    return sites


def norm_shapes_of(network: str, hw: int) -> list[tuple]:
    """The input shape, without the batch, of every GroupNorm in one softmax
    forward of the JAX package's network at hw x hw."""
    return [shape for shape, _ in jax_norm_sites(network, hw)]


def norm_widths_of(network: str, hw: int) -> list[int]:
    """The width of every GroupNorm in one softmax forward at hw x hw."""
    return [shape[-1] for shape in norm_shapes_of(network, hw)]


@pytest.fixture(scope="module")
def norm_widths():
    """Every GroupNorm width of one forward of each DiffUnet config at 128 px."""
    return {net: norm_widths_of(net, 128) for net in ("unet4", "unet16", "unet64", "unet256")}


def test_kernel_takes_every_network_norm_width_but_unet256s_widest(norm_widths):
    """The kernel takes every width the networks give, in bf16 and fp32, up
    to and with unet256's decoder concatenations of 1280 and 1536 channels
    (the name dates from when the kernel stopped at 1024)."""
    for net, widths in norm_widths.items():
        for c in sorted(set(widths)):
            for dtype in (torch.bfloat16, torch.float32):
                assert gn.kernel_supports(c, dtype), (net, c, dtype)
    assert len(norm_widths["unet16"]) == 56
    assert max(norm_widths["unet256"]) == 1536 and len(norm_widths["unet256"]) == 94
    assert {1280, 1536} <= set(norm_widths["unet256"])


@pytest.mark.parametrize("act", ["none", "silu"])
def test_group_norm_32_gives_the_jax_result_at_1536_channels(rng, act):
    """unet256's widest norm, on the CPU (where the wrapper runs the twin and
    launches nothing), gives the JAX ``group_norm_32`` result."""
    x, s, b = _inputs(rng, (2, 4, 4, 1536))
    norm = tunet.GroupNorm32(1536, act=act)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(s))
        norm.bias.copy_(torch.from_numpy(b))
    gn.reset_launch_count()
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    assert gn.launch_count() == 0
    ref = j_group_norm_32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    if act == "silu":
        ref = jax.nn.silu(ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# The distinct GroupNorm input shapes (without the batch) of one unet16 forward
# at 128x128: 19 in bf16 on the bf16 paths, and the head's (128, 128, 32) also
# in fp32. unet256's norms wider than 1024 channels at 128x128 follow.
UNET16_SITES = [
    (1024, 128), (256, 256), (128, 128, 32), (128, 128, 64), (128, 128, 96), (64, 64, 32),
    (64, 64, 64), (64, 64, 96), (64, 64, 128), (64, 64, 192), (32, 32, 64), (32, 32, 128),
    (32, 32, 192), (32, 32, 256), (32, 32, 384), (16, 16, 128), (16, 16, 256), (16, 16, 384),
    (16, 16, 512),
]
UNET256_WIDE_SITES = [(8, 8, 1280), (8, 8, 1536), (16, 16, 1280)]
# The SSN's sites are unet16's. The prob-U-Net's (widths scaled by 0.75 to
# 32/64/96/192) that unet16 lacks, among them the decoder concatenations of
# 160 and 288 channels; its call runs at 16 rows.
PROB_UNET_SITES = [
    (1024, 96), (256, 192), (64, 64, 160), (32, 32, 96), (32, 32, 160), (32, 32, 288),
    (16, 16, 96), (16, 16, 192), (16, 16, 288),
]
# the sites whose element 16 blocks of two to an SM do not hold: streamed in part
STREAMED = {((128, 128, 32), torch.float32), ((128, 128, 64), torch.bfloat16),
            ((128, 128, 64), torch.float32), ((128, 128, 96), torch.bfloat16),
            ((128, 128, 96), torch.float32), ((64, 64, 128), torch.float32),
            ((64, 64, 192), torch.float32), ((64, 64, 160), torch.float32)}


def test_site_lists_are_the_networks():
    """The site lists above, and ``norm_sites(model)`` (which ``chip_smoke.py``
    checks the kernel at): every GroupNorm call of the softmax, SSN and
    prob-U-Net forwards, in order, with the JAX models' shapes and dtypes."""
    assert set(norm_shapes_of("unet16", 128)) == set(UNET16_SITES)
    wide = {shape for shape in norm_shapes_of("unet256", 128) if shape[-1] > 1024}
    assert wide == set(UNET256_WIDE_SITES)
    sites = {model: norm_sites(model) for model in ("softmax", "ssn", "prob_unet")}
    for model, n in (("softmax", 56), ("ssn", 58), ("prob_unet", 81)):
        assert [(shape, dt) for shape, dt, _ in sites[model]] == jax_norm_sites("unet16", 128,
                                                                            model)
        assert len(sites[model]) == n
        assert [dt for _, dt, _ in sites[model]].count("float32") == (3 if model == "ssn" else 1)
    assert {shape for shape, _, _ in sites["ssn"]} == set(UNET16_SITES)
    assert {shape for shape, _, _ in sites["prob_unet"]} - set(UNET16_SITES) == set(
        PROB_UNET_SITES)


@pytest.mark.parametrize("rows", [256, 16])
@pytest.mark.parametrize("shape", UNET16_SITES + UNET256_WIDE_SITES + PROB_UNET_SITES)
def test_cluster_plan_at_network_sites(shape, rows):
    """One cluster per batch element: K a cluster size, each block's slice
    of whole pixels within the shared-memory budget, held whole (read once)
    unless even 16 blocks of two to an SM cannot hold the element, at least
    FILL_BLOCKS blocks unless K is already 16, and no smaller cluster that
    would hold the slices at the same budget."""
    s, c = math.prod(shape[:-1]), shape[-1]
    for dtype in (torch.bfloat16, torch.float32):
        plan = gn.cluster_plan(s, c, dtype, rows)
        pix = c * gn.ELEMENT_BYTES[dtype]
        fixed = gn.fixed_smem(c, dtype, plan.threads)
        assert plan.cluster in gn.CLUSTER_SIZES
        assert plan.threads in (gn.block_threads(c, dtype), gn.block_threads(c, dtype, 256))
        assert plan.slice_pix == -(-s // plan.cluster)
        assert (plan.cluster - 1) * plan.slice_pix < s  # no block without pixels
        assert plan.smem == fixed + plan.cache_pix * pix <= gn.PAIR_SMEM < gn.SMEM_LIMIT
        assert plan.cluster == 16 or rows * plan.cluster >= gn.FILL_BLOCKS
        narrow = gn.block_threads(c, dtype, 256) or gn.block_threads(c, dtype)
        held = gn.fixed_smem(c, dtype, narrow) + -(-s // 16) * pix
        assert (plan.mode == "stream") is (held > gn.PAIR_SMEM)
        assert plan.threads == (narrow if plan.mode == "resident" else gn.block_threads(c, dtype))
        assert (plan.mode == "stream") is ((shape, dtype) in STREAMED)
        if plan.mode == "resident":
            assert plan.cache_pix == plan.slice_pix  # read from device memory once
            budget = gn.THIRD_SMEM if plan.smem <= gn.THIRD_SMEM else gn.PAIR_SMEM
            smaller = [k for k in gn.CLUSTER_SIZES if k < plan.cluster
                       and fixed + -(-s // k) * pix <= budget]
            assert not smaller or rows * smaller[-1] < gn.FILL_BLOCKS
        else:
            assert plan.cluster == 16 and 0 < plan.cache_pix < plan.slice_pix
            # on the bf16 paths (bf16, and the head's fp32), the part that all
            # blocks, two to an SM, read twice fits the 50 MB L2
            if dtype == torch.bfloat16 or shape == (128, 128, 32):
                assert 2 * gn.SMS * (plan.slice_pix - plan.cache_pix) * pix < 50e6


def test_cluster_plan_rejects_what_the_kernel_does_not_take():
    assert gn.cluster_plan(64, 2056, torch.float32, 4) is None  # past MAX_CHANNELS
    assert gn.cluster_plan(64, 20, torch.bfloat16, 4) is None  # not whole 16-byte packets
    assert gn.cluster_plan(64, 64, torch.float16, 4) is None
    assert gn.cluster_plan(1, 32, torch.bfloat16, 1).cluster == 1  # a one-pixel element
