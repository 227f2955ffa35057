"""Port parity: the GroupNorm+activation kernel's twin, its limits, and the
DiffUnet's use of it.

The twin runs against the JAX package's Pallas kernel in interpret mode on
the same numpy inputs, at the JAX package's own kernel tolerance, 2e-6
(tests/test_pallas_ops.py). The CUDA kernel itself needs the card; its
limits, which the wrapper mirrors in Python, are pinned to the source here.
"""

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
    (20, torch.bfloat16, None), (1000, torch.bfloat16, None), (64, torch.float16, None),
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
    assert int(re.search(r"kMaxChannels = (\d+)", SRC).group(1)) == gn.MAX_CHANNELS
    vec = dict(re.findall(r"struct VecOf<(\w+)> \{\s*static constexpr int N = (\d+);", SRC))
    assert {k: int(v) for k, v in vec.items()} == {"float": 4, "__nv_bfloat16": 8}
    assert all(int(n) * {"float": 4, "__nv_bfloat16": 2}[k] == gn.VECTOR_BYTES
               for k, n in vec.items())
    acts = dict(re.findall(r"k(None|Silu|Relu) = (\d)", SRC))
    assert {k.lower(): int(v) for k, v in acts.items()} == gn.ACTS
    dtypes = re.findall(r"case (\d):\s*\n\s*return launch<([\w_]+)>", SRC)
    assert {int(k): v for k, v in dtypes} == {0: "float", 1: "__nv_bfloat16"}
    assert gn.DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    assert "threads % 32 != 0 || threads % (c / V) != 0" in SRC
    assert "extern \"C\"" in SRC and "cudaGetLastError()" in SRC


def test_ctypes_signature_is_declared_before_calls():
    """Pointers and the stream go as c_void_p; the element counts as 64-bit."""
    import inspect

    src = inspect.getsource(gn._library)
    assert "ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p" in src
    assert "ctypes.c_longlong, ctypes.c_longlong" in src
    c_sig = re.search(r"int group_norm_act\(([^)]*)\)", SRC).group(1)
    assert c_sig.count("void*") == 5 and c_sig.count("long long") == 2


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


def norm_widths_of(network: str, hw: int) -> list[int]:
    """The width of every GroupNorm in one softmax forward of the JAX
    package's network at hw x hw, traced with ``jax.eval_shape`` (no compute)."""
    cfg = j_load_config(network=network, model="softmax", eu_method="none")
    built = j_build_model(cfg)
    widths = []

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, junet.GroupNorm32):
            widths.append(args[0].shape[-1])
        return next_fun(*args, **kwargs)

    x = jnp.zeros((1, hw, hw, cfg.network.in_channels))
    with nn.intercept_methods(record):
        jax.eval_shape(lambda: built.module.init(jax.random.key(0), x))
    return widths


@pytest.fixture(scope="module")
def norm_widths():
    """Every GroupNorm width of one forward of each DiffUnet config at 128 px."""
    return {net: norm_widths_of(net, 128) for net in ("unet4", "unet16", "unet64", "unet256")}


def test_kernel_takes_every_network_norm_width_but_unet256s_widest(norm_widths):
    """The kernel takes every width up to 1024 channels the networks give,
    in bf16 and fp32; unet256's decoder concatenates 1280 and 1536 channels,
    which it does not take yet (the port does not build unet256, and on the
    card the wrapper raises there). unet16's 56 sites all take the kernel."""
    rejected = {}
    for net, widths in norm_widths.items():
        for c in sorted(set(widths)):
            for dtype in (torch.bfloat16, torch.float32):
                if not gn.kernel_supports(c, dtype):
                    rejected.setdefault(net, set()).add((c, dtype))
    assert rejected == {"unet256": {(c, dt) for c in (1280, 1536)
                                    for dt in (torch.bfloat16, torch.float32)}}
    assert len(norm_widths["unet16"]) == 56
    assert all(gn.kernel_supports(c, torch.bfloat16) for c in norm_widths["unet16"])
    assert max(norm_widths["unet256"]) == 1536 and len(norm_widths["unet256"]) == 94


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
