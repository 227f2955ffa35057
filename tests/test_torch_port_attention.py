"""Port parity and contract of the fused-qkv attention kernel at every head
width the repo's networks use.

The CUDA kernel needs the card (``chip_smoke.py`` holds it to its twin
there); here its twin runs against the JAX package's Pallas kernel in
interpret mode on the same numpy inputs, and the shapes, the gate and the
wrapper's checks are pinned. Tolerances: float32 2e-5, as the JAX package
holds its own kernel to its twin (tests/test_pallas_ops.py); bf16 the card's
rule |d| <= 4e-3 + 2^-7 |ref|, one bf16 step of the output, since the two
sum in f32 in other orders before the final rounding.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.models import unet as junet
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.ops.pallas_attention import qkv_attention_fused
from diffuncertainty_tpu_torch.ops import attention as tattn
from diffuncertainty_tpu_torch.ops import cuda_attention as ca
from torch_threads import one_torch_thread  # noqa: F401

HEADS = 4


def attention_sites_of(network: str, model: str, hw: int) -> list[tuple[int, int, int]]:
    """(T, C, heads) of every attention block in one forward of the JAX
    package's network at hw x hw, traced with ``jax.eval_shape`` (no compute)."""
    cfg = j_load_config(network=network, model=model, eu_method="none")
    built = j_build_model(cfg)
    attn = []

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, junet.AttentionBlock):
            x = args[0]
            attn.append((x.shape[1] * x.shape[2], x.shape[-1], context.module.num_heads))
        return next_fun(*args, **kwargs)

    cin = cfg.network.in_channels + (cfg.network.out_channels if model == "diffusion" else 0)
    x = jnp.zeros((1, hw, hw, cin))
    extra = (jnp.zeros((1,)),) if model == "diffusion" else ()
    with nn.intercept_methods(record):
        jax.eval_shape(lambda: built.module.init(jax.random.key(0), x, *extra))
    return attn


def _qkv(seed: int, b: int, t: int, ch: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, t, 3 * HEADS * ch)).astype(np.float32)


@pytest.mark.parametrize("t", [49, 80])
@pytest.mark.parametrize("ch", ca.HEAD_DIMS)
def test_twin_matches_pallas_kernel_interpret_at_every_head_width(ch, t):
    """Ragged token counts: 49 is under one 64-key tile, 80 one tile and a
    ragged second."""
    qkv = _qkv(ch + t, 2, t, ch)
    ref = qkv_attention_fused(jnp.asarray(qkv), HEADS, float(ch) ** -0.25, interpret=True)
    got = ca.qkv_attention_reference(torch.from_numpy(qkv), HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("ch", ca.HEAD_DIMS)
def test_twin_bf16_matches_pallas_kernel_interpret_at_every_head_width(ch):
    """bf16: both cast e to bf16 against the final row max before PV and
    divide by the f32 row sum after it."""
    qb = torch.from_numpy(_qkv(ch, 2, 80, ch)).bfloat16()
    ref = qkv_attention_fused(jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16), HEADS,
                              float(ch) ** -0.25, interpret=True)
    got = ca.qkv_attention_reference(qb, HEADS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=4e-3, rtol=2 ** -7)


@pytest.fixture(scope="module")
def attention_sites():
    sites = {}
    for network in ("unet4", "unet16", "unet64", "unet256"):
        for hw in (64, 128):
            sites[(network, hw)] = attention_sites_of(network, "softmax", hw)
    sites[("prob_unet", 128)] = attention_sites_of("unet16", "prob_unet", 128)
    return sites


def test_every_network_attention_site_goes_to_the_kernel(attention_sites):
    widths = {}
    for key, sites in attention_sites.items():
        assert sites, key
        for t, c, heads in sites:
            ch = c // heads
            assert heads == HEADS and ch in ca.HEAD_DIMS, (key, t, c)
            widths.setdefault(ch, set()).add(key[0])
    # the instantiated widths are exactly the networks' widths
    assert set(widths) == set(ca.HEAD_DIMS)
    assert widths[24] == widths[48] == {"prob_unet"}
    assert sorted(attention_sites[("unet16", 128)]) == [(256, 256, 4)] * 6 + [(1024, 128, 4)] * 5


def test_gate_sends_every_bf16_input_to_the_kernel(monkeypatch):
    """bf16 at any T -> the kernel's wrapper (it streams K and V, so the
    Pallas kernel's 2048-token budget is no limit here); fp32 -> the twin,
    as the JAX package keeps fp32 on XLA."""
    calls = []
    monkeypatch.setattr(tattn, "qkv_attention_cuda", lambda q, h: calls.append("kernel"))
    monkeypatch.setattr(tattn, "qkv_attention_reference", lambda q, h: calls.append("twin"))
    for t, dtype in ((1, torch.bfloat16), (2048, torch.bfloat16), (2049, torch.bfloat16),
                     (4100, torch.bfloat16), (1024, torch.float32)):
        tattn.qkv_attention(torch.empty(1, t, 3 * HEADS * 32, dtype=dtype, device="meta"), HEADS)
    assert calls == ["kernel", "kernel", "kernel", "kernel", "twin"]


@pytest.mark.parametrize("ch", [8, 40, 256])
def test_wrapper_raises_on_a_head_width_the_kernel_lacks(monkeypatch, ch):
    """A bf16 tensor off the CPU with an uninstantiated head width raises
    before any build or launch, so no such tensor silently takes the twin."""

    def no_launch():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(ca, "_library", no_launch)
    qkv = torch.empty(2, 64, 3 * HEADS * ch, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=f"no head width {ch}"):
        ca.qkv_attention_cuda(qkv, HEADS)
    with pytest.raises(ValueError, match=f"no head width {ch}"):
        tattn.qkv_attention(qkv, HEADS)
    assert ca.launch_count() == 0
