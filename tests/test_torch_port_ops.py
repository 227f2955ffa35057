"""Port parity: attention (twin + kernel wrapper), GroupNorm, resampling.

Inputs come from numpy with a seed and go through the JAX op and its port.
Tolerances (float32 on the CPU):
- attention 2e-5, as the JAX package holds its own kernel to its twin
  (tests/test_pallas_ops.py);
- GroupNorm 1e-5; resampling is exact up to 1e-6.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.ops import attention as jattn
from diffuncertainty_tpu.ops import norm as jnorm
from diffuncertainty_tpu.ops import resample as jres
from diffuncertainty_tpu.ops.pallas_attention import _xla_qkv_attention, qkv_attention_fused
from diffuncertainty_tpu_torch.ops import _build
from diffuncertainty_tpu_torch.ops import cuda_attention as ca
from diffuncertainty_tpu_torch.ops.attention import qkv_attention
from diffuncertainty_tpu_torch.ops.norm import group_norm_32, num_groups_for
from diffuncertainty_tpu_torch.ops.resample import downsample_avgpool2x, upsample2x


@pytest.mark.parametrize("b,t,c,heads", [(2, 64, 64, 4), (2, 16, 256, 4), (1, 49, 96, 2)])
def test_attention_twin_matches_pallas_kernel_interpret(rng, b, t, c, heads):
    qkv = rng.standard_normal((b, t, 3 * c)).astype(np.float32)
    ref = qkv_attention_fused(jnp.asarray(qkv), heads, float(c // heads) ** -0.25, interpret=True)
    got = ca.qkv_attention_reference(torch.from_numpy(qkv), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("b,t,c,heads", [(2, 64, 64, 4), (3, 25, 128, 4)])
def test_attention_matches_jax_qkv_attention_fp32(rng, b, t, c, heads):
    qkv = rng.standard_normal((b, t, 3 * c)).astype(np.float32)
    ref = jattn.qkv_attention(jnp.asarray(qkv), heads)
    got = qkv_attention(torch.from_numpy(qkv), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_attention_twin_bf16_matches_jax_twin(rng):
    """bf16: the twin casts e to bf16 before PV, as the TPU kernel does; the
    JAX twin casts the normalized p instead. Both are bf16-rounded averages
    of v, so they agree to bf16 resolution (2^-7 relative + 4e-3)."""
    qkv = rng.standard_normal((2, 64, 192)).astype(np.float32)
    qb = torch.from_numpy(qkv).bfloat16()
    jq = jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(_xla_qkv_attention(jq, 4, 16 ** -0.25).astype(jnp.float32))
    got = ca.qkv_attention_reference(qb, 4).float().numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=4e-3, rtol=2 ** -7)


def test_cuda_wrapper_uses_twin_only_on_cpu(rng):
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 192)).astype(np.float32)).bfloat16()
    ca.reset_launch_count()
    out = ca.qkv_attention_cuda(qkv, 4)
    torch.testing.assert_close(out, ca.qkv_attention_reference(qkv, 4), atol=0, rtol=0)
    assert ca.launch_count() == 0  # the twin is not a launch
    with pytest.raises(ValueError, match="unsupported device"):
        ca.qkv_attention_cuda(torch.empty(2, 64, 192, dtype=torch.bfloat16, device="meta"), 4)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("t,ch,dtype,route", [
    (1024, 32, BF16, "kernel"), (256, 64, BF16, "kernel"), (1817, 32, BF16, "kernel"),
    (2048, 192, BF16, "kernel"), (49, 24, BF16, "kernel"), (1, 16, BF16, "kernel"),
    (4096, 128, BF16, "kernel"), (2049, 96, BF16, "kernel"), (64, 40, BF16, "raises"),
    (64, 256, BF16, "raises"), (64, 8, BF16, "raises"), (1024, 32, F32, "twin")])
def test_kernel_gate(t, ch, dtype, route):
    """K and V stream through shared memory in tiles, so every bf16 input of
    an instantiated head width reaches the kernel's launch, whatever T; any
    other width raises; fp32 takes the twin. On a ``meta`` tensor the wrapper
    gets past every check of the input and stops at the device."""
    qkv = torch.empty(2, t, 3 * 4 * ch, dtype=dtype, device="meta")
    if route == "twin":
        assert qkv_attention(qkv, 4).shape == (2, t, 4 * ch)
        return
    match = "unsupported device meta" if route == "kernel" else f"no head width {ch}"
    with pytest.raises(ValueError, match=match):
        qkv_attention(qkv, 4)


def test_kernel_source_matches_python_limits():
    """The head widths the wrapper checks are the ones the CUDA source
    instantiates, and its products and copies are the tensor-core and
    asynchronous ones."""
    src = (Path(_build.CSRC) / "qkv_attention.cu").read_text()
    cases = tuple(int(d) for d in re.findall(r"case (\d+):\s*\n\s*return launch<\1>\(", src))
    assert cases == ca.HEAD_DIMS
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cp.async.cg.shared.global" in src and "ldmatrix.sync.aligned" in src
    assert "extern \"C\"" in src and "cudaGetLastError()" in src


def test_build_names_library_by_source_hash_and_finds_nvcc(monkeypatch, tmp_path):
    path = _build._lib_path("qkv_attention")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libqkv_attention_")
    assert _build.sources() == ["group_norm_act", "qkv_attention"]
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    fake = tmp_path / "bin" / "nvcc"
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    assert _build.find_nvcc() == str(fake)


def test_ctypes_signature_is_declared_before_calls():
    """Pointers and the stream must go as c_void_p (64-bit), sizes as c_int."""
    import inspect

    src = inspect.getsource(ca._library)
    assert "ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int" in src
    assert ctypes.sizeof(ctypes.c_void_p) == 8


@pytest.mark.parametrize("shape", [(2, 6, 6, 32), (2, 5, 7, 48), (3, 49, 64), (2, 4, 4, 2)])
def test_group_norm_matches_jax(rng, shape):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    ref = jnorm.group_norm_32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = group_norm_32(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert num_groups_for(c) == jnorm.num_groups_for(c)


def test_group_norm_keeps_bf16_output_dtype(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4, 4, 64)).astype(np.float32)).bfloat16()
    out = group_norm_32(x, torch.ones(64), torch.zeros(64))
    assert out.dtype == torch.bfloat16


def test_resample_matches_jax(rng):
    x = rng.standard_normal((2, 6, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(upsample2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jres.upsample2x(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(downsample_avgpool2x(torch.from_numpy(x)).numpy(),
                               np.asarray(jres.downsample_avgpool2x(jnp.asarray(x))), atol=1e-6)
