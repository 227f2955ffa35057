"""The plain twins of the two backward kernels (``csrc/qkv_attention.cu``'s
and ``csrc/group_norm_act.cu``'s backward), what the autograd forwards save
for them, and the limits the wrappers declare for the CUDA side.

The kernels need the card (``chip_smoke.py`` holds them there to fp32
autograd of the twins and to these plain versions). Here each plain backward
runs on the CPU from the statistics its Function's forward saves, against
``jax.vjp`` of the JAX package's function in float32 at the tolerance the
port holds fp32 parity to (atol 1e-5, rtol 1e-4): the attention's XLA twin
``pallas_attention.py::_xla_qkv_attention`` (the function its ``custom_vjp``
differentiates) and ``ops/norm.py::group_norm_32`` followed by the
activation (what the JAX package trains on). Against float64 autograd of the
port's own twins they agree to 1e-10: the same closed form, only the twin's
exactly-zero gradient through the attention's row max left out. The
GroupNorm one takes the twin's derivative in autograd's own order and equals
autograd of the twin bit for bit (the CPU trainers' parity with JAX rests on
the rounding of gradients that are exactly 0).
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.ops.norm import group_norm_32 as j_group_norm_32
from diffuncertainty_tpu.ops.pallas_attention import _xla_qkv_attention
from diffuncertainty_tpu_torch.ops import _build
from diffuncertainty_tpu_torch.ops import cuda_attention as ca
from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
from diffuncertainty_tpu_torch.ops.norm import num_groups_for
from diffuncertainty_tpu_torch.tools.groupnorm_sites import norm_sites
from torch_threads import one_torch_thread  # noqa: F401

HEADS = 4
ATTN_SRC = (Path(_build.CSRC) / "qkv_attention.cu").read_text()
NORM_SRC = (Path(_build.CSRC) / "group_norm_act.cu").read_text()
J_ACTS = {"silu": jax.nn.silu, "relu": jax.nn.relu, "none": lambda y: y}


def attention_inputs(seed: int, d: int, t: int, b: int = 2):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, t, 3 * HEADS * d)).astype(np.float32)
    return qkv, rng.standard_normal((b, t, HEADS * d)).astype(np.float32)


def plain_attention_grad(qkv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain backward from what the autograd forward saves."""
    out, m, lsum = ca._forward(qkv, HEADS, stats=True)
    return ca.qkv_attention_backward_reference(qkv, out, m, lsum, g, HEADS)


@pytest.mark.parametrize("t", [12, 70])
@pytest.mark.parametrize("d", [16, 24, 32, 64])
def test_plain_attention_backward_matches_jax_vjp(d, t):
    """T = 12 is under one 64-key tile, 70 one tile and a ragged second."""
    qkv, g = attention_inputs(10 * d + t, d, t)
    _, vjp = jax.vjp(lambda x: _xla_qkv_attention(x, HEADS, d ** -0.25), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(g))
    got = plain_attention_grad(torch.from_numpy(qkv), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("t", [12, 70])
@pytest.mark.parametrize("d", [16, 24, 48])
def test_plain_attention_backward_equals_float64_autograd_of_the_twin(d, t):
    qkv, g = (torch.from_numpy(a).double() for a in attention_inputs(d + t, d, t))
    x = qkv.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(ca.qkv_attention_reference(x, HEADS), x, g)
    torch.testing.assert_close(plain_attention_grad(qkv, g), ref, atol=1e-10, rtol=1e-10)


def test_attention_forward_saves_the_twins_row_statistics():
    """m is each row's max of the scaled scores and l its sum of exp(s - m),
    both (B, H, T) float32, computed here from the twin's formulas by hand;
    the output is the twin's, bit for bit."""
    qkv, _ = attention_inputs(3, 32, 70)
    x = torch.from_numpy(qkv)
    out, m, lsum = ca._forward(x, HEADS, stats=True)
    q = x.view(2, 70, HEADS, 96)[..., :32].transpose(1, 2).double()
    k = x.view(2, 70, HEADS, 96)[..., 32:64].transpose(1, 2).double()
    s = q @ k.transpose(-1, -2) * (32 ** -0.25) ** 2
    assert m.shape == lsum.shape == (2, HEADS, 70) and m.dtype == lsum.dtype == torch.float32
    torch.testing.assert_close(m.double(), s.amax(-1), atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(lsum.double(), torch.exp(s - s.amax(-1, keepdim=True)).sum(-1),
                               atol=1e-5, rtol=1e-6)
    assert torch.equal(out, ca.qkv_attention_reference(x, HEADS))


def norm_inputs(seed: int, shape: tuple, members: int = 0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    aff = (c,) if members == 0 else (members, c)
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    scale = (1.0 + 0.5 * rng.standard_normal(aff)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(aff)).astype(np.float32)
    return x, scale, bias, rng.standard_normal(shape).astype(np.float32)


def plain_norm_grads(x, scale, bias, g, act):
    """The plain backward from what the autograd forward saves."""
    _, mean, var = gn._forward(x, scale, bias, act, 1e-5, None, stats=True)
    return gn.group_norm_act_backward_reference(x, scale, bias, mean, var, g, act)


def jax_norm_grads(x, scale, bias, g, act):
    def f(xx, ss, bb):
        return J_ACTS[act](j_group_norm_32(xx, ss, bb))
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, scale, bias)))
    return [np.asarray(r) for r in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("act", ["silu", "relu", "none"])
@pytest.mark.parametrize("shape,members", [
    ((2, 5, 6, 8), 0), ((2, 4, 4, 32), 0), ((4, 3, 5, 96), 2), ((2, 4, 4, 256), 0),
    ((2, 3, 4, 5, 32), 0), ((4, 2, 3, 4, 8), 4), ((2, 3, 3, 3, 256), 2),
])
def test_plain_norm_backward_matches_jax_vjp(shape, members, act):
    """2-D and 3-D spatial, 1 channel a group (C = 8, 96) and 32 groups,
    ``(C,)`` and member-folded ``(M, C)`` affines."""
    x, scale, bias, g = norm_inputs(sum(shape) + members, shape, members)
    got = plain_norm_grads(*(torch.from_numpy(a) for a in (x, scale, bias, g)), act)
    for w, a, r in zip(("x", "scale", "bias"), got, jax_norm_grads(x, scale, bias, g, act)):
        assert a.shape == r.shape, w
        np.testing.assert_allclose(a.numpy(), r, atol=1e-5, rtol=1e-4, err_msg=f"d{w}")


@pytest.mark.parametrize("act", ["silu", "relu", "none"])
@pytest.mark.parametrize("shape,members", [((2, 4, 4, 32), 0), ((4, 3, 5, 96), 2),
                                           ((2, 2, 3, 4, 8), 0)])
def test_plain_norm_backward_equals_float64_autograd_of_the_twin(shape, members, act):
    x, scale, bias, g = (torch.from_numpy(a).double()
                         for a in norm_inputs(7 + sum(shape), shape, members))
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    ref = torch.autograd.grad(gn.group_norm_act_reference(*leaves, act), leaves, g)
    for a, r in zip(plain_norm_grads(x, scale, bias, g, act), ref):
        torch.testing.assert_close(a, r, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "relu", "none"])
@pytest.mark.parametrize("shape,members", [((4, 5, 6, 8), 0), ((4, 3, 4, 64), 2),
                                           ((4, 7, 96), 4), ((2, 2, 3, 4, 32), 0)])
def test_plain_norm_backward_equals_autograd_of_the_twin_bit_for_bit(shape, members, act,
                                                                     dtype):
    """On the CPU the plain backward is autograd of the twin, bit for bit:
    the same operations in the same order, from the saved statistics."""
    x, scale, bias, g = norm_inputs(3 + sum(shape), shape, members)
    xt, st, bt = torch.from_numpy(x).to(dtype), torch.from_numpy(scale), torch.from_numpy(bias)
    gt = torch.from_numpy(g).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (xt, st, bt)]
    ref = torch.autograd.grad(gn.group_norm_act_reference(*leaves, act), leaves, gt)
    for w, a, r in zip(("x", "scale", "bias"), plain_norm_grads(xt, st, bt, gt, act), ref):
        assert a.dtype == r.dtype and torch.equal(a, r), w


@pytest.mark.parametrize("act", ["silu", "none"])
def test_plain_norm_backward_of_a_constant_group(act):
    """Constant groups: the variance E[x^2] - mean^2 is 0 (the clamp's
    edge, where its gradient passes, as torch's clamp passes it), xh is 0
    and rstd 1/sqrt(eps) = 316, so dx = rstd (scale dz - mean(scale dz))
    and dscale is 0 there. In float64 the plain backward is float64 autograd
    of the twin to 1e-10, dscale 0 at the constant channel. In float32 both
    it (autograd's order, as the twin) and JAX form dscale as rstd (sum dy x
    - mean sum dy), a difference of two float32 sums that rstd amplifies:
    each is within 2e-4 of the leaf's largest gradient of float64 (JAX at
    9.5e-5 here) and of the other."""
    x, scale, bias, g = norm_inputs(5, (2, 4, 4, 32))
    x[1, ..., 8:9] = 0.75  # one channel a group: group 8 of row 1
    x[0, ..., :] = -1.5    # every group of row 0
    xt, st, bt, gt = (torch.from_numpy(a) for a in (x, scale, bias, g))
    _, mean, var = gn._forward(xt, st, bt, act, 1e-5, None, stats=True)
    assert var[1, 8] == var[0, 0] == 0 and mean[1, 8] == 0.75 and mean[0, 0] == -1.5
    leaves = [t.double().requires_grad_(True) for t in (xt, st, bt)]
    ref = torch.autograd.grad(gn.group_norm_act_reference(*leaves, act), leaves, gt.double())
    got64 = plain_norm_grads(*(t.double() for t in (xt, st, bt, gt)), act)
    for a, r in zip(got64, ref):
        torch.testing.assert_close(a, r, atol=1e-10, rtol=1e-10)
    assert abs(got64[1][8].item()) < 1e-10  # channel 8 is constant in both rows
    got = plain_norm_grads(xt, st, bt, gt, act)
    for w, a, r, j in zip(("x", "scale", "bias"), got, ref, jax_norm_grads(x, scale, bias, g, act)):
        top = r.abs().max().item()
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.double(), r, atol=2e-4 * top, rtol=1e-4, msg=f"d{w}")
        np.testing.assert_allclose(a.numpy(), j, atol=2e-4 * top, rtol=1e-4, err_msg=f"d{w}")


def test_plain_norm_backward_where_the_clamp_bites():
    """float32, a group of large mean and small spread whose E[x^2] - mean^2
    rounds below 0: the forward clamps it, the saved variance keeps its
    sign, and the plain backward passes no gradient through it, as autograd
    of the twin does (bit for bit); the centred gradient would keep that
    term, which matters here."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    x[0, ..., 3] = 300.0 + 0.01 * rng.standard_normal((4, 4)).astype(np.float32)
    xt = torch.from_numpy(x)
    scale, bias = torch.full((8,), 1.3), torch.full((8,), 0.2)
    _, mean, var = gn._forward(xt, scale, bias, "none", 1e-5, None, stats=True)
    assert var[0, 3] < 0  # the case this test is about
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (xt, scale, bias)]
    ref = torch.autograd.grad(gn.group_norm_act_reference(*leaves, "none"), leaves, g)
    for a, r in zip(plain_norm_grads(xt, scale, bias, g, "none"), ref):
        assert torch.equal(a, r)
    rstd = torch.rsqrt(torch.tensor(1e-5))
    xh = (xt[0, ..., 3] - xt[0, ..., 3].mean()) * rstd
    centred_term = (1.3 * g[0, ..., 3] * xh).mean() * xh * rstd
    assert centred_term.abs().max() > 0.1 * ref[0].abs().max()  # the term dropped matters


def test_twin_rounds_its_bf16_input_gradient_once():
    """Autograd of the twin on a bf16 input casts x to float32 once, so its
    input gradient is the float32 gradient rounded to bf16 once (a second
    cast for the statistics would round the mean and variance paths apart
    and add them in bf16: the twins-forced step's reference)."""
    x, scale, bias, g = norm_inputs(11, (2, 8, 8, 32))
    xb = torch.from_numpy(x).bfloat16()
    st, bt, gb = torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(g).bfloat16()
    x16 = xb.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(gn.group_norm_act_reference(x16, st, bt, "silu"), x16, gb)
    x32 = xb.float().requires_grad_(True)
    y = gn._activate(gn.group_norm_f32(x32, st, bt, num_groups=32), "silu")
    (ref,) = torch.autograd.grad(y, x32, gb.float())
    assert torch.equal(got, ref.bfloat16())


def test_norm_forward_saves_the_twins_group_statistics():
    """mean and var are each row's group mean and E[x^2] - mean^2 before the
    clamp (``(B, G)`` float32), from numpy here in float64; 1/sqrt(var +
    eps) from them is the twin's normaliser; the output is the twin's, bit
    for bit."""
    x, scale, bias, _ = norm_inputs(2, (3, 5, 6, 64))
    xt, st, bt = (torch.from_numpy(a) for a in (x, scale, bias))
    y, mean, var = gn._forward(xt, st, bt, "silu", 1e-5, None, stats=True)
    xg = x.astype(np.float64).reshape(3, 30, 32, 2)
    mu = xg.mean((1, 3))
    v64 = (xg * xg).mean((1, 3)) - mu * mu
    assert mean.shape == var.shape == (3, 32) and mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), mu, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), v64, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(torch.rsqrt(var + 1e-5).numpy(), 1 / np.sqrt(v64 + 1e-5),
                               rtol=1e-4)
    assert torch.equal(y, gn.group_norm_act_reference(xt, st, bt, "silu"))


def test_no_grad_saves_nothing(monkeypatch):
    """Serving (no_grad, or inputs that need no gradient) takes the forward
    without statistics; only the autograd forward asks for them."""
    asked = []
    fwd_a, fwd_n = ca._forward, gn._forward
    monkeypatch.setattr(ca, "_forward", lambda *a, stats=False: (asked.append(("a", stats)),
                                                                  fwd_a(*a, stats=stats))[1])
    monkeypatch.setattr(gn, "_forward", lambda *a, stats=False: (asked.append(("n", stats)),
                                                                  fwd_n(*a, stats=stats))[1])
    qkv = torch.randn(2, 12, 3 * HEADS * 16, requires_grad=True)
    x = torch.randn(2, 3, 4, 32, requires_grad=True)
    scale, bias = torch.ones(32), torch.zeros(32)
    with torch.no_grad():
        ca.qkv_attention_cuda(qkv, HEADS)
        gn.group_norm_act(x, scale, bias)
    ca.qkv_attention_cuda(qkv.detach(), HEADS)
    gn.group_norm_act(x.detach(), scale, bias)
    assert asked == [("a", False), ("n", False)] * 2
    out = ca.qkv_attention_cuda(qkv, HEADS)
    y = gn.group_norm_act(x, scale, bias)
    assert asked[4:] == [("a", True), ("n", True)]
    assert [t.shape for t in out.grad_fn.saved_tensors] == [
        qkv.shape, out.shape, (2, HEADS, 12), (2, HEADS, 12)]
    assert [t.shape for t in y.grad_fn.saved_tensors] == [
        x.shape, scale.shape, bias.shape, (2, 32), (2, 32)]


def test_the_functions_backward_reaches_the_plain_versions_on_the_cpu(monkeypatch):
    """On the CPU each Function's backward is its plain backward, called once
    a backward, with the saved statistics; no kernel and no twin VJP."""
    calls = []
    plain_a, plain_n = ca.qkv_attention_backward_reference, gn.group_norm_act_backward_reference

    def counting(name, fn):
        def inner(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(ca, "qkv_attention_backward_reference", counting("attention", plain_a))
    monkeypatch.setattr(gn, "group_norm_act_backward_reference", counting("norm", plain_n))
    qkv = torch.randn(2, 12, 3 * HEADS * 16, requires_grad=True)
    x = torch.randn(2, 3, 4, 32, requires_grad=True)
    scale, bias = torch.ones(32, requires_grad=True), torch.zeros(32, requires_grad=True)
    ca.reset_launch_count()
    gn.reset_launch_count()
    (ca.qkv_attention_cuda(qkv, HEADS).sum() + gn.group_norm_act(x, scale, bias).sum()).backward()
    assert sorted(calls) == ["attention", "norm"]
    assert qkv.grad is not None and x.grad is not None and scale.grad is not None
    assert (ca.launch_count(), ca.backward_launch_count(), ca.vjp_count()) == (0, 0, 0)
    assert (gn.launch_count(), gn.backward_launch_count(), gn.vjp_count()) == (0, 0, 0)


def test_backward_wrappers_raise_off_the_cpu_before_any_launch(monkeypatch):
    """A tensor that is neither on the CPU nor takeable by the kernels raises
    in the backward too, before the library is reached: no quiet fallback."""
    def no_launch():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(ca, "_library", no_launch)
    monkeypatch.setattr(gn, "_library", no_launch)
    qkv = torch.empty(2, 64, 3 * HEADS * 40, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no head width 40"):
        ca._backward(qkv, None, None, None, None, HEADS)
    qkv = torch.empty(2, 64, 3 * HEADS * 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        ca._backward(qkv, None, None, None, None, HEADS)
    x = torch.empty(2, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        gn._backward(x, torch.ones(32), torch.zeros(32), None, None, None, "silu", 1e-5)
    assert ca.backward_launch_count() == gn.backward_launch_count() == 0


def test_attention_backward_source_matches_python_limits():
    """The backward is instantiated for exactly the forward's head widths,
    its tiles fit shared memory at each, it uses the forward's tensor-core
    and copy instructions, and no atomics (each gradient is written once)."""
    cases = tuple(int(d) for d in re.findall(r"case (\d+):\s*\n\s*return launch_backward<\1>\(",
                                             ATTN_SRC))
    assert cases == ca.HEAD_DIMS
    smem_limit = int(re.search(r"kMaxSharedBytes = (\d+)", ATTN_SRC).group(1))
    tile = int(re.search(r"constexpr int kKeyTile = (\d+)", ATTN_SRC).group(1))
    for d in ca.HEAD_DIMS:
        stride = -(-d // 16) * 16 // 8 + 1  # Geometry<D>::kQkChunks, odd
        assert stride % 2 == 1 and 6 * 16 * tile * stride + 2 * 16 * tile <= smem_limit
    body = ATTN_SRC[ATTN_SRC.index("// Backward."):]
    assert "mma_bf16(" in body and "ldmatrix_x4_trans(" in body and "cp_async16(" in body
    assert re.search(r"atomic\w*\(", ATTN_SRC) is None
    sig = re.search(r"int qkv_attention_backward_bf16\(([^)]*)\)", ATTN_SRC).group(1)
    assert sig.count("void*") == 8 and sig.count("int ") == 5
    fwd = re.search(r"int qkv_attention_bf16\(([^)]*)\)", ATTN_SRC).group(1)
    assert fwd.count("void*") == 5


def test_backward_ctypes_signatures_are_declared_before_calls():
    import inspect

    src = inspect.getsource(ca._library)
    assert "bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4" in src
    src = inspect.getsource(gn._library)
    assert "*[ctypes.c_void_p] * 9," in src
    sig = re.search(r"int group_norm_act_backward\(([^)]*)\)", NORM_SRC).group(1)
    assert sig.count("void*") == 10 and sig.count("long long") == 2
    sig = re.search(r"int group_norm_act_backward_clusters\(([^)]*)\)", NORM_SRC).group(1)
    assert sig.count("long long") == 1 and sig.count("int*") == 1


def _source_bwd_layout(cache_bytes: int, threads: int, v: int, c: int, groups: int) -> int:
    """``bwd_layout(...).total`` evaluated from the source's own lines."""
    body = re.search(r"inline BwdLayout bwd_layout\(.*?\{(.*?)return l;", NORM_SRC,
                     re.S).group(1)
    cv = c // v
    env = {"cache_bytes": cache_bytes, "threads": threads, "v": v, "c": c, "groups": groups,
           "kChunks": gn.CHUNKS,
           "part_rows": lambda t, n: t // 32 if 32 % n == 0 else t // n}
    for name, expr in re.findall(r"l\.(\w+) = (.*?);", body):
        env[name] = eval(expr.replace("l.", "").replace("c / v", str(cv)).replace("/", "//"),
                         {}, env)
    return env["total"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_backward_plan_fits_the_source_limits(dtype):
    """At every width the forward takes (a multiple of the packet up to
    MAX_CHANNELS) and a range of sizes, the backward plan's cluster, block,
    slice and cache satisfy the source's launch checks, its shared memory
    (both caches) is the source's layout and fits; the grid fills
    FILL_BLOCKS blocks where the rows and pixels allow."""
    v = gn.VECTOR_BYTES // gn.ELEMENT_BYTES[dtype]
    limit = int(re.search(r"kSmemLimit = (\d+)", NORM_SRC).group(1))
    for c in range(v, gn.MAX_CHANNELS + 1, v):
        assert gn.kernel_supports(c, dtype)
        for s, rows in ((1, 1), (7, 3), (1024, 16), (16384, 16), (64, 256)):
            plan = gn.backward_plan(s, c, dtype, rows)
            assert plan.cluster in gn.CLUSTER_SIZES and plan.slice_pix * plan.cluster >= s
            assert plan.threads % 32 == 0 and c // v <= plan.threads <= gn.MAX_THREADS
            assert 0 <= plan.cache_pix <= plan.slice_pix and plan.smem <= gn.PAIR_SMEM
            assert (rows * plan.cluster >= gn.FILL_BLOCKS
                    or plan.cluster == max(gn.CLUSTER_SIZES) or 2 * plan.cluster > s)
        if c in (8, 32, 96, 256, 1000, 1536, 2048) or c % 256 == 0:
            plan = gn.backward_plan(1024, c, dtype, 16)
            cache = plan.cache_pix * c * gn.ELEMENT_BYTES[dtype]
            assert plan.smem == _source_bwd_layout(cache, plan.threads, v, c,
                                                   num_groups_for(c)) <= limit
    assert gn.backward_plan(64, 6, dtype, 2) is None  # the forward does not take it either


def test_norm_backward_plans_at_the_training_sites():
    """unet16's training sites at batch 16 take the forward's planner with x
    and dy cached, three blocks of at most 256 threads to an SM: each
    element's x and dy held whole in shared memory except at the 128x128
    sites and the wider 64x64 and 32x32 ones, which stream from K = 16
    blocks."""
    streamed = {((128, 128, 32), "bfloat16"), ((128, 128, 32), "float32"),
                ((128, 128, 64), "bfloat16"), ((128, 128, 96), "bfloat16"),
                ((64, 64, 96), "bfloat16"), ((64, 64, 128), "bfloat16"),
                ((64, 64, 192), "bfloat16"), ((32, 32, 256), "bfloat16"),
                ((32, 32, 384), "bfloat16")}
    for shape, dt, _act in norm_sites("softmax", 128):
        s = math.prod(shape[:-1])
        plan = gn.backward_plan(s, shape[-1], getattr(torch, dt), 16)
        assert plan == gn.cluster_plan(s, shape[-1], getattr(torch, dt), 16, backward=True)
        assert plan.threads <= 256 and plan.smem <= gn.THIRD_SMEM
        assert (plan.mode == "stream") is ((shape, dt) in streamed)
        assert plan.mode == "resident" or plan.cluster == 16


def test_norm_backward_source_is_deterministic_and_clamp_aware():
    body = NORM_SRC[NORM_SRC.index("// Backward."):]
    # the one atomic counts rows on an unsigned counter; every sum is in order
    assert re.findall(r"atomic\w*\([^;]*;", NORM_SRC) == ["atomicAdd(&counters[member], 1u) + 1u;"]
    assert "cluster.map_shared_rank(s1, r)" in body
    assert "group_norm_affine_grad_kernel" not in NORM_SRC
    assert "g_var[g] < 0.0f ? 0.0f" in body  # the clamp's gradient, from the saved sign
    # the backward's r is the forward's, bit for bit
    assert "g_inv[g] = 1.0f / sqrtf(fmaxf(var_raw, 0.0f) + eps);" in NORM_SRC
    assert "g_rstd[g] = 1.0f / sqrtf(fmaxf(g_var[g], 0.0f) + eps);" in body
    acts = re.findall(r"case k(None|Silu|Relu):\s*\n\s*return group_norm_act_bwd_kernel",
                      NORM_SRC)
    assert sorted(acts) == ["None", "Relu", "Silu"]
