"""The backward of both hand-written kernels: each wrapper's autograd Function
(forward the kernel, saving its statistics; backward the backward kernel).

On the CPU the Function's forward runs the twin and its backward the
backward kernel's plain version (the wrappers take the plain versions for
CPU tensors), so these tests hold the Function's plumbing: gradcheck in
float64 on small shapes (attention head widths 16 and 32, GroupNorm widths
32 and 96 with silu, relu and none; gradcheck's own tolerances, atol 1e-5
and rtol 1e-3 against finite differences), the Function's gradients equal
to plain autograd of the twin (float32, to 1e-6), no graph under
``no_grad`` (the serving paths), and the backward reaching the plain
backwards, never the twins' public names that ``chip_smoke.py`` counts as
forward twin calls nor the twin VJP helpers. On the card the same Functions
wrap the kernels (``chip_smoke.py``'s train phase).
"""

import pytest
import torch

from diffuncertainty_tpu_torch.ops import attention
from diffuncertainty_tpu_torch.ops import cuda_attention as ca
from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
from torch_threads import one_torch_thread  # noqa: F401


def counting_backwards(monkeypatch) -> dict:
    """Counts the calls of each Function's plain backward (the CPU's route)."""
    calls = {"attention": 0, "norm": 0}
    for mod, name, key in ((ca, "qkv_attention_backward_reference", "attention"),
                           (gn, "group_norm_act_backward_reference", "norm")):
        def counted(*args, fn=getattr(mod, name), key=key, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    return calls


def qkv_input(d: int, dtype=torch.float64, heads: int = 2, t: int = 12, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, t, 3 * heads * d, generator=g, dtype=dtype).requires_grad_(True)


def norm_inputs(c: int, dtype=torch.float64, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(2, 3, 4, c, generator=g, dtype=dtype) + 0.5).requires_grad_(True)
    scale = (1.0 + 0.3 * torch.randn(c, generator=g, dtype=dtype)).requires_grad_(True)
    bias = (0.2 * torch.randn(c, generator=g, dtype=dtype)).requires_grad_(True)
    return x, scale, bias


@pytest.mark.parametrize("d", [16, 32])
def test_attention_function_passes_gradcheck(d, monkeypatch):
    qkv = qkv_input(d)
    calls = counting_backwards(monkeypatch)
    assert torch.autograd.gradcheck(lambda t: ca.qkv_attention_cuda(t, 2), (qkv,), fast_mode=True)
    assert calls["attention"] > 0


@pytest.mark.parametrize("c", [32, 96])
@pytest.mark.parametrize("act", ["silu", "relu", "none"])
def test_group_norm_function_passes_gradcheck(c, act, monkeypatch):
    inputs = norm_inputs(c)
    calls = counting_backwards(monkeypatch)
    assert torch.autograd.gradcheck(lambda x, s, b: gn.group_norm_act(x, s, b, act), inputs,
                                     fast_mode=True)
    assert calls["norm"] > 0


def grads(fn, inputs):
    out = fn(*inputs)
    g = torch.Generator().manual_seed(1)
    return torch.autograd.grad(out, inputs, torch.randn(out.shape, generator=g, dtype=out.dtype))


@pytest.mark.parametrize("d", [16, 32])
def test_attention_function_gradient_equals_autograd_of_the_twin(d):
    qkv = qkv_input(d, torch.float32)
    (got,) = grads(lambda t: ca.QKVAttentionFn.apply(t, 2), (qkv,))
    (ref,) = grads(lambda t: ca.qkv_attention_reference(t, 2), (qkv,))
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("c", [32, 96])
@pytest.mark.parametrize("act", ["silu", "relu", "none"])
def test_group_norm_function_gradient_equals_autograd_of_the_twin(c, act):
    inputs = norm_inputs(c, torch.float32)
    got = grads(lambda x, s, b: gn.GroupNormActFn.apply(x, s, b, act, 1e-5, None), inputs)
    ref = grads(lambda x, s, b: gn.group_norm_act_reference(x, s, b, act), inputs)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-6)


def test_bf16_gradients_come_back_in_the_input_dtypes():
    qkv = qkv_input(16, torch.bfloat16)
    (g,) = grads(lambda t: attention.qkv_attention(t, 2), (qkv,))
    assert g.dtype == torch.bfloat16
    x, scale, bias = norm_inputs(32, torch.float32)
    x = x.detach().to(torch.bfloat16).requires_grad_(True)
    gx, gs, gb = grads(lambda a, s, b: gn.group_norm_act(a, s, b, "silu"), (x, scale, bias))
    assert (gx.dtype, gs.dtype, gb.dtype) == (torch.bfloat16, torch.float32, torch.float32)


def test_the_affine_keeps_its_graph_through_the_wrapper():
    """The wrapper casts the affine to float32; a bf16 scale must still get its gradient."""
    x, scale, bias = norm_inputs(32, torch.float32)
    scale16 = scale.detach().to(torch.bfloat16).requires_grad_(True)
    out = gn.group_norm_act(x, scale16, bias, "none")
    (gs,) = torch.autograd.grad(out.sum(), scale16)
    assert gs.dtype == torch.bfloat16 and gs.abs().sum() > 0


def test_no_grad_builds_no_graph_and_takes_no_vjp():
    qkv = qkv_input(16, torch.float32)
    x, scale, bias = norm_inputs(32, torch.float32)
    ca.reset_launch_count()
    gn.reset_launch_count()
    with torch.no_grad():
        assert ca.qkv_attention_cuda(qkv, 2).grad_fn is None
        assert gn.group_norm_act(x, scale, bias).grad_fn is None
    # inputs that need no gradient take the plain forward too
    assert ca.qkv_attention_cuda(qkv.detach(), 2).grad_fn is None
    assert gn.group_norm_act(x.detach(), scale.detach(), bias.detach()).grad_fn is None
    assert ca.qkv_attention_cuda(qkv, 2).grad_fn.name() == "QKVAttentionFnBackward"
    assert gn.group_norm_act(x, scale, bias).grad_fn.name() == "GroupNormActFnBackward"
    assert ca.vjp_count() == gn.vjp_count() == 0
    assert ca.backward_launch_count() == gn.backward_launch_count() == 0


def test_the_backward_calls_the_vjp_helpers_not_the_public_twins(monkeypatch):
    """chip_smoke counts a call of ``qkv_attention_reference`` or
    ``group_norm_act_reference`` as a forward twin call: the backward must
    reach neither name, and no twin VJP helper either: it reaches the plain
    backwards, once each. On the CPU the forward is the twin, so it is run
    before the names are replaced."""
    qkv = qkv_input(16, torch.float32)
    x, scale, bias = norm_inputs(32, torch.float32)
    out_a = ca.qkv_attention_cuda(qkv, 2)
    out_n = gn.group_norm_act(x, scale, bias, "silu")

    def forbidden(*args, **kwargs):
        raise AssertionError("the backward called a twin by its public name")

    for mod, name in ((ca, "qkv_attention_reference"), (attention, "qkv_attention_reference"),
                      (gn, "group_norm_act_reference")):
        monkeypatch.setattr(mod, name, forbidden)
    calls = counting_backwards(monkeypatch)
    ca.reset_launch_count()
    gn.reset_launch_count()
    (out_a.sum() + out_n.sum()).backward()
    assert qkv.grad is not None and x.grad is not None and scale.grad is not None
    assert calls == {"attention": 1, "norm": 1}
    assert (ca.vjp_count(), gn.vjp_count()) == (0, 0)
