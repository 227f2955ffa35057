"""Port parity: config constants, the weight bridge and the full-width unet16.

The unet16 forward uses the trained asset ``assets/bench_unet16_toy128.npz``
at 32x32 in float32. Logits are held to atol 1e-5 with rtol 1e-4, the
tolerance the JAX package holds its own full model to against the torch
reference (tests/test_torch_parity.py): at |logit| ~ 16 the float32
forwards sit about 1e-5 from a float64 forward (see
test_unet16_float32_forwards_against_float64), so a pure 1e-5 bound is at
the float32 noise floor. The softmax
probabilities, O(1) values, are held to 1e-5.

Dropout masks are injected on both sides: in JAX with
``flax.linen.intercept_methods`` on ``ChannelDropout`` (nothing in the JAX
package changes), in the port by replacing ``ChannelDropout.draw_mask``.
"""

import dataclasses
import zlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.models.unet import ChannelDropout as JChannelDropout
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load_npz
from diffuncertainty_tpu_torch.core import config as tconfig
from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_into, load_params_npz
from diffuncertainty_tpu_torch.core.specs import DropoutSpec
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.unet import AttentionBlock, ChannelDropout, DiffUnet
from torch_threads import one_torch_thread  # noqa: F401

ASSET = "assets/bench_unet16_toy128.npz"
UNET16 = dict(in_channels=3, out_channels=2, model_channels=32, num_res_blocks=(2, 2, 2, 2),
              num_middle_res_blocks=2, attention_resolutions=(-2, -1), channel_mult=(1, 2, 4, 8),
              num_heads=4)


def mask_for(path: str, shape, rate: float = 0.2) -> np.ndarray:
    """A keep mask per dropout site, the same on both sides."""
    return np.random.default_rng(zlib.crc32(path.encode())).random(shape) >= rate


def jax_mask_interceptor(next_fun, args, kwargs, context):
    mod = context.module
    if isinstance(mod, JChannelDropout) and context.method_name == "__call__" and mod.rate > 0:
        x = args[0]
        keep = 1.0 - mod.rate
        m = mask_for("/".join(mod.path), (x.shape[0], x.shape[-1]), mod.rate)
        m = jnp.asarray(m.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)))
        return jnp.where(m, x / keep, 0.0).astype(x.dtype)
    return next_fun(*args, **kwargs)


def torch_draw_mask(self, shape, generator, device):
    return torch.from_numpy(mask_for(self.path.replace(".", "/"), shape, self.rate)).to(device)


def _as_plain(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    return tuple(v) if isinstance(v, list) else v


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_config_constants_match_jax_load_config(precision):
    ref = j_load_config(data="lidc128", network="unet16", model="softmax", eu_method="dropout",
                        overrides=[f"trainer.precision={precision}"])
    got = tconfig.load_config(data="lidc128", network="unet16", model="softmax",
                              eu_method="dropout", precision=precision)
    n_fields = 0
    for path in ("data", "data.augmentations", "network", "model", "eu_method", "trainer"):
        ours_group, theirs_group = got, ref
        for part in path.split("."):
            ours_group, theirs_group = getattr(ours_group, part), getattr(theirs_group, part)
        for f in dataclasses.fields(ours_group):
            if f.name == "augmentations":
                continue  # compared field by field as its own group
            ours, theirs = getattr(ours_group, f.name), getattr(theirs_group, f.name)
            assert _as_plain(ours) == _as_plain(theirs), f"{path}.{f.name}"
            n_fields += 1
    assert n_fields == 72  # every field the port keeps was compared
    with pytest.raises(NotImplementedError):  # every JAX group is ported: an unknown one
        tconfig.load_config(network="unet1024")


def test_dropout_spec_copy_matches_jax():
    from diffuncertainty_tpu.core.specs import DropoutSpec as JSpec

    kw = dict(enabled=True, probability_values=(0.1, 0.3), decoder=False)
    got, ref = DropoutSpec(**kw), JSpec(**kw)
    assert got.max_rate == ref.max_rate
    for stage in ("encoder", "mid", "decoder"):
        for depth in range(4):
            assert got.stage_rate(stage, depth) == ref.stage_rate(stage, depth)


def test_param_bridge_uses_every_asset_key():
    flat = np.load(ASSET).files
    state = flax_to_torch(load_params_npz(ASSET))
    assert len(state) == len(flat) == 290
    module = DiffUnet(**UNET16)
    expected = module.state_dict()
    assert set(state) == set(expected)
    for k, v in state.items():
        assert v.shape == expected[k].shape and v.dtype == torch.float32, k
    # layouts: conv HWIO -> OIHW, dense (I, O) -> (O, I)
    tree = j_load_npz(ASSET)["params"]
    np.testing.assert_array_equal(state["enc0_res.in_conv.weight"].numpy(),
                                  np.asarray(tree["enc0_res"]["in_conv"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["mid0_attn.qkv.weight"].numpy(),
                                  np.asarray(tree["mid0_attn"]["qkv"]["kernel"]).T)
    with pytest.raises(KeyError):
        flax_to_torch({"params": {"x": {"embedding": np.zeros(3)}}})


@pytest.fixture(scope="module")
def unet16_pair():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = j_load_npz(ASSET)
    return x, params


@pytest.fixture(scope="module")
def jax_logits_no_dropout(unet16_pair):
    from diffuncertainty_tpu.models.unet import DropoutSpec as JSpec

    x, params = unet16_pair
    return _jax_logits(params, x, JSpec())


def _jax_logits(params, x, spec):
    module = JDiffUnet(**UNET16, dropout_spec=spec)

    @jax.jit
    def f(p, xx):
        with nn.intercept_methods(jax_mask_interceptor):
            return module.apply(p, xx).logits

    return np.asarray(f(params, jnp.asarray(x)))


def _compare(got, ref):
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    pg = torch.softmax(torch.from_numpy(got), -1).numpy()
    pr = torch.softmax(torch.from_numpy(np.array(ref)), -1).numpy()
    np.testing.assert_allclose(pg, pr, atol=1e-5)


def test_unet16_forward_matches_jax_without_dropout(unet16_pair, jax_logits_no_dropout):
    x, _ = unet16_pair
    ref = jax_logits_no_dropout
    module = load_into(DiffUnet(**UNET16), ASSET)
    assert sum(isinstance(m, AttentionBlock) for m in module.modules()) == 11
    with torch.no_grad():
        got = module(torch.from_numpy(x)).logits.numpy()
    assert np.abs(ref).max() > 1.0  # trained weights, not a zero head
    _compare(got, ref)


def test_unet16_float32_forwards_against_float64(unet16_pair, jax_logits_no_dropout):
    """Both float32 forwards sit about 1e-5 from the port's float64 forward at
    |logit| ~ 16: the float32 noise floor that sets the logits tolerance.
    ``pytest -s`` prints the distances."""
    x, _ = unet16_pair
    m64 = load_into(DiffUnet(**UNET16), ASSET).double()
    m64.dtype = torch.float64
    m32 = load_into(DiffUnet(**UNET16), ASSET)
    with torch.no_grad():
        y64 = m64(torch.from_numpy(x).double()).logits.numpy()
        y32 = m32(torch.from_numpy(x)).logits.numpy()
    d_jax = np.abs(jax_logits_no_dropout - y64).max()
    d_port = np.abs(y32 - y64).max()
    print(f"max |logit|: {np.abs(y64).max():.3f}; max |jax f32 - f64|: {d_jax:.3e}; "
          f"max |port f32 - f64|: {d_port:.3e}; "
          f"max |jax f32 - port f32|: {np.abs(jax_logits_no_dropout - y32).max():.3e}")
    for y in (jax_logits_no_dropout, y32):
        np.testing.assert_allclose(y, y64, atol=1e-5, rtol=1e-4)


def test_unet16_forward_matches_jax_with_injected_masks(unet16_pair, monkeypatch):
    from diffuncertainty_tpu.models.unet import DropoutSpec as JSpec

    x, params = unet16_pair
    cfg = tconfig.load_config()
    spec = cfg.eu_method.dropout
    ref = _jax_logits(params, x, JSpec(**dataclasses.asdict(spec)))
    monkeypatch.setattr(ChannelDropout, "draw_mask", torch_draw_mask)
    built = build_model(cfg, device="cpu")
    load_into(built.module, ASSET)
    sites = [m.path for m in built.module.modules() if isinstance(m, ChannelDropout) and m.rate > 0]
    assert len(sites) == 8 + 2 + 12  # one per encoder, mid and decoder ResBlock
    with torch.no_grad():
        got = built.module(torch.from_numpy(x), torch.Generator()).logits.numpy()
        no_drop = load_into(DiffUnet(**UNET16), ASSET)(torch.from_numpy(x)).logits.numpy()
    _compare(got, ref)
    assert np.abs(got - no_drop).max() > 0.1  # the masks did act


def test_dropout_needs_a_generator_and_draws_fresh_masks():
    cfg = tconfig.load_config()
    built = build_model(cfg, device="cpu")
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        built.module(x)
    drop = ChannelDropout(0.2)
    h = torch.ones(64, 2, 2, 100)
    out = drop(h, torch.Generator().manual_seed(0))
    kept = out[:, 0, 0, :] != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.02
    np.testing.assert_allclose(out[:, 1, 1, :][kept].numpy(), 1 / 0.8, rtol=1e-6)
    assert bool((out == 0).reshape(64, 4, 100).all(1).eq(~kept).all())


def test_build_model_bf16_forward_runs_on_cpu():
    built = build_model(tconfig.load_config(precision="bf16"), device="cpu")
    assert built.module.dtype == torch.bfloat16 and built.eu_type == "dropout"
    with torch.no_grad():
        y = built.module(torch.randn(2, 16, 16, 3), torch.Generator().manual_seed(0)).logits
    assert y.dtype == torch.float32 and y.shape == (2, 16, 16, 2) and torch.isfinite(y).all()
