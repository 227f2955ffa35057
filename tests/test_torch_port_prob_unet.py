"""Port parity of the prob-U-Net family: the channel scaling, the latent
helpers, ``LatentEncoder``, ``Fcomb``, ``ProbUnet`` with and without
``segm``/``z``, the config, the trained asset and the whole 16-sample
sampler, each against the JAX package on the same numpy inputs.

The small network is model_channels 8, channel_mult (1, 2) (0.75 scales it
to itself), latent dim 6, at 32x32, with random weights (noise on every
leaf); the full-width prob-U-Net runs with the trained asset at 32x32. The
latent draws are injected on both sides in place of the samplers'
``sample_latent``.

Tolerances, float32: stacks and heatmaps atol 1e-5; logits, features and
latent parameters atol 1e-5 with rtol 1e-4 (the model rule of
test_torch_port_model); per-image Dice/GED 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.core.specs import ProbUnetSpec as JProbUnetSpec
from diffuncertainty_tpu.infer.batch_metrics import make_batch_metrics as j_make_bm
from diffuncertainty_tpu.models import prob_unet as jpu
from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load_npz
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core import config as tconfig
from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_into, load_params_npz
from diffuncertainty_tpu_torch.core.specs import ProbUnetSpec
from diffuncertainty_tpu_torch.infer.batch_metrics import make_batch_metrics
from diffuncertainty_tpu_torch.models import prob_unet as tpu
from diffuncertainty_tpu_torch.models.factory import BuiltModel, build_model
from diffuncertainty_tpu_torch.models.unet import AttentionBlock, DiffUnet, GroupNorm32
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from test_torch_port_ssn import compare_config_with_jax

ASSET = "assets/bench_unet16_toy128_prob_unet.npz"
SMALL = dict(in_channels=3, out_channels=2, model_channels=8, num_res_blocks=(1, 1),
             num_middle_res_blocks=2, attention_resolutions=(-1,), channel_mult=(1, 2),
             num_heads=4)
SPEC = dict(latent_dim=6, unet_channel_mult=0.75, prior_channel_mult=0.75,
            posterior_channel_mult=0.75, num_fcomb_convs=4)
LOGITS_TOL = dict(atol=1e-5, rtol=1e-4)


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _latent(rng, b, dim=6):
    return (rng.standard_normal((b, dim)).astype(np.float32),
            (0.3 * rng.standard_normal((b, dim))).astype(np.float32))


@pytest.mark.parametrize("channel_mult,scale,expected", [
    ((1, 2, 4, 8), 0.75, (1, 2, 3, 6)),  # 1.5 -> 2 (half to even)
    ((1, 2, 4, 8), 0.5, (1, 1, 2, 4)),
    ((1, 3, 5, 7), 0.5, (1, 2, 2, 4)),  # 1.5 -> 2, 2.5 -> 2, 3.5 -> 4
    ((1, 1, 2, 4), 0.75, (1, 1, 2, 3)),  # 0.75 -> 1, 1.5 -> 2
    ((1, 2, 4), 0.25, (1, 1, 1)),  # 0.5 -> 0, floored at 1
    ((2, 2), 0.75, (1, 2)),  # the first entry stays 1
    ((1, 2, 4, 8), 1.0, (1, 2, 4, 8)),
    ((1, 2, 4, 8), None, (1, 2, 4, 8)),
])
def test_scale_channel_mult_matches_jax(channel_mult, scale, expected):
    assert tpu._scale_channel_mult(channel_mult, scale) == expected
    assert jpu._scale_channel_mult(channel_mult, scale) == expected


def test_scale_channel_mult_rejects_a_non_positive_scale():
    for fn in (tpu._scale_channel_mult, jpu._scale_channel_mult):
        with pytest.raises(ValueError, match="must be > 0"):
            fn((1, 2), 0.0)


def test_latent_helpers_match_jax(rng):
    (mu_q, ls_q), (mu_p, ls_p) = _latent(rng, 4), _latent(rng, 4)
    ref = jpu.kl_diag_gaussians(jpu.LatentParams(jnp.asarray(mu_q), jnp.asarray(ls_q)),
                                jpu.LatentParams(jnp.asarray(mu_p), jnp.asarray(ls_p)))
    got = tpu.kl_diag_gaussians(tpu.LatentParams(torch.from_numpy(mu_q), torch.from_numpy(ls_q)),
                                tpu.LatentParams(torch.from_numpy(mu_p), torch.from_numpy(ls_p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    prior = tpu.LatentParams(torch.from_numpy(mu_p), torch.from_numpy(ls_p))
    np.testing.assert_allclose(prior.sigma.numpy(), np.exp(ls_p), rtol=1e-6)
    z = tpu.sample_latent(prior, torch.Generator().manual_seed(3))
    eps = torch.randn((4, 6), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(z, prior.mu + prior.sigma * eps, atol=0, rtol=0)


def test_latent_encoder_matches_jax(rng):
    jm = jpu.LatentEncoder(JDiffUnet(**SMALL, encoder_only=True), latent_dim=6)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = _noisy(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), 1)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = tpu.LatentEncoder(DiffUnet(**SMALL, encoder_only=True), 6, channels=16)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    for k in ("mu", "log_sigma"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   **LOGITS_TOL, err_msg=k)
    assert got.mu.shape == (2, 6)


def test_encoder_only_unet_has_no_decoder_and_returns_mid_features():
    enc, full = DiffUnet(**SMALL, encoder_only=True), DiffUnet(**SMALL)
    names = {n.split(".")[0] for n, _ in enc.named_parameters()}
    assert not any(n.startswith(("dec", "up", "out_", "ssn_")) for n in names)
    assert {"input_conv", "enc0_res", "down1", "enc1_res", "enc1_attn", "mid0_res",
            "mid0_attn", "mid1_res"} == names
    with pytest.raises(RuntimeError, match="Unexpected key"):
        enc.load_state_dict(full.state_dict(), strict=True)
    with torch.no_grad():
        out = enc(torch.randn(2, 32, 32, 3))
    assert out.logits is None and out.features.shape == (2, 16, 16, 16)


@pytest.mark.parametrize("num_layers", [1, 4])
def test_fcomb_matches_jax(rng, num_layers):
    jm = jpu.Fcomb(num_classes=2, hidden_channels=8, num_layers=num_layers)
    feats = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    z = rng.standard_normal((3, 6)).astype(np.float32)
    params = _noisy(jm.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(z)), 2)
    ref = jm.apply(params, jnp.asarray(feats), jnp.asarray(z))
    tm = tpu.Fcomb(8 + 6, 2, hidden_channels=8, num_layers=num_layers)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGITS_TOL)


@pytest.fixture(scope="module")
def small_prob_unet():
    """The same random weights in a small JAX and port ProbUnet."""
    jm = jpu.build_prob_unet(dict(SMALL), JProbUnetSpec(**SPEC))
    x, segm, z = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 2)), jnp.zeros((1, 6))
    params = _noisy(jax.jit(jm.init)(jax.random.key(0), x, segm, z), 3)
    tm = tpu.build_prob_unet(dict(SMALL), ProbUnetSpec(**SPEC))
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return jm, tm.eval(), params


@pytest.mark.parametrize("with_segm", [False, True])
@pytest.mark.parametrize("with_z", [False, True])
def test_prob_unet_matches_jax(small_prob_unet, with_segm, with_z):
    jm, tm, params = small_prob_unet
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    segm = np.eye(2, dtype=np.float32)[(rng.random((2, 32, 32)) < 0.3).astype(int)]
    z = rng.standard_normal((2, 6)).astype(np.float32)
    args = (segm if with_segm else None, z if with_z else None)
    ref = jax.jit(lambda p, xx, s, zz: jm.apply(p, xx, s, zz))(
        params, jnp.asarray(x), *(None if a is None else jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *(None if a is None else torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features), **LOGITS_TOL)
    for k in ("mu", "log_sigma"):
        np.testing.assert_allclose(getattr(got.prior, k).numpy(),
                                   np.asarray(getattr(ref.prior, k)), **LOGITS_TOL)
    assert (got.posterior is None) is (ref.posterior is None) is (not with_segm)
    if with_segm:
        for k in ("mu", "log_sigma"):
            np.testing.assert_allclose(getattr(got.posterior, k).numpy(),
                                       np.asarray(getattr(ref.posterior, k)), **LOGITS_TOL)
    assert (got.logits is None) is (ref.logits is None) is (not with_z)
    if with_z:
        np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **LOGITS_TOL)
        with torch.no_grad():
            decoded = tm.decode(got.features, torch.from_numpy(z))
        torch.testing.assert_close(decoded, got.logits, atol=0, rtol=0)


def test_prob_unet_config_matches_jax_load_config():
    got, n_fields = compare_config_with_jax("prob_unet")
    assert got.model.prob_unet == ProbUnetSpec(
        latent_dim=6, beta=2.5e-3, beta_warmup_epochs=32, regularizer_coeff=0.0,
        num_fcomb_convs=4, unet_channel_mult=0.75, prior_channel_mult=0.75,
        posterior_channel_mult=0.75)
    assert got.model.prob_unet != ProbUnetSpec()  # the yaml, not the dataclass defaults
    assert n_fields == 51  # every field the port keeps was compared


def test_factory_builds_the_prob_unet_and_loads_the_asset_strictly():
    built = build_model(tconfig.load_config(model="prob_unet", eu_method="none"), device="cpu")
    jb = j_build_model(j_load_config(data="lidc128", network="unet16", model="prob_unet",
                                     eu_method="none"))
    assert (built.au_type, built.eu_type, built.is_generative) == (
        jb.au_type, jb.eu_type, jb.is_generative) == ("prob_unet", "none", True)
    m = built.module
    assert isinstance(m, tpu.ProbUnet)
    for part in (m.base, m.prior.encoder, m.posterior.encoder):
        widths = {mod.weight.shape[0] for mod in part.modules() if isinstance(mod, GroupNorm32)}
        assert max(widths) <= 384 and 192 in widths
    assert m.posterior.encoder.input_conv.weight.shape[1] == 5  # image + segmentation
    assert m.prior.param_head.weight.shape == (12, 192, 1, 1)
    assert m.fcomb.body_0.weight.shape == (32, 38, 1, 1)
    state = flax_to_torch(load_params_npz(ASSET))
    assert len(state) == len(np.load(ASSET).files) == 550
    assert set(state) == set(m.state_dict())
    load_into(m, ASSET)
    gn = [sum(isinstance(g, GroupNorm32) for g in part.modules())
          for part in (m.base, m.prior, m.posterior)]
    attn = [sum(isinstance(a, AttentionBlock) for a in part.modules())
            for part in (m.base, m.prior)]
    assert gn == [56, 25, 25] and attn == [11, 5]


@pytest.fixture(scope="module")
def unet16_prob_unet_outputs():
    """The full-width prob-U-Net with the trained asset at 32x32, with z."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 6)).astype(np.float32)
    jb = j_build_model(j_load_config(data="lidc128", network="unet16", model="prob_unet",
                                     eu_method="none"))
    ref = jax.jit(lambda p, xx, zz: jb.module.apply(p, xx, None, zz))(
        j_load_npz(ASSET), jnp.asarray(x), jnp.asarray(z))
    built = build_model(tconfig.load_config(model="prob_unet", eu_method="none"), device="cpu")
    load_into(built.module, ASSET)
    with torch.no_grad():
        got = built.module(torch.from_numpy(x), z=torch.from_numpy(z))
    return ref, got


@pytest.mark.parametrize("field", ["features", "prior", "logits"])
def test_unet16_prob_unet_forward_matches_jax_with_the_trained_asset(unet16_prob_unet_outputs,
                                                                     field):
    ref, got = unet16_prob_unet_outputs
    pairs = ([(got.prior.mu, ref.prior.mu), (got.prior.log_sigma, ref.prior.log_sigma)]
             if field == "prior" else [(getattr(got, field), getattr(ref, field))])
    for g, r in pairs:
        r = np.asarray(r)
        assert g.shape == r.shape and np.abs(r).max() > 0.1  # trained weights
        np.testing.assert_allclose(g.numpy(), r, **LOGITS_TOL)


def test_prob_unet_sampler_matches_jax_with_injected_latents(small_prob_unet, monkeypatch):
    """make_sampler, 3 samples x 2 images at 32x32: both samplers take the
    same eps for their latent draws and must give the same stack, singleton
    grouping, heatmaps and per-image metrics. The draws see the prior tiled
    sample-major: row s*B + i is image i's prior."""
    n_pred, b, hw = 3, 2, 32
    jm, tm, params = small_prob_unet
    rng = np.random.default_rng(12)
    images = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    gt = (rng.random((b, 4, hw, hw)) < 0.3).astype(np.int32)
    eps = rng.standard_normal((n_pred * b, 6)).astype(np.float32)
    priors = []

    def t_latent(prior, generator):
        priors.append(prior)
        return prior.mu + prior.sigma * torch.from_numpy(eps)

    monkeypatch.setattr(j_sampler_mod, "sample_latent",
                        lambda prior, key: prior.mu + prior.sigma * jnp.asarray(eps))
    monkeypatch.setattr(t_sampler_mod, "sample_latent", t_latent)
    spec = dict(n_pred=n_pred, n_members=1, member_mode="single")
    jb = JBuilt(module=jm, au_type="prob_unet", eu_type="none", is_generative=True,
                num_classes=2)
    tb = BuiltModel(module=tm, au_type="prob_unet", eu_type="none", is_generative=True,
                    num_classes=2)
    j_fn = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(**spec))
    t_fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(**spec))
    ref = jax.jit(j_fn)(params, jnp.asarray(images), jax.random.key(0))
    got = t_fn(torch.from_numpy(images), torch.Generator())
    (prior,) = priors
    assert prior.mu.shape == (n_pred * b, 6)
    for s in range(n_pred):
        torch.testing.assert_close(prior.mu[s * b:(s + 1) * b], prior.mu[:b], atol=0, rtol=0)
    assert not torch.equal(prior.mu[0], prior.mu[1])
    assert tuple(t_fn.meta) == tuple(j_fn.meta) == (n_pred, 1, (True,) * n_pred)
    assert got.groups.shape == (n_pred, 1, b, hw, hw, 2)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5, err_msg=k)
    assert float(maps["EU"].mean()) > 1e-6  # the latents differ
    bm_ref = j_make_bm(num_classes=2, ignore_index=-1, meta=j_fn.meta,
                       compute_likelihood=False)(ref, jnp.asarray(gt))
    bm = make_batch_metrics(num_classes=2, ignore_index=-1)(got, torch.from_numpy(gt))
    for k in ("dice", "ged_bma", "ged", "max_dice_pred", "max_dice_gt", "major_dice"):
        np.testing.assert_allclose(bm[k].numpy(), np.asarray(bm_ref[k]), atol=1e-6, err_msg=k)


def test_prob_unet_sampler_draws_from_the_generator(small_prob_unet):
    _, tm, _ = small_prob_unet
    tb = BuiltModel(module=tm, au_type="prob_unet", eu_type="none", is_generative=True,
                    num_classes=2)
    fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(n_pred=4))
    x = torch.randn(2, 16, 16, 3)
    a = fn(x, torch.Generator().manual_seed(0))
    b = fn(x, torch.Generator().manual_seed(0))
    c = fn(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.groups, b.groups, atol=0, rtol=0)
    assert not torch.equal(a.groups, c.groups)
    torch.testing.assert_close(a.groups.sum(-1), torch.ones(4, 1, 2, 16, 16))
