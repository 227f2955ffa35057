"""Port parity of the SSN family: the low-rank normal (build, draws, validity,
log density), the SSN DiffUnet heads, the config, the trained asset and the
whole 16-sample sampler, each against the JAX package on the same numpy
inputs.

The small network is model_channels 8, channel_mult (1, 2), rank 3, at
32x32, with random weights (noise on every leaf, so no head is zero); the
full-width unet16 SSN runs with the trained asset at 32x32. The draws are
JAX's own: the port takes the normals that ``jax.random`` gives for a pinned
key (``jax_ssn_eps``) in place of its ``draw_normal``.

Tolerances, float32: draws, stacks and heatmaps atol 1e-5; logits, diag and
factor atol 1e-5 with rtol 1e-4 (the model rule of test_torch_port_model);
``log_prob`` rtol 1e-5; per-image Dice/GED 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.infer.batch_metrics import make_batch_metrics as j_make_bm
from diffuncertainty_tpu.models import ssn as j_ssn
from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load_npz
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core import config as tconfig
from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_into, load_params_npz
from diffuncertainty_tpu_torch.infer.batch_metrics import make_batch_metrics
from diffuncertainty_tpu_torch.models import ssn as t_ssn
from diffuncertainty_tpu_torch.models.factory import BuiltModel, build_model
from diffuncertainty_tpu_torch.models.unet import DiffUnet, GroupNorm32
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from test_torch_port_model import _as_plain

ASSET = "assets/bench_unet16_toy128_ssn.npz"
SMALL_SSN = dict(in_channels=3, out_channels=2, model_channels=8, num_res_blocks=(1, 1),
                 num_middle_res_blocks=2, attention_resolutions=(-1,), channel_mult=(1, 2),
                 num_heads=4, ssn=True, ssn_rank=3)
LOGITS_TOL = dict(atol=1e-5, rtol=1e-4)


def jax_ssn_eps(key, num_samples: int, b: int, r: int, n: int):
    """The normals ``diffuncertainty_tpu.models.ssn.sample_n(dist, key, S)``
    draws: eps_R (S, B, R) and eps_N (S, B, N)."""
    eps_r, eps_n = [], []
    for k in jax.random.split(key, num_samples):
        k1, k2 = jax.random.split(k)
        eps_r.append(np.asarray(jax.random.normal(k1, (b, r), jnp.float32)))
        eps_n.append(np.asarray(jax.random.normal(k2, (b, n), jnp.float32)))
    return np.stack(eps_r), np.stack(eps_n)


def inject_draws(monkeypatch, eps_r, eps_n):
    """The port's ``draw_normal`` gives eps_R, then eps_N; records the shapes."""
    queue, shapes = [eps_r, eps_n], []

    def draw(shape, generator, dtype):
        shapes.append(tuple(shape))
        return torch.from_numpy(queue.pop(0)).to(dtype)

    monkeypatch.setattr(t_ssn, "draw_normal", draw)
    return shapes


def _dist_inputs(rng, b, n, r):
    mean = rng.standard_normal((b, n)).astype(np.float32)
    diag = (0.05 + rng.random((b, n))).astype(np.float32)
    factor = (0.3 * rng.standard_normal((b, n, r))).astype(np.float32)
    return mean, diag, factor


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,n,r,num_samples", [(2, 12, 3, 4), (3, 512, 10, 2)])
def test_sample_n_matches_jax_with_the_jax_draws(rng, monkeypatch, b, n, r, num_samples):
    mean, diag, factor = _dist_inputs(rng, b, n, r)
    key = jax.random.key(4)
    ref = j_ssn.sample_n(j_ssn.build_distribution(*map(jnp.asarray, (mean, diag, factor))), key,
                         num_samples)
    dist = t_ssn.build_distribution(*_t(mean, diag, factor))
    assert not dist.cov_failed.any()
    shapes = inject_draws(monkeypatch, *jax_ssn_eps(key, num_samples, b, r, n))
    got = t_ssn.sample_n(dist, torch.Generator(), num_samples)
    assert shapes == [(num_samples, b, r), (num_samples, b, n)]
    assert got.shape == (num_samples, b, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_sample_draws_one_sample_from_the_generator(rng):
    mean, diag, factor = _dist_inputs(rng, 2, 12, 3)
    dist = t_ssn.build_distribution(*_t(mean, diag, factor))
    one = t_ssn.sample(dist, torch.Generator().manual_seed(5))
    stack = t_ssn.sample_n(dist, torch.Generator().manual_seed(5), 1)
    assert one.shape == (2, 12)
    torch.testing.assert_close(one, stack[0], atol=0, rtol=0)
    assert not torch.equal(one, t_ssn.sample(dist, torch.Generator().manual_seed(6)))


@pytest.mark.parametrize("n,r", [(12, 3), (2048, 10)])
def test_log_prob_matches_jax(rng, n, r):
    mean, diag, factor = _dist_inputs(rng, 3, n, r)
    value = (mean + rng.standard_normal(mean.shape)).astype(np.float32)
    ref = j_ssn.log_prob(j_ssn.build_distribution(*map(jnp.asarray, (mean, diag, factor))),
                         jnp.asarray(value))
    got = t_ssn.log_prob(t_ssn.build_distribution(*_t(mean, diag, factor)),
                         torch.from_numpy(value))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_cov_failed_matches_jax_per_element(rng):
    """NaN and inf inputs and a capacitance made indefinite by negative diag
    entries fail, and their factor is zeroed; a negative diag entry that
    leaves the capacitance positive definite does not fail, in both."""
    b, n, r = 7, 12, 3
    mean, diag, factor = _dist_inputs(rng, b, n, r)
    mean[1, 4] = np.nan
    factor[2, 0, 1] = np.inf
    diag[3] = -0.5  # I - 2 W^T W: indefinite at this factor scale
    factor[3] *= 10.0
    diag[4, 0] = -1.0
    factor[4] *= 0.01  # I - 1e-4 W^T W stays positive definite
    diag[5, 3] = np.nan
    mean[6, 0] = -np.inf
    ref = j_ssn.build_distribution(*map(jnp.asarray, (mean, diag, factor)))
    got = t_ssn.build_distribution(*_t(mean, diag, factor))
    expected = [False, True, True, True, False, True, True]
    assert got.cov_failed.tolist() == np.asarray(ref.cov_failed).tolist() == expected
    np.testing.assert_array_equal(got.cov_factor.numpy(), np.asarray(ref.cov_factor))
    assert (got.cov_factor[torch.tensor(expected)] == 0).all()
    torch.testing.assert_close(got.cov_factor[0], torch.from_numpy(factor[0]), atol=0, rtol=0)


def test_a_valid_covariance_does_not_fail_for_float32_rounding(rng):
    """I + W^T D^-1 W is positive definite for any positive diag, however
    ill-conditioned. With nearly collinear factor columns over N = 32768
    pixels and a small diag (entries about 1e11, smallest eigenvalue about
    1), a float32 capacitance loses that to rounding and its Cholesky fails,
    as a float32 one did on the card for the trained unet16 SSN; the port
    takes it in float64 and flags nothing."""
    b, n, r = 2, 32768, 10
    u = rng.standard_normal((b, n, 1)).astype(np.float32)
    factor = (30.0 * u * rng.standard_normal((b, 1, r))
              + 1e-3 * rng.standard_normal((b, n, r))).astype(np.float32)
    diag = np.full((b, n), 1e-4, np.float32)
    mean = np.zeros((b, n), np.float32)
    w, d = torch.from_numpy(factor), torch.from_numpy(diag)
    cap32 = torch.einsum("bnr,bns->brs", w / d[..., None], w) + torch.eye(r)
    assert (torch.linalg.cholesky_ex(cap32).info != 0).all()
    eig = torch.linalg.eigvalsh(t_ssn._capacitance(d, w))
    assert eig.dtype == torch.float64 and (eig[:, 0] > 0.5).all() and (eig[:, -1] > 1e10).all()
    dist = t_ssn.build_distribution(torch.from_numpy(mean), d, w)
    assert not dist.cov_failed.any() and dist.cov_factor.dtype == torch.float32
    torch.testing.assert_close(dist.cov_factor, w, atol=0, rtol=0)


@pytest.fixture(scope="module")
def small_ssn():
    """The same random weights in a small JAX and port SSN DiffUnet."""
    jm = JDiffUnet(**SMALL_SSN)
    params = jax.jit(jm.init)({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    tm = DiffUnet(**SMALL_SSN)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return jm, tm.eval(), params


@pytest.mark.parametrize("mean_only", [False, True])
def test_small_ssn_unet_outputs_match_jax(small_ssn, mean_only):
    jm, tm, params = small_ssn
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(lambda p, xx: jm.apply(p, xx, mean_only=mean_only))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mean_only=mean_only)
    assert got.ssn_cov_factor.shape == (2, 32 * 32 * 2, 3)
    for k in ("logits", "features", "ssn_mean", "ssn_cov_diag", "ssn_cov_factor"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   **LOGITS_TOL, err_msg=k)
    if mean_only:
        assert not got.ssn_cov_factor.any()
    else:
        assert got.ssn_cov_factor.abs().max() > 1e-3


def test_ssn_factor_is_flattened_in_h_w_c_rank_order(small_ssn):
    """The factor conv gives (rank x C) channels per pixel, rank-major; the
    flattened factor is (B, H*W*C, rank): pixel-major, then class, then rank."""
    _, tm, _ = small_ssn
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 8, 8, 3)).astype(np.float32))
    with torch.no_grad():
        out = tm(x)
        head = tm._head("ssn_factor", out.features)  # (1, 8, 8, rank * C)
    c, rank = 2, 3
    for h, w, cls, r in ((0, 0, 0, 0), (3, 5, 1, 2), (7, 2, 0, 1)):
        assert out.ssn_cov_factor[0, (h * 8 + w) * c + cls, r] == head[0, h, w, r * c + cls]
    np.testing.assert_array_equal(out.ssn_mean.numpy(), out.logits.reshape(1, -1).numpy())


def compare_config_with_jax(model: str) -> tuple:
    """The port's ``load_config(model=..., eu_method="none", precision="bf16")``
    against the JAX package's, field by field; (port config, fields compared)."""
    ref = j_load_config(data="lidc128", network="unet16", model=model, eu_method="none",
                        overrides=["trainer.precision=bf16"])
    got = tconfig.load_config(data="lidc128", network="unet16", model=model, eu_method="none",
                              precision="bf16")
    n_fields = 0
    for path in ("data", "data.augmentations", "network", "model", "model.diffusion",
                 "model.diffusion_sampling", "model.prob_unet", "eu_method", "trainer"):
        ours_group, theirs_group = got, ref
        for part in path.split("."):
            ours_group, theirs_group = getattr(ours_group, part), getattr(theirs_group, part)
        for f in dataclasses.fields(ours_group):
            if f.name == "augmentations":
                continue  # compared field by field as its own group
            ours, theirs = getattr(ours_group, f.name), getattr(theirs_group, f.name)
            assert _as_plain(ours) == _as_plain(theirs), f"{path}.{f.name}"
            n_fields += 1
    return got, n_fields


def test_ssn_config_matches_jax_load_config():
    got, n_fields = compare_config_with_jax("ssn")
    assert (got.model.au_type, got.model.ssn_rank, got.model.ssn_eps,
            got.model.ssn_pretrain_epochs) == ("ssn", 10, 1e-5, 10)
    assert n_fields == 51  # every field the port keeps was compared


def test_factory_builds_the_ssn_model_and_loads_the_asset_strictly():
    built = build_model(tconfig.load_config(model="ssn", eu_method="none"), device="cpu")
    jb = j_build_model(j_load_config(data="lidc128", network="unet16", model="ssn",
                                     eu_method="none"))
    assert (built.au_type, built.eu_type, built.is_generative) == (
        jb.au_type, jb.eu_type, jb.is_generative) == ("ssn", "none", True)
    m = built.module
    assert (m.ssn, m.ssn_rank, m.ssn_eps) == (jb.module.ssn, jb.module.ssn_rank,
                                              jb.module.ssn_eps)
    state = flax_to_torch(load_params_npz(ASSET))
    assert len(state) == len(np.load(ASSET).files) == 298
    assert set(state) == set(m.state_dict())
    load_into(m, ASSET)
    assert sum(isinstance(g, GroupNorm32) for g in m.modules()) == 58


@pytest.fixture(scope="module")
def unet16_ssn_outputs():
    """The full-width unet16 SSN with the trained asset at 32x32: JAX and port."""
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jb = j_build_model(j_load_config(data="lidc128", network="unet16", model="ssn",
                                     eu_method="none"))
    ref = jax.jit(jb.module.apply)(j_load_npz(ASSET), jnp.asarray(x))
    built = build_model(tconfig.load_config(model="ssn", eu_method="none"), device="cpu")
    load_into(built.module, ASSET)
    with torch.no_grad():
        got = built.module(torch.from_numpy(x))
    return ref, got


@pytest.mark.parametrize("field", ["ssn_mean", "ssn_cov_diag", "ssn_cov_factor"])
def test_unet16_ssn_forward_matches_jax_with_the_trained_asset(unet16_ssn_outputs, field):
    ref, got = unet16_ssn_outputs
    r, g = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
    assert g.shape == r.shape and g.shape[1] == 32 * 32 * 2
    assert np.abs(r).max() > 0.1  # trained heads, not a zero head
    np.testing.assert_allclose(g, r, **LOGITS_TOL)
    dist = t_ssn.build_distribution(got.ssn_mean, got.ssn_cov_diag, got.ssn_cov_factor)
    assert not dist.cov_failed.any()


def _small_pair(small_ssn, n_pred):
    jm, tm, params = small_ssn
    jb = JBuilt(module=jm, au_type="ssn", eu_type="none", is_generative=True, num_classes=2)
    tb = BuiltModel(module=tm, au_type="ssn", eu_type="none", is_generative=True, num_classes=2)
    spec = dict(n_pred=n_pred, n_members=1, member_mode="single")
    return (j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(**spec)),
            t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(**spec)), params)


def test_ssn_sampler_matches_jax_with_the_jax_draws(small_ssn, monkeypatch):
    """make_sampler, 3 samples x 2 images at 32x32: the JAX sampler draws
    from a pinned key; the port takes those normals and must give the same
    stack, singleton grouping, heatmaps and per-image metrics."""
    n_pred, b, hw = 3, 2, 32
    rng = np.random.default_rng(11)
    images = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    gt = (rng.random((b, 4, hw, hw)) < 0.3).astype(np.int32)
    j_fn, t_fn, params = _small_pair(small_ssn, n_pred)
    key = jax.random.key(9)
    j_sample_n = j_ssn.sample_n
    monkeypatch.setattr(j_ssn, "sample_n", lambda dist, rng_, s: j_sample_n(dist, key, s))
    ref = jax.jit(j_fn)(params, jnp.asarray(images), jax.random.key(0))
    shapes = inject_draws(monkeypatch, *jax_ssn_eps(key, n_pred, b, 3, hw * hw * 2))
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert shapes == [(n_pred, b, 3), (n_pred, b, hw * hw * 2)]
    assert tuple(t_fn.meta) == tuple(j_fn.meta) == (n_pred, 1, (True,) * n_pred)
    assert got.groups.shape == (n_pred, 1, b, hw, hw, 2)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5, err_msg=k)
    assert float(maps["EU"].mean()) > 1e-4  # the draws differ
    bm_ref = j_make_bm(num_classes=2, ignore_index=-1, meta=j_fn.meta,
                       compute_likelihood=False)(ref, jnp.asarray(gt))
    bm = make_batch_metrics(num_classes=2, ignore_index=-1)(got, torch.from_numpy(gt))
    for k in ("dice", "ged_bma", "ged", "max_dice_pred", "max_dice_gt", "major_dice"):
        np.testing.assert_allclose(bm[k].numpy(), np.asarray(bm_ref[k]), atol=1e-6, err_msg=k)


def test_ssn_sampler_draws_from_the_generator(small_ssn):
    _, t_fn, _ = _small_pair(small_ssn, 4)
    x = torch.randn(2, 16, 16, 3)
    a = t_fn(x, torch.Generator().manual_seed(0))
    b = t_fn(x, torch.Generator().manual_seed(0))
    c = t_fn(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.groups, b.groups, atol=0, rtol=0)
    assert not torch.equal(a.groups, c.groups)
    torch.testing.assert_close(a.groups.sum(-1), torch.ones(4, 1, 2, 16, 16))
