"""Port parity of the diffusion slice: time embedding, schedule constants,
prediction parameterizations, the reverse samplers, the time-conditioned
unet16 forward and the whole DDIM sampler, each against the JAX package on
the same numpy inputs.

Tolerances (float32 on the CPU unless stated):
- timestep embedding and predictions 1e-6 (a few f32 ops on O(1) values);
- step constants 1e-7: the same float64 numpy code, cast to float32;
- sample loops with a fixed linear model 1e-6;
- the full-width unet16 diffusion forward with the trained asset at 32x32:
  logits atol 1e-5 with rtol 1e-4, the PR 4 model tolerance, softmax 1e-5;
- the whole DDIM-10 slice: probabilities 1e-5, Dice/GED 1e-6.
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
from diffuncertainty_tpu.models.diffusion import ContinuousGaussianDiffusion as JDiffusion
from diffuncertainty_tpu.models.diffusion import GammaSchedule as JGamma
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.ops.time_embed import timestep_embedding as j_temb
from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load_npz
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core import config as tconfig
from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_into, load_params_npz
from diffuncertainty_tpu_torch.infer.batch_metrics import make_batch_metrics
from diffuncertainty_tpu_torch.models.diffusion import ContinuousGaussianDiffusion, GammaSchedule
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.unet import DiffUnet, UnetOutput
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from diffuncertainty_tpu_torch.ops.time_embed import timestep_embedding
from test_torch_port_model import UNET16, _as_plain
from torch_threads import one_torch_thread  # noqa: F401

ASSET = "assets/bench_unet16_toy128_diffusion.npz"
UNET16_DIFF = dict(UNET16, in_channels=5, diffusion=True)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches_jax(rng, dim):
    t = rng.random(7).astype(np.float32)
    ref = j_temb(jnp.asarray(t), dim)
    got = timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == (7, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("num_steps", [10, 3])
@pytest.mark.parametrize("var_type", ["small", "large"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "linear_simple", "parabola"])
def test_step_constants_match_jax(schedule, var_type, num_steps):
    kw = dict(schedule_name=schedule, var_type=var_type)
    ref = JDiffusion(**kw)._step_constants(num_steps)
    got = ContinuousGaussianDiffusion(**kw)._step_constants(num_steps)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], ref[k], atol=1e-7, rtol=0, err_msg=k)
    jg, tg = JGamma(schedule), GammaSchedule(schedule)
    assert tg.slope_bias == jg._slope_bias
    ts = np.linspace(0.0, 1.0, 11)
    np.testing.assert_allclose(tg.logsnr_np(ts), jg.logsnr_np(ts), atol=1e-12, rtol=0)
    assert tg.logsnr_np(0.0) == pytest.approx(10.0) and tg.logsnr_np(1.0) == pytest.approx(-10.0)


def test_unported_schedule_raises():
    """Every schedule of the JAX package is ported; a name neither knows
    raises on both sides."""
    with pytest.raises(NotImplementedError, match="quartic"):
        JGamma("quartic").gamma_np(0.5)
    with pytest.raises(NotImplementedError, match="quartic"):
        GammaSchedule("quartic").gamma_np(0.5)


@pytest.mark.parametrize("clip_x", [False, True])
@pytest.mark.parametrize("pred_type", ["EPS", "X", "BOTH", "V"])
def test_get_predictions_match_jax(rng, pred_type, clip_x):
    b, c = 3, 2
    x_t = rng.standard_normal((b, 5, 4, c)).astype(np.float32)
    out_c = 2 * c if pred_type == "BOTH" else c
    output = rng.standard_normal((b, 5, 4, out_c)).astype(np.float32)
    g = GammaSchedule().gamma_np(rng.random(b))
    alpha, sigma = np.sqrt(g).astype(np.float32), np.sqrt(1 - g).astype(np.float32)
    ref = JDiffusion(model_pred_type=pred_type).get_predictions(
        jnp.asarray(output), jnp.asarray(x_t), jnp.asarray(alpha), jnp.asarray(sigma), clip_x)
    got = ContinuousGaussianDiffusion(model_pred_type=pred_type).get_predictions(
        torch.from_numpy(output), torch.from_numpy(x_t), torch.from_numpy(alpha),
        torch.from_numpy(sigma), clip_x)
    for r, o, name in zip(ref, got, ("pred_x", "pred_eps")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6, err_msg=name)


def _linear_model(rng, cin, cout):
    """A fixed linear map of (x, t), squashed by tanh so x_0 stays bounded."""
    w = (0.3 * rng.standard_normal((cin, cout))).astype(np.float32)
    v = rng.standard_normal(cout).astype(np.float32)
    j_fn = lambda x, t: jnp.tanh(x @ jnp.asarray(w) + t[:, None, None, None] * jnp.asarray(v))
    t_fn = lambda x, t, gen: torch.tanh(x @ torch.from_numpy(w) + t[:, None, None, None]
                                        * torch.from_numpy(v))
    return j_fn, t_fn


@pytest.mark.parametrize("sampler_type", ["ddim", "ddpm"])
def test_sample_loop_matches_jax_with_a_fixed_linear_model(rng, sampler_type):
    b, hw, c, steps = 2, 6, 2, 10
    x_init = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    im = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    j_fn, t_fn = _linear_model(rng, c + 3, c)
    key = jax.random.key(5)
    diff_kw = dict(model_pred_type="X", var_type="large")
    ref = JDiffusion(**diff_kw).sample_loop(j_fn, jnp.asarray(x_init), jnp.asarray(im), steps,
                                            key, sampler_type=sampler_type)
    # the JAX scan splits (key, noise, model) = split(key, 3) at every step
    noise, k = [], key
    for _ in range(steps):
        k, knoise, _ = jax.random.split(k, 3)
        noise.append(np.array(jax.random.normal(knoise, x_init.shape, jnp.float32)))
    used = []

    def noise_fn(step, shape):
        used.append(step)
        return torch.from_numpy(noise[step])

    got = ContinuousGaussianDiffusion(**diff_kw).sample_loop(
        t_fn, torch.from_numpy(x_init), torch.from_numpy(im), steps, torch.Generator(),
        sampler_type=sampler_type, noise_fn=noise_fn)
    assert used == (list(range(steps)) if sampler_type == "ddpm" else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_sample_loop_feeds_concat_x_t_then_image_with_step_times(rng):
    """The model sees ``concat([x_t, im], -1)`` and t = (i+1)/N, as in JAX."""
    b, hw, c, steps = 2, 4, 2, 3
    x_init = rng.standard_normal((b, hw, hw, c)).astype(np.float32)
    im = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    j_fn, t_fn = _linear_model(rng, c + 3, c)
    seen_j, seen_t = [], []

    def j_rec(x, t):
        seen_j.append((np.asarray(x), np.asarray(t)))
        return j_fn(x, t)

    def t_rec(x, t, gen):
        seen_t.append((x.numpy().copy(), t.numpy().copy()))
        return t_fn(x, t, gen)

    with jax.disable_jit():
        JDiffusion().sample_loop(j_rec, jnp.asarray(x_init), jnp.asarray(im), steps,
                                 jax.random.key(0), sampler_type="ddim")
    ContinuousGaussianDiffusion().sample_loop(t_rec, torch.from_numpy(x_init),
                                              torch.from_numpy(im), steps, torch.Generator(),
                                              sampler_type="ddim")
    assert len(seen_j) == len(seen_t) == steps
    np.testing.assert_array_equal(seen_t[0][0][..., :c], x_init)
    np.testing.assert_array_equal(seen_t[0][0][..., c:], im)
    for (xj, tj), (xt, tt), i in zip(seen_j, seen_t, range(steps - 1, -1, -1)):
        np.testing.assert_allclose(xt, xj, atol=1e-6)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(tt, np.full(b, (i + 1) / steps, np.float32))


def test_diffusion_config_matches_jax_load_config():
    ref = j_load_config(data="lidc128", network="unet16", model="diffusion", eu_method="none",
                        overrides=["trainer.precision=bf16"])
    got = tconfig.load_config(data="lidc128", network="unet16", model="diffusion",
                              eu_method="none", precision="bf16")
    n_fields = 0
    for path in ("data", "data.augmentations", "network", "model", "model.diffusion",
                 "model.diffusion_sampling", "eu_method", "trainer"):
        ours_group, theirs_group = got, ref
        for part in path.split("."):
            ours_group, theirs_group = getattr(ours_group, part), getattr(theirs_group, part)
        for f in dataclasses.fields(ours_group):
            if f.name == "augmentations":
                continue  # compared field by field as its own group
            ours, theirs = getattr(ours_group, f.name), getattr(theirs_group, f.name)
            assert _as_plain(ours) == _as_plain(theirs), f"{path}.{f.name}"
            n_fields += 1
    assert got.network.final_act == "softmax" and got.model.au_type == "diffusion"
    assert n_fields == 84  # every field the port keeps was compared


def test_factory_builds_the_diffusion_model():
    built = build_model(tconfig.load_config(model="diffusion", eu_method="none"), device="cpu")
    jb = j_build_model(j_load_config(model="diffusion", eu_method="none"))
    assert built.module.input_conv.weight.shape[1] == jb.module.in_channels == 5
    assert (built.au_type, built.eu_type, built.is_generative) == (jb.au_type, jb.eu_type,
                                                                    jb.is_generative)
    assert (built.diffusion_num_steps, built.diffusion_sampler_type) == (
        jb.diffusion_num_steps, jb.diffusion_sampler_type)
    assert dataclasses.asdict(built.diffusion) == dataclasses.asdict(jb.diffusion)
    assert built.dropout_spec.max_rate == 0.0


def test_param_bridge_maps_every_diffusion_asset_key():
    flat = np.load(ASSET).files
    state = flax_to_torch(load_params_npz(ASSET))
    assert len(state) == len(flat) == 338
    module = DiffUnet(**UNET16_DIFF, final_act="softmax")
    expected = module.state_dict()
    assert set(state) == set(expected)
    for k, v in state.items():
        assert v.shape == expected[k].shape, k
    assert {k for k in state if "time_embed" in k} == {
        "time_embed_0.weight", "time_embed_0.bias", "time_embed_1.weight", "time_embed_1.bias"}
    assert sum(k.endswith("emb_proj.weight") for k in state) == 22  # every ResBlock


@pytest.fixture(scope="module")
def diffusion_inputs():
    rng = np.random.default_rng(0)
    x_t = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    im = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return np.concatenate([x_t, im], -1), np.array([0.9, 0.35], np.float32), j_load_npz(ASSET)


@pytest.mark.parametrize("final_act", ["none", "softmax"])
def test_unet16_diffusion_forward_matches_jax(diffusion_inputs, final_act):
    x, t, params = diffusion_inputs
    jm = JDiffUnet(**UNET16_DIFF, final_act=final_act)
    ref = np.asarray(jax.jit(lambda p, xx, tt: jm.apply(p, xx, tt).logits)(
        params, jnp.asarray(x), jnp.asarray(t)))
    module = load_into(DiffUnet(**UNET16_DIFF, final_act=final_act), ASSET)
    with torch.no_grad():
        got = module(torch.from_numpy(x), timesteps=torch.from_numpy(t)).logits.numpy()
        scalar = module(torch.from_numpy(x), timesteps=float(t[0])).logits.numpy()
        same_t = module(torch.from_numpy(x),
                        timesteps=torch.full((2,), float(t[0]))).logits.numpy()
    if final_act == "none":
        assert np.abs(ref).max() > 1.0  # trained weights, not a zero head
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(scalar, same_t)  # a scalar t broadcasts to (B,)


def test_diffusion_forward_needs_timesteps_and_softmax_rejects_them():
    module = DiffUnet(**UNET16_DIFF)
    with pytest.raises(ValueError, match="timesteps must be provided"):
        module(torch.zeros(1, 16, 16, 5))
    with pytest.raises(ValueError, match="timesteps must be None"):
        DiffUnet(**UNET16)(torch.zeros(1, 16, 16, 3), timesteps=torch.zeros(1))


def test_scale_shift_norm_branch_matches_jax(rng):
    """``use_scale_shift_norm``: GN without act, * (1 + scale) + shift, SiLU.
    A narrow two-level net with random weights (noise on every leaf)."""
    kw = dict(in_channels=5, out_channels=2, model_channels=32, num_res_blocks=(1, 1),
              num_middle_res_blocks=2, attention_resolutions=(-1,), channel_mult=(1, 2),
              num_heads=4, diffusion=True, use_scale_shift_norm=True)
    jm = JDiffUnet(**kw)
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    t = np.array([0.2, 0.8], np.float32)
    params = jm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(t))
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t)).logits)
    tm = DiffUnet(**kw)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    assert tm.enc0_res.emb_proj.weight.shape == (64, 128)  # scale and shift
    assert tm.enc0_res.out_norm.act == "none"
    with torch.no_grad():
        got = tm(torch.from_numpy(x), timesteps=torch.from_numpy(t)).logits.numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def _slice_pair(n_pred, b, hw):
    cfg_j = j_load_config(data="lidc128", network="unet16", model="diffusion", eu_method="none")
    jb = j_build_model(cfg_j)
    tb = build_model(tconfig.load_config(model="diffusion", eu_method="none"), device="cpu")
    load_into(tb.module, ASSET)
    spec = dict(n_pred=n_pred, n_members=1, member_mode="single", diffusion_sampler="ddim",
                diffusion_num_steps=10)
    return (jb, j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(**spec)),
            tb, t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(**spec)))


def test_slice_ddim10_matches_jax_with_injected_start_noise(monkeypatch):
    """make_sampler DDIM-10, 2 trajectories x 2 images at 32x32, trained
    weights: the port starts from the JAX draw of x_init and must give the
    same stack, heatmaps and per-image metrics."""
    n_pred, b, hw = 2, 2, 32
    rng = np.random.default_rng(11)
    images = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    gt = (rng.random((b, 4, hw, hw)) < 0.3).astype(np.int32)
    jb, j_fn, tb, t_fn = _slice_pair(n_pred, b, hw)
    params = j_load_npz(ASSET)
    key = jax.random.key(3)
    ref = jax.jit(j_fn)(params, jnp.asarray(images), key)
    # the JAX flat path: k_init, k_loop = split(key); x_init ~ N(0,1) from k_init
    x_init = np.array(jax.random.normal(jax.random.split(key)[0], (n_pred * b, hw, hw, 2)))
    drawn = []

    def injected(shape, generator, dtype):
        drawn.append(shape)
        return torch.from_numpy(x_init).to(dtype)

    monkeypatch.setattr(t_sampler_mod, "initial_noise", injected)
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert drawn == [(n_pred * b, hw, hw, 2)]
    assert tuple(t_fn.meta) == tuple(j_fn.meta)
    assert got.groups.shape == (n_pred, 1, b, hw, hw, 2)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5, err_msg=k)
    assert float(maps["EU"].mean()) > 1e-5  # trajectories differ
    bm_ref = j_make_bm(num_classes=2, ignore_index=-1, meta=j_fn.meta,
                       compute_likelihood=False)(ref, jnp.asarray(gt))
    bm = make_batch_metrics(num_classes=2, ignore_index=-1)(got, torch.from_numpy(gt))
    for k in ("dice", "ged_bma", "ged", "max_dice_pred", "max_dice_gt", "major_dice"):
        np.testing.assert_allclose(bm[k].numpy(), np.asarray(bm_ref[k]), atol=1e-6, err_msg=k)


def test_flat_diffusion_rows_are_trajectory_major(monkeypatch):
    """Row r*B + i of the folded batch is trajectory r of image i: the model
    sees image i there, and the output reshapes to (M, S, B, ...)."""
    n_pred, b, hw = 3, 2, 8
    tb = build_model(tconfig.load_config(model="diffusion", eu_method="none"), device="cpu")
    images = torch.arange(b, dtype=torch.float32)[:, None, None, None].expand(b, hw, hw, 3) + 1
    seen = []

    def fake_forward(x, generator=None, timesteps=None):
        seen.append(x.clone())
        # an x_0 prediction that names its row: p(class 1) = row index / 100
        rows = torch.arange(x.shape[0], dtype=x.dtype)[:, None, None, None] / 100
        return UnetOutput(logits=torch.cat([1 - rows, rows], -1).expand(x.shape[:3] + (2,)))

    monkeypatch.setattr(tb.module, "forward", fake_forward)
    fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
        n_pred=n_pred, diffusion_sampler="ddim", diffusion_num_steps=2))
    stack = fn(images, torch.Generator().manual_seed(0))
    assert len(seen) == 2
    for r in range(n_pred):
        for i in range(b):
            assert torch.all(seen[0][r * b + i, ..., 2:] == i + 1)
            assert stack.groups[r, 0, i, 0, 0, 1].item() == pytest.approx((r * b + i) / 100)


def test_quality_eval_scores_only_the_first_images():
    """``num_images=32`` scores the first two batches of 16: the 32-image
    split the JAX package's diffusion quality was first measured on."""
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    calls = []

    def sampler(images, generator):
        calls.append(images.shape[0])
        p1 = torch.sigmoid(4.0 * images[..., :1])
        groups = torch.cat([1 - p1, p1], -1)[None, None].expand(2, 1, *p1.shape[:3], 2)
        return t_sampler_mod.PredictionStack(groups, groups.mean(1), groups.mean((0, 1)))

    tb = build_model(tconfig.load_config(model="diffusion", eu_method="none"), device="cpu")
    data = tconfig.load_config().data
    first = toy128_quality_eval(tb, sampler, data, batch=16, hw=32, device="cpu", num_images=32)
    assert calls == [16, 16]
    every = toy128_quality_eval(tb, sampler, data, batch=16, hw=32, device="cpu")
    assert len(calls) == 2 + 16
    assert set(first) == set(every) == {"dice", "ged_bma", "aurc", "ece"}
    assert first != every


def test_diffusion_ignores_tta_as_the_jax_sampler_does(monkeypatch):
    """The JAX sampler never applies TTA on the diffusion path (it ignores
    ``spec.tta`` there). With tta=True, trained weights, DDIM-2, 2
    trajectories x 2 images at 16x16 and the JAX draw of x_init injected,
    the port gives the JAX sampler's grouping and stack, and from the same
    generator exactly its own tta=False stack."""
    from diffuncertainty_tpu.sampling.tta import TTAConfig as JTTAConfig
    from diffuncertainty_tpu_torch.sampling.tta import TTAConfig

    n_pred, b, hw = 2, 2, 16
    tta = dict(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2))
    tb = build_model(tconfig.load_config(model="diffusion", eu_method="none"), device="cpu")
    load_into(tb.module, ASSET)
    jb = j_build_model(j_load_config(data="lidc128", network="unet16", model="diffusion",
                                     eu_method="none"))
    images = np.random.default_rng(5).standard_normal((b, hw, hw, 3)).astype(np.float32)
    key = jax.random.key(7)
    x_init = np.array(jax.random.normal(jax.random.split(key)[0], (n_pred * b, hw, hw, 2)))
    monkeypatch.setattr(t_sampler_mod, "initial_noise",
                        lambda shape, generator, dtype: torch.from_numpy(x_init).to(dtype))
    stacks = {}
    for flag in (False, True):
        spec = dict(n_pred=n_pred, diffusion_sampler="ddim", diffusion_num_steps=2, tta=flag)
        fn = t_sampler_mod.make_sampler(
            tb, t_sampler_mod.SamplerSpec(**spec, tta_config=TTAConfig(**tta)))
        stacks[flag] = fn(torch.from_numpy(images), torch.Generator().manual_seed(7))
    j_fn = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(
        n_pred=n_pred, diffusion_sampler="ddim", diffusion_num_steps=2, tta=True,
        tta_config=JTTAConfig(**tta)))
    ref = jax.jit(j_fn)(j_load_npz(ASSET), jnp.asarray(images), key)
    assert tuple(fn.meta) == tuple(j_fn.meta) == (n_pred, 1, (True, True))
    assert stacks[True].groups.shape == (n_pred, 1, b, hw, hw, 2)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(stacks[True], k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
        torch.testing.assert_close(getattr(stacks[True], k), getattr(stacks[False], k),
                                   atol=0, rtol=0)
