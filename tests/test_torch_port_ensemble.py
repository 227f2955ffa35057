"""Port parity of stacked-member execution (``member_mode="params_stack"``),
the sampler's grouping fields, the EU config groups and the factory's EU
type, against the JAX package on the same numpy inputs.

The stacked slice runs a narrow DiffUnet (2 levels, attention at the bottom)
at 32x32 with 3 members whose weights differ by random noise on every leaf
(a constant shift would hide member diversity), dropout live (p 0.2) and TTA
on. TTA matrices and dropout masks are injected as in test_torch_port_slice;
every member gets the same draws, since the JAX member body under
``lax.map`` or ``vmap`` is traced once and sees one set. The port draws per
member for all of its rows (``n_pred * B``), so its injected draws are the
JAX ones tiled over the rounds. Float32; stacks and heatmaps to 1e-5, meta
exactly. The whole path (the trained SWAG-diag moments drawn into members
by the port, at unet16's full width) is held against the JAX sampler on the
same member weights at 32x32.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.models import ssn as j_ssn
from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.ops.warp import separable_margins
from diffuncertainty_tpu.sampling import tta as j_tta
from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load_npz
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core import config as tconfig
from diffuncertainty_tpu_torch.core.params import (flax_to_torch, flax_to_torch_stacked,
                                                   load_swag_npz)
from diffuncertainty_tpu_torch.models import ssn as t_ssn
from diffuncertainty_tpu_torch.models.factory import BuiltModel, build_model
from diffuncertainty_tpu_torch.models.unet import ChannelDropout, DiffUnet
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from diffuncertainty_tpu_torch.sampling import tta as t_tta
from diffuncertainty_tpu_torch.tools.bench_assets import swag_draw_members
from test_torch_port_member_fold import family_models, run_both  # noqa: F401
from test_torch_port_model import _as_plain, jax_mask_interceptor, mask_for
from test_torch_port_slice import TTA, small_pair
from test_torch_port_ssn import SMALL_SSN, jax_ssn_eps
from test_torch_port_swag import port_key
from test_torch_port_warp_tta import inverse, tta_matrices
from torch_threads import one_torch_thread  # noqa: F401

HW = 32


def noisy_stack(params, members: int, seed: int = 1):
    """``members`` copies of ``params``, each with its own noise on every leaf."""
    rng = np.random.default_rng(seed)
    copies = [jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                           .astype(np.float32), params) for _ in range(members)]
    return jax.tree.map(lambda *xs: np.stack(xs), *copies)


def inject_tta_and_masks(monkeypatch, b: int):
    """The same TTA matrices and dropout masks for every member on both sides;
    the port's (rounds * B) rows take them tiled over the rounds."""
    rng = np.random.default_rng(7)
    fwd = tta_matrices(rng, b, HW, HW)
    inv = inverse(fwd)
    mx, my = separable_margins(22.5, 0.8, 1.2, True, HW, HW)

    def j_params(cfg, key, batch, h, w):
        assert (batch, h, w) == (b, HW, HW)
        return j_tta.TTAParams(jnp.asarray(fwd), jnp.asarray(inv), True, mx, my)

    def t_params(cfg, generator, batch, h, w):
        reps = batch // b
        assert batch == reps * b and (h, w) == (HW, HW)
        return t_tta.TTAParams(torch.from_numpy(np.tile(fwd, (reps, 1, 1))),
                               torch.from_numpy(np.tile(inv, (reps, 1, 1))), True, mx, my)

    def t_mask(self, shape, generator, device):
        rows, c = shape
        m = mask_for(self.path.replace(".", "/"), (b, c), self.rate)
        return torch.from_numpy(np.tile(m, (rows // b, 1))).to(device)

    monkeypatch.setattr(j_sampler_mod, "sample_tta_params", j_params)
    monkeypatch.setattr(t_sampler_mod, "sample_tta_params", t_params)
    monkeypatch.setattr(ChannelDropout, "draw_mask", t_mask)


def run_jax(jb, spec_kw, stack, images, intercept=True):
    j_fn = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(**spec_kw))

    @jax.jit
    def run(p, x, key):
        if not intercept:
            return j_fn(p, x, key)
        with nn.intercept_methods(jax_mask_interceptor):
            return j_fn(p, x, key)

    return j_fn, run(stack, jnp.asarray(images), jax.random.key(0))


def assert_stacks_match(got, ref, j_meta, t_meta):
    assert tuple(t_meta) == tuple(j_meta)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5, err_msg=k)
    return maps


@pytest.mark.parametrize("member_chunk", [1, None])
@pytest.mark.parametrize("n_pred", [1, 2])
def test_params_stack_matches_jax_member_execution(monkeypatch, member_chunk, n_pred):
    members, b = 3, 2
    jb, tb, params = small_pair(rate=0.2)
    stack = noisy_stack(params, members)
    images = np.random.default_rng(8).standard_normal((b, HW, HW, 3)).astype(np.float32)
    inject_tta_and_masks(monkeypatch, b)
    spec = dict(n_pred=n_pred, n_members=members, member_mode="params_stack", tta=True)
    j_fn, ref = run_jax(jb, dict(spec, member_chunk=member_chunk,
                                 tta_config=j_tta.TTAConfig(**TTA)), stack, images)
    t_fn = t_sampler_mod.make_sampler(
        tb, t_sampler_mod.SamplerSpec(**spec, tta_config=t_tta.TTAConfig(**TTA)),
        members=flax_to_torch_stacked(stack))
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert got.groups.shape == (members, n_pred, b, HW, HW, 2)
    assert tuple(t_fn.meta) == (members, n_pred, (False,) * members)
    maps = assert_stacks_match(got, ref, j_fn.meta, t_fn.meta)
    assert float(maps["EU"].mean()) > 1e-4
    for m in range(1, members):  # the members' weights give different stacks
        assert (got.groups[m] - got.groups[0]).abs().max() > 1e-3


@pytest.fixture(scope="module")
def ssn_pair():
    from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet

    jm = JDiffUnet(**SMALL_SSN)
    params = jax.jit(jm.init)({"params": jax.random.key(0)}, jnp.zeros((1, HW, HW, 3)))
    tm = DiffUnet(**SMALL_SSN)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    jb = JBuilt(module=jm, au_type="ssn", eu_type="ensemble", is_generative=True, num_classes=2)
    tb = BuiltModel(module=tm.eval(), au_type="ssn", eu_type="ensemble", is_generative=True,
                    num_classes=2)
    return jb, tb, params


GROUPING = {  # (model, n_members, tta, discretize, direct_au, external_generative_members)
    "softmax_plain_discretized": ("softmax", 3, False, True, False, 0),
    "softmax_tta_direct_au": ("softmax", 3, True, False, True, 0),
    "softmax_tta_one_member_with_external": ("softmax", 1, True, False, False, 1),
    "softmax_tta_one_member_discretized": ("softmax", 1, True, True, False, 0),
    "ssn_two_members": ("ssn", 2, False, False, False, 0),
    "ssn_two_members_direct_au_discretized": ("ssn", 2, False, True, True, 0),
}


@pytest.mark.parametrize("case", sorted(GROUPING))
def test_grouping_fields_match_jax(monkeypatch, ssn_pair, case):
    model, members, tta, discretize, direct_au, external = GROUPING[case]
    b, n_pred = 2, 2
    images = np.random.default_rng(9).standard_normal((b, HW, HW, 3)).astype(np.float32)
    spec = dict(n_pred=n_pred, n_members=members, member_mode="params_stack", tta=tta,
                discretize=discretize, direct_au=direct_au,
                external_generative_members=external)
    if model == "softmax":
        jb, tb, params = small_pair(rate=0.2)
        inject_tta_and_masks(monkeypatch, b)
        intercept = True
    else:
        jb, tb, params = ssn_pair
        key = jax.random.key(9)
        j_sample_n = j_ssn.sample_n
        monkeypatch.setattr(j_ssn, "sample_n", lambda dist, rng_, s: j_sample_n(dist, key, s))
        eps = jax_ssn_eps(key, n_pred, b, SMALL_SSN["ssn_rank"], HW * HW * 2)
        queue = [torch.from_numpy(e) for e in eps] * members
        monkeypatch.setattr(t_ssn, "draw_normal", lambda shape, gen, dtype: queue.pop(0))
        intercept = False
    stack = noisy_stack(params, members, seed=2)
    j_fn, ref = run_jax(jb, dict(spec, member_chunk=1, tta_config=j_tta.TTAConfig(**TTA)),
                        stack, images, intercept)
    t_fn = t_sampler_mod.make_sampler(
        tb, t_sampler_mod.SamplerSpec(**spec, tta_config=t_tta.TTAConfig(**TTA)),
        members=flax_to_torch_stacked(stack))
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert got.groups.shape[0] == t_fn.meta.n_groups
    assert got.groups.shape[1] == t_fn.meta.samples_per_group
    assert_stacks_match(got, ref, j_fn.meta, t_fn.meta)
    if discretize:
        assert set(np.unique(got.groups.numpy())) <= {0.0, 1.0}


def test_prob_unet_stack_decodes_with_each_members_weights(monkeypatch):
    """A 2-member prob-U-Net stack: the decode runs on the member's fcomb
    (``functional_call`` on a method other than forward); latents injected."""
    import diffuncertainty_tpu.models.prob_unet as jpu
    from diffuncertainty_tpu.models.prob_unet import ProbUnetSpec as JProbUnetSpec
    from diffuncertainty_tpu_torch.core.specs import ProbUnetSpec
    from diffuncertainty_tpu_torch.models import prob_unet as tpu
    from test_torch_port_prob_unet import SMALL, SPEC

    members, b, n_pred = 2, 2, 2
    jm = jpu.build_prob_unet(dict(SMALL), JProbUnetSpec(**SPEC))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                              jnp.zeros((1, HW, HW, 2)), jnp.zeros((1, 6)))
    tm = tpu.build_prob_unet(dict(SMALL), ProbUnetSpec(**SPEC)).eval()
    stack = noisy_stack(params, members, seed=3)
    rng = np.random.default_rng(12)
    images = rng.standard_normal((b, HW, HW, 3)).astype(np.float32)
    eps = rng.standard_normal((b, 6)).astype(np.float32)
    monkeypatch.setattr(j_sampler_mod, "sample_latent",
                        lambda prior, key: prior.mu + prior.sigma * jnp.asarray(eps))
    monkeypatch.setattr(t_sampler_mod, "sample_latent", lambda prior, generator: (
        prior.mu + prior.sigma * torch.from_numpy(np.tile(eps, (n_pred, 1)))))
    spec = dict(n_pred=n_pred, n_members=members, member_mode="params_stack")
    jb = JBuilt(module=jm, au_type="prob_unet", eu_type="ensemble", is_generative=True,
                num_classes=2)
    tb = BuiltModel(module=tm, au_type="prob_unet", eu_type="ensemble", is_generative=True,
                    num_classes=2)
    j_fn, ref = run_jax(jb, dict(spec, member_chunk=1), stack, images, intercept=False)
    t_fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(**spec),
                                      members=flax_to_torch_stacked(stack))
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert got.groups.shape == (members, n_pred, b, HW, HW, 2)
    assert_stacks_match(got, ref, j_fn.meta, t_fn.meta)
    assert (got.groups[1] - got.groups[0]).abs().max() > 1e-3


@pytest.mark.parametrize("model", ["softmax", "diffusion", "ssn", "prob_unet"])
def test_a_stack_of_the_modules_own_weights_equals_the_single_member_path(model):
    """One member holding the module's own weights, through
    ``functional_call``, gives exactly the single-member stack from the same
    generator seed (unet16 at 16x16, random weights)."""
    eu = "dropout" if model == "softmax" else "none"
    built = build_model(tconfig.load_config(model=model, eu_method=eu), device="cpu")
    spec = dict(n_pred=2, n_members=1, tta=model == "softmax",
                tta_config=t_tta.TTAConfig(**TTA), diffusion_num_steps=2)
    single = t_sampler_mod.make_sampler(built, t_sampler_mod.SamplerSpec(**spec))
    own = {k: v[None] for k, v in built.module.state_dict().items()}
    stacked = t_sampler_mod.make_sampler(
        built, t_sampler_mod.SamplerSpec(**spec, member_mode="params_stack"), members=own)
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(3))
    a = single(x, torch.Generator().manual_seed(4))
    b = stacked(x, torch.Generator().manual_seed(4))
    assert tuple(single.meta) == tuple(stacked.meta) == (2, 1, (model != "softmax",) * 2)
    torch.testing.assert_close(b.groups, a.groups, atol=0, rtol=0)


def test_each_member_takes_fresh_tta_and_dropout_draws_from_one_generator(monkeypatch):
    """Members with equal weights differ only by their draws: every member
    must take its own TTA params and dropout masks from the one generator."""
    _, tb, params = small_pair(rate=0.2)
    members = 4
    same = jax.tree.map(lambda a: np.stack([np.asarray(a)] * members), params)
    tta_draws, masks = [], []
    sample_tta = t_sampler_mod.sample_tta_params
    draw_mask = ChannelDropout.draw_mask

    def record_tta(*args):
        tta_draws.append(sample_tta(*args))
        return tta_draws[-1]

    def record_mask(self, shape, generator, device):
        masks.append((self.path, draw_mask(self, shape, generator, device)))
        return masks[-1][1]

    monkeypatch.setattr(t_sampler_mod, "sample_tta_params", record_tta)
    monkeypatch.setattr(ChannelDropout, "draw_mask", record_mask)
    spec = t_sampler_mod.SamplerSpec(n_pred=1, n_members=members, member_mode="params_stack",
                                     tta=True, tta_config=t_tta.TTAConfig(**TTA))
    fn = t_sampler_mod.make_sampler(tb, spec, members=flax_to_torch_stacked(same))
    x = torch.randn(2, HW, HW, 3)
    a = fn(x, torch.Generator().manual_seed(0))
    assert len(tta_draws) == members
    for m in range(1, members):
        assert not torch.equal(tta_draws[m].forward, tta_draws[0].forward)
    per_member = len(masks) // members
    assert per_member > 0 and len(masks) == members * per_member
    first, second = masks[:per_member], masks[per_member:2 * per_member]
    assert [p for p, _ in first] == [p for p, _ in second]
    assert any(not torch.equal(m0, m1) for (_, m0), (_, m1) in zip(first, second))
    for m in range(1, members):
        assert (a.groups[m] - a.groups[0]).abs().max() > 1e-3
    b = fn(x, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.groups, b.groups, atol=0, rtol=0)
    maps = uncertainty_heatmaps(a.group_means, sample_axis=0, class_axis=-1)
    assert float(maps["EU"].mean()) > 1e-4


def test_sampler_refuses_a_missing_or_misshapen_stack_and_unported_options(monkeypatch,
                                                                          family_models):
    """A missing, misshapen or misplaced stack and an unknown mode raise; the
    modes that raised before they were ported (``same_dropout``,
    ``member_fold``, an integer ``member_chunk``, None with
    ``params_stack``, ``flat_fold=False``) each give the JAX sampler's stack
    of the same members and draws, with the JAX grouping of the same mode
    (softmax + TTA, dropout live, every draw injected on both sides;
    ``test_torch_port_member_fold.run_both``)."""
    _, tb, params = small_pair(rate=0.2)
    stack = flax_to_torch_stacked(noisy_stack(params, 3))
    spec = t_sampler_mod.SamplerSpec(n_pred=1, n_members=3, member_mode="params_stack")
    with pytest.raises(ValueError, match="needs the member stack"):
        t_sampler_mod.make_sampler(tb, spec)
    with pytest.raises(ValueError, match="leading dimension must be n_members"):
        t_sampler_mod.make_sampler(tb, dataclasses.replace(spec, n_members=2), members=stack)
    with pytest.raises(ValueError, match="was given for member_mode 'dropout'"):
        t_sampler_mod.make_sampler(tb, dataclasses.replace(spec, member_mode="dropout"),
                                   members=stack)
    with pytest.raises(KeyError, match="missing"):
        t_sampler_mod.make_sampler(tb, spec, members={k: v for k, v in stack.items()
                                                      if k != "input_conv.bias"})
    with pytest.raises(ValueError, match="unknown member_mode"):
        t_sampler_mod.make_sampler(tb, dataclasses.replace(spec, member_mode="vmap"))
    for field, value in (("same_dropout", True), ("member_fold", True), ("member_chunk", 2),
                         ("member_chunk", 1), ("member_chunk", None), ("flat_fold", False)):
        run_both(monkeypatch, family_models, "softmax", {field: value})


@pytest.mark.parametrize("eu_method", ["ensemble", "swag", "swag_diag"])
def test_eu_config_groups_match_jax_load_config(eu_method):
    ref = j_load_config(data="lidc128", network="unet16", model="softmax", eu_method=eu_method)
    got = tconfig.load_config(data="lidc128", network="unet16", model="softmax",
                              eu_method=eu_method)
    n_fields = 0
    for path in ("network", "model", "eu_method", "eu_method.swag", "eu_method.dropout"):
        ours_group, theirs_group = got, ref
        for part in path.split("."):
            ours_group, theirs_group = getattr(ours_group, part), getattr(theirs_group, part)
        for f in dataclasses.fields(ours_group):
            ours, theirs = getattr(ours_group, f.name), getattr(theirs_group, f.name)
            assert _as_plain(ours) == _as_plain(theirs), f"{path}.{f.name}"
            n_fields += 1
    assert got.eu_method.swag.enabled == (eu_method != "ensemble")
    assert n_fields == 22 + 9 + 4 + 5 + 8  # every field the port keeps was compared


@pytest.mark.parametrize("model,eu_method", [
    ("softmax", "none"), ("softmax", "dropout"), ("softmax", "ensemble"),
    ("softmax", "swag"), ("softmax", "swag_diag"), ("ssn", "swag_diag"),
    ("diffusion", "ensemble"), ("prob_unet", "swag")])
def test_factory_eu_type_matches_jax(model, eu_method):
    got = build_model(tconfig.load_config(model=model, eu_method=eu_method), device="cpu")
    ref = j_build_model(j_load_config(model=model, eu_method=eu_method))
    assert (got.au_type, got.eu_type, got.is_generative) == (ref.au_type, ref.eu_type,
                                                             ref.is_generative)


def test_factory_infers_subensemble_and_rejects_conflicting_indicators():
    for name in ("subensemble", "ensemble"):
        cfg = tconfig.load_config(eu_method="none")
        cfg = dataclasses.replace(cfg, eu_method=dataclasses.replace(cfg.eu_method, name=name))
        jcfg = j_load_config(eu_method="none")
        jcfg.eu_method = dataclasses.replace(jcfg.eu_method, name=name)
        assert build_model(cfg, device="cpu").eu_type == j_build_model(jcfg).eu_type == name
    cfg = tconfig.load_config(eu_method="swag")
    cfg = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, dropout=0.2))
    with pytest.raises(ValueError, match="Conflicting EU indicators"):
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="Conflicting EU indicators"):
        j_build_model(j_load_config(eu_method="swag", overrides=["network.dropout=0.2"]))


def stack_to_flax(stack: dict, like: dict) -> dict:
    """The port's (M, ...) member stack as a flax tree shaped like ``like``
    (the inverse of ``flax_to_torch_stacked``)."""
    def leaf(path, _):
        v = stack[port_key(path)].numpy()
        if v.ndim == 5:  # (M, O, I, H, W) -> (M, H, W, I, O)
            return v.transpose(0, 3, 4, 2, 1)
        return v.transpose(0, 2, 1) if v.ndim == 3 else v

    return jax.tree_util.tree_map_with_path(leaf, like)


def test_bench_ensemble_path_matches_jax_with_the_trained_swag_moments(monkeypatch):
    """The whole path at unet16's full width, 2 members at 32x32, 1 image:
    the SWAG-diag asset drawn into members by the port (its draw is held to
    JAX in test_torch_port_swag), bench.py's config with dropout live, TTA,
    params_stack; the JAX sampler runs on the same member weights."""
    members, b = 2, 1
    moments = load_swag_npz("assets/bench_unet16_toy128_swag.npz")
    t_stack = swag_draw_members(moments.mean, moments.std, torch.Generator().manual_seed(42),
                                members)
    asset = j_load_npz("assets/bench_unet16_toy128_swag.npz")
    j_stack = {"params": stack_to_flax(t_stack, asset["mean"]["params"])}
    assert flax_to_torch_stacked(j_stack).keys() == t_stack.keys()
    images = np.random.default_rng(10).standard_normal((b, HW, HW, 3)).astype(np.float32)
    inject_tta_and_masks(monkeypatch, b)
    spec = dict(n_pred=1, n_members=members, member_mode="params_stack", tta=True)
    jb = j_build_model(j_load_config(data="lidc128", network="unet16", model="softmax",
                                     eu_method="dropout"))
    j_fn, ref = run_jax(jb, dict(spec, member_chunk=1, tta_config=j_tta.TTAConfig(**TTA)),
                        j_stack, images)
    built = build_model(tconfig.load_config(eu_method="dropout"), device="cpu")
    t_fn = t_sampler_mod.make_sampler(
        built, t_sampler_mod.SamplerSpec(**spec, tta_config=t_tta.TTAConfig(**TTA)),
        members=t_stack)
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert tuple(t_fn.meta) == (members, 1, (False,) * members)
    assert_stacks_match(got, ref, j_fn.meta, t_fn.meta)
    assert (got.groups[1] - got.groups[0]).abs().max() > 1e-3
