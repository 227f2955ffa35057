"""Port parity of member-folded execution: ``ops/member_fold.py``, the
``(M, C)`` GroupNorm affine and its VJP, ``DiffUnet(members=M)``, every
member strategy of the sampler (``member_chunk`` 1, 2 and None,
``member_fold``, ``same_dropout``, ``flat_fold=False``) for softmax + TTA,
diffusion and the SSN, and the inference job's deep ensemble under
``member_chunk`` 2 and None, against the JAX package on the same
numpy inputs and weights.

Members differ by random weights on every leaf (a constant shift, or the
flax init's zero output convs, would hide member diversity). Every draw is
injected on both sides: TTA matrices, dropout masks, the diffusion start
noise and the SSN normals are fixed arrays for B images, tiled over however
many rows a draw covers (the JAX nested path draws for B rows per traced
member and round, its flat path and the port's blocks for all their rows).
The draws the JAX nested path makes are traced once per member body, so
these injected ones are what every member and round sees on both sides.
Float32 on the CPU: logits atol 1e-5 with rtol 1e-4 (the repo's model
tolerance), probabilities, heatmaps and metrics 1e-5.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.ops.member_fold as j_mf
import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.models import ssn as j_ssn
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.unet import ChannelDropout as JChannelDropout
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.ops.norm import group_norm_32 as j_group_norm_32
from diffuncertainty_tpu.ops.warp import separable_margins
from diffuncertainty_tpu.sampling import tta as j_tta
import diffuncertainty_tpu_torch.ops.member_fold as t_mf
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core.config import load_config
from diffuncertainty_tpu_torch.core.params import flax_to_torch_stacked
from diffuncertainty_tpu_torch.models import ssn as t_ssn
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.unet import ChannelDropout, DiffUnet
from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from diffuncertainty_tpu_torch.ops.norm import group_norm_32
from diffuncertainty_tpu_torch.sampling import tta as t_tta
from test_torch_port_model import mask_for
from test_torch_port_warp_tta import inverse, tta_matrices
from torch_threads import one_torch_thread  # noqa: F401

HW, B, M, S = 16, 2, 3, 2
LOGITS_TOL = dict(atol=1e-5, rtol=1e-4)
TINY = ["network.model_channels=8", "network.num_res_blocks=[1,1]",
        "network.channel_mult=[1,2]", "network.attention_resolutions=[-1]",
        "network.num_heads=2"]
TTA = dict(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2))


def member_variables(module, inputs, members: int, seed: int) -> dict:
    """``members`` random flax variable trees on the shapes of
    ``module.init``, stacked on a leading axis: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(module.init, {"params": jax.random.key(0),
                                          "dropout": jax.random.key(1)}, *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal((members,) + leaf.shape, dtype=np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return (1.0 if name == "scale" else 0.0) + np.float32(0.1) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---- ops -------------------------------------------------------------------

@pytest.mark.parametrize("formulation", ["im2col", "taps"])
@pytest.mark.parametrize("kh,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0)])
def test_member_conv2d_matches_jax(monkeypatch, formulation, kh, stride, pad):
    """The port against both JAX formulations: im2col plus one batched
    matmul, and (its patch limit crossed) the shifted taps."""
    rng = np.random.default_rng(0)
    cin, cout = 5, 7
    x = rng.standard_normal((M * B, 8, 8, cin)).astype(np.float32)
    kernel = rng.standard_normal((M, kh, kh, cin, cout)).astype(np.float32)
    bias = rng.standard_normal((M, cout)).astype(np.float32)
    if formulation == "taps":
        monkeypatch.setattr(j_mf, "_MAX_PATCH_ELEMS", 1)
    ref = j_mf.member_conv2d(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                             stride=stride, pad=pad)
    weight = torch.from_numpy(kernel).permute(0, 4, 3, 1, 2)  # (M, O, I, kh, kw)
    got = t_mf.member_conv2d(torch.from_numpy(x), weight, torch.from_numpy(bias), stride=stride,
                             pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # a member-major row count that the members do not divide raises, as in JAX
    with pytest.raises(ValueError, match="not divisible by the member count"):
        t_mf.member_conv2d(torch.from_numpy(x[:-1]), weight, None, stride=stride, pad=pad)


def test_member_dense_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((M * B, 6, 5)).astype(np.float32)
    kernel = rng.standard_normal((M, 5, 9)).astype(np.float32)
    bias = rng.standard_normal((M, 9)).astype(np.float32)
    ref = j_mf.member_dense(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    got = t_mf.member_dense(torch.from_numpy(x), torch.from_numpy(kernel).transpose(1, 2),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        t_mf.member_dense(torch.from_numpy(x[:-1]), torch.from_numpy(kernel).transpose(1, 2),
                          None)


@pytest.mark.parametrize("c,act", [(64, "silu"), (12, "none"), (64, "relu")])
def test_member_group_norm_twin_and_its_vjp_match_jax(c, act):
    """The ``(M, C)`` affine: row r takes member r // (rows / M)'s row; the
    twin, the kernel's wrapper (its CPU route) and the VJP (dscale and dbias
    of shape (M, C)) against JAX's ``group_norm_32`` and its gradient."""
    rng = np.random.default_rng(2)
    x = (2.0 * rng.standard_normal((M * B, 4, 4, c)) + 0.5).astype(np.float32)
    scale = rng.standard_normal((M, c)).astype(np.float32)
    bias = rng.standard_normal((M, c)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    jact = {"silu": jax.nn.silu, "relu": jax.nn.relu, "none": lambda v: v}[act]

    def j_fn(x_, s_, b_):
        return jact(j_group_norm_32(x_, s_, b_))

    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref = jax.jit(j_fn)(*args)
    grads = jax.jit(lambda g, *a: jax.vjp(j_fn, *a)[1](g))(jnp.asarray(gy), *args)
    np.testing.assert_allclose(group_norm_32(torch.from_numpy(x), torch.from_numpy(scale),
                                             torch.from_numpy(bias)).numpy(),
                               np.asarray(jax.jit(j_group_norm_32)(*args)), atol=1e-5)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    out = gn.group_norm_act(*leaves, act)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    out.backward(torch.from_numpy(gy))
    for got, want, name in zip(leaves, grads, ("dx", "dscale", "dbias")):
        assert got.grad.shape == tuple(want.shape)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4,
                                   err_msg=name)
    assert leaves[1].grad.shape == (M, c)
    # each member's rows normalized with its own affine, and a bad row count
    per_member = [group_norm_32(torch.from_numpy(x[i * B:(i + 1) * B]),
                                torch.from_numpy(scale[i]), torch.from_numpy(bias[i]))
                  for i in range(M)]
    np.testing.assert_allclose(
        group_norm_32(torch.from_numpy(x), torch.from_numpy(scale),
                      torch.from_numpy(bias)).numpy(), torch.cat(per_member).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="not divisible by the member count"):
        gn.group_norm_act(torch.from_numpy(x[:-1]), torch.from_numpy(scale),
                          torch.from_numpy(bias), act)


# ---- the member-folded DiffUnet -------------------------------------------

UNET = dict(in_channels=3, out_channels=2, model_channels=8, num_res_blocks=(1, 1),
            num_middle_res_blocks=2, attention_resolutions=(-1,), channel_mult=(1, 2),
            num_heads=2)


@pytest.mark.parametrize("kind", ["softmax", "diffusion_scale_shift", "ssn"])
def test_member_diffunet_matches_jax(kind):
    """``DiffUnet(members=3)`` on 3 member-major blocks of rows against the
    JAX ``DiffUnet(members=3)``, its stacked tree mapped by
    ``flax_to_torch_stacked``; each member's block also against the plain
    port module with that member's weights."""
    kw = dict(UNET)
    if kind == "diffusion_scale_shift":
        kw.update(in_channels=5, diffusion=True, use_scale_shift_norm=True)
    elif kind == "ssn":
        kw.update(ssn=True, ssn_rank=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M * B, HW, HW, kw["in_channels"])).astype(np.float32)
    t = rng.random(M * B).astype(np.float32) if kw.get("diffusion") else None
    args = (jnp.asarray(x),) + ((jnp.asarray(t),) if t is not None else ())
    jm = JDiffUnet(**kw, members=M)
    single = member_variables(JDiffUnet(**kw), args[:1] + args[1:], M, seed=4)
    ref = jax.jit(jm.apply)(single, *args)
    tm = DiffUnet(**kw, members=M).eval()
    state = flax_to_torch_stacked(single)
    tm.load_state_dict(state, strict=True)
    targs = {} if t is None else {"timesteps": torch.from_numpy(t)}
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **targs)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **LOGITS_TOL)
    if kind == "ssn":
        for name in ("ssn_cov_diag", "ssn_cov_factor"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                       **LOGITS_TOL)
    plain = DiffUnet(**kw).eval()
    for i in range(M):
        plain.load_state_dict({k: v[i] for k, v in state.items()})
        targs_i = {} if t is None else {"timesteps": torch.from_numpy(t[i * B:(i + 1) * B])}
        with torch.no_grad():
            one = plain(torch.from_numpy(x[i * B:(i + 1) * B]), **targs_i).logits
        np.testing.assert_allclose(got.logits[i * B:(i + 1) * B].numpy(), one.numpy(),
                                   **LOGITS_TOL)


# ---- the sampler's member strategies ---------------------------------------

MODES = {  # name -> SamplerSpec fields (the same on both sides)
    "chunk1": dict(member_chunk=1),
    "chunk2": dict(member_chunk=2),
    "vmapped": dict(member_chunk=None),
    "member_fold": dict(member_fold=True),
    "same_dropout": dict(same_dropout=True),
    "nested": dict(flat_fold=False, member_chunk=2),
}


def inject(monkeypatch, model: str):
    """Fixed draws for B images on both sides, tiled over the rows a draw
    covers; returns the JAX dropout-mask interceptor."""
    rng = np.random.default_rng(7)
    fwd = tta_matrices(rng, B, HW, HW)
    inv = inverse(fwd)
    mx, my = separable_margins(22.5, 0.8, 1.2, True, HW, HW)
    x_init = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    eps_r = rng.standard_normal((S, B, 3)).astype(np.float32)
    eps_n = rng.standard_normal((S, B, HW * HW * 2)).astype(np.float32)

    def tile(a, rows, axis=0):
        assert rows % a.shape[axis] == 0
        reps = [1] * a.ndim
        reps[axis] = rows // a.shape[axis]
        return np.tile(a, reps)

    monkeypatch.setattr(j_sampler_mod, "sample_tta_params", lambda cfg, key, n, h, w: (
        j_tta.TTAParams(jnp.asarray(tile(fwd, n)), jnp.asarray(tile(inv, n)), True, mx, my)))
    monkeypatch.setattr(t_sampler_mod, "sample_tta_params", lambda cfg, gen, n, h, w: (
        t_tta.TTAParams(torch.from_numpy(tile(fwd, n)), torch.from_numpy(tile(inv, n)), True,
                        mx, my)))
    monkeypatch.setattr(ChannelDropout, "draw_mask", lambda self, shape, gen, device: (
        torch.from_numpy(tile(mask_for(self.path.replace(".", "/"), (B, shape[1]), self.rate),
                              shape[0]))))
    if model == "diffusion":
        normal = jax.random.normal

        def j_normal(key, shape=(), dtype=jnp.float32):
            if tuple(shape[1:]) == x_init.shape[1:]:
                return jnp.asarray(tile(x_init, shape[0]), dtype)
            return normal(key, shape, dtype)

        monkeypatch.setattr(jax.random, "normal", j_normal)
        monkeypatch.setattr(t_sampler_mod, "initial_noise", lambda shape, gen, dtype: (
            torch.from_numpy(tile(x_init, shape[0])).to(dtype)))
    if model == "ssn":
        def j_sample_n(dist, key, n):
            rows = dist.mean.shape[0]
            er, en = jnp.asarray(tile(eps_r, rows, 1)), jnp.asarray(tile(eps_n, rows, 1))
            low = jnp.einsum("bnr,sbr->sbn", dist.cov_factor, er)
            return dist.mean + low + jnp.sqrt(dist.cov_diag) * en

        monkeypatch.setattr(j_ssn, "sample_n", j_sample_n)
        monkeypatch.setattr(t_ssn, "draw_normal", lambda shape, gen, dtype: torch.from_numpy(
            tile(eps_r if shape[-1] == 3 else eps_n, shape[1], 1)).to(dtype))

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JChannelDropout) and context.method_name == "__call__" and mod.rate:
            x = args[0]
            m = tile(mask_for("/".join(mod.path), (B, x.shape[-1]), mod.rate), x.shape[0])
            m = jnp.asarray(m.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)))
            return jnp.where(m, x / (1.0 - mod.rate), 0.0).astype(x.dtype)
        return next_fun(*args, **kwargs)

    return interceptor


class _Families(dict):
    """Per family, built on first use: the JAX and the port BuiltModel of
    the tiny network with dropout live (p 0.2), and M members' random
    weights; under "jax" the JAX stacks computed so far."""

    def __missing__(self, model):
        extra = TINY + ["eu_method.dropout.probability_values=[0.2]",
                        "model.ssn_rank=3", "model.diffusion_sampling.num_steps=2",
                        "model.diffusion_sampling.sampler=ddim"]
        jb = j_build_model(j_load_config(model=model, eu_method="dropout", overrides=extra))
        tb = build_model(load_config(model=model, eu_method="dropout", overrides=extra),
                         device="cpu")
        inputs = (jnp.zeros((1, HW, HW, tb.module.config["in_channels"])),)
        if model == "diffusion":
            inputs += (jnp.zeros((1,)),)
        self[model] = (jb, tb, member_variables(jb.module, inputs, M, seed=5))
        return self[model]


@pytest.fixture(scope="module")
def family_models():
    return _Families(jax={})


def run_both(monkeypatch, family_models, model, fields, tta=True):
    """The port's sampler with the member ``fields`` against the JAX stack of
    the same members and draws. Under these injected draws every JAX member
    strategy gives one stack (chunk 1, 2, vmap, ``member_fold``,
    ``same_dropout`` and the nested builders agree to 1e-6, the JAX
    package's own ``test_member_fold.py`` holding them equal), so one JAX
    trace per family and TTA setting, one member at a time under
    ``lax.map``, is the reference for every strategy; the grouping is the
    JAX sampler's for the same fields."""
    jb, tb, stack = family_models[model]
    interceptor = inject(monkeypatch, model)
    spec = dict(n_pred=S, n_members=M, member_mode="params_stack", tta=tta)
    j_spec = dict(spec, tta_config=j_tta.TTAConfig(**TTA))
    j_fn = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(**j_spec, **fields))
    images = np.random.default_rng(8).standard_normal((B, HW, HW, 3)).astype(np.float32)
    if (model, tta) not in family_models["jax"]:
        j_one = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(**j_spec,
                                                                         member_chunk=1))

        @jax.jit
        def run(p, x, rng):
            with nn.intercept_methods(interceptor):
                return j_one(p, x, rng)

        family_models["jax"][(model, tta)] = run(stack, jnp.asarray(images), jax.random.key(0))
    ref = family_models["jax"][(model, tta)]
    spec.update(fields)
    t_fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
        **spec, tta_config=t_tta.TTAConfig(**TTA)), members=flax_to_torch_stacked(stack))
    got = t_fn(torch.from_numpy(images), torch.Generator().manual_seed(0))
    assert tuple(t_fn.meta) == tuple(j_fn.meta)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5,
                                   err_msg=k)
    return t_fn, got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model", ["softmax", "diffusion", "ssn"])
def test_sampler_member_strategies_match_jax(monkeypatch, family_models, model, mode):
    t_fn, got = run_both(monkeypatch, family_models, model, MODES[mode])
    blocks = {"chunk1": [1, 1, 1], "chunk2": [2, 1], "vmapped": [3], "member_fold": [3],
              "same_dropout": [1, 1, 1], "nested": [2, 1]}[mode]
    assert t_fn.blocks == blocks  # same_dropout on the CPU: "auto", one member a block
    assert got.groups.shape[:3] == (M, S, B)
    for m in range(1, M):  # the members' weights give different stacks
        assert (got.group_means[m] - got.group_means[0]).abs().max() > 1e-4


def test_member_fold_ignored_keeps_chunked_execution(monkeypatch, family_models):
    """``member_fold`` with ``same_dropout`` is ignored and ``member_chunk``
    holds (JAX ``sampler.py:113-121``, ``test_member_fold.py``): the same
    blocks and the same numbers as without the flag, and JAX's."""
    fields = dict(member_chunk=2, same_dropout=True)
    t_plain, plain = run_both(monkeypatch, family_models, "softmax", fields)
    t_fold, folded = run_both(monkeypatch, family_models, "softmax",
                              dict(fields, member_fold=True))
    assert t_plain.blocks == t_fold.blocks == [2, 1]
    torch.testing.assert_close(folded.groups, plain.groups, atol=0, rtol=0)


def test_member_fold_is_ignored_off_the_diffunet_and_for_the_prob_unet():
    """The prob-U-Net and the HRNet have no member-folded form: their stacked
    members run one a block whatever the chunk or the flag."""
    for model, network in (("prob_unet", "unet16"), ("softmax", "hrnet-s")):
        tb = build_model(load_config(model=model, network=network, eu_method="none"),
                         device="cpu")
        stack = {k: v[None].expand((2,) + v.shape) for k, v in tb.module.state_dict().items()}
        for fields in (dict(member_fold=True), dict(member_chunk=None), dict(member_chunk=2)):
            fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
                n_pred=1, n_members=2, member_mode="params_stack", **fields), members=stack)
            assert fn.blocks == [1, 1] and len(fn.modules) == 1


def test_same_dropout_reuses_one_draw_per_member_across_rounds_and_steps(monkeypatch):
    """With identity TTA, ``same_dropout`` makes a member's rounds equal and
    its members differ; a diffusion call draws each site's mask once for
    all steps, for members x B rows."""
    ov = TINY + ["eu_method.dropout.probability_values=[0.2]"]
    tb = build_model(load_config(model="softmax", eu_method="dropout", overrides=ov),
                     device="cpu")
    identity = t_tta.TTAConfig(hflip_p=0.0, rotation_limit=0.0, scale_limit=(0.0, 0.0))
    x = torch.randn(B, HW, HW, 3, generator=torch.Generator().manual_seed(0))
    for same in (False, True):
        fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
            n_pred=3, n_members=2, member_mode="dropout", tta=True, tta_config=identity,
            same_dropout=same))
        g = fn(x, torch.Generator().manual_seed(1)).groups
        rounds_differ = (g[:, 1:] - g[:, :1]).abs().max().item()
        assert (rounds_differ < 1e-6) == same
        assert (g[1] - g[0]).abs().max() > 1e-3
    shapes = []
    draw = ChannelDropout.draw_mask

    def record(self, shape, generator, device):
        shapes.append(shape)
        return draw(self, shape, generator, device)

    monkeypatch.setattr(ChannelDropout, "draw_mask", record)
    db = build_model(load_config(model="diffusion", eu_method="dropout", overrides=ov),
                     device="cpu")
    sites = sum(isinstance(m, ChannelDropout) and m.rate > 0 for m in db.module.modules())
    for same, steps in ((True, 3), (False, 3)):
        shapes.clear()
        fn = t_sampler_mod.make_sampler(db, t_sampler_mod.SamplerSpec(
            n_pred=S, n_members=2, member_mode="dropout", same_dropout=same,
            diffusion_num_steps=steps, diffusion_sampler="ddim"))
        fn(x, torch.Generator().manual_seed(2))
        if same:
            assert len(shapes) == sites and {s[0] for s in shapes} == {2 * B}
        else:
            assert len(shapes) == sites * steps and {s[0] for s in shapes} == {2 * S * B}


def test_same_dropout_on_the_hrnet_reuses_each_members_final_dropout_draw():
    """The HRNet's elementwise final dropout under ``same_dropout``: with
    identity TTA a member's rounds are equal, its members differ. The
    weights come from a seeded generator: drawn from the global one, they
    depended on the tests that ran before in the same process, and some
    draws saturate this untrained network's softmax (1 and 1e-26), where no
    member can differ."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        tb = build_model(load_config(network="hrnet-s", eu_method="dropout"), device="cpu")
    identity = t_tta.TTAConfig(hflip_p=0.0, rotation_limit=0.0, scale_limit=(0.0, 0.0))
    fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
        n_pred=2, n_members=2, member_mode="dropout", tta=True, tta_config=identity,
        same_dropout=True))
    g = fn(torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(0)),
           torch.Generator().manual_seed(1)).groups
    assert (g[:, 1] - g[:, 0]).abs().max() < 1e-6
    assert (g[1] - g[0]).abs().max() > 1e-4


# ---- the job ---------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    from test_torch_port_infer import N_TEST, generate_toy_dataset

    return generate_toy_dataset(tmp_path_factory.mktemp("toy"), num_train=2, num_val=1,
                                num_test=N_TEST, num_ood=1, size=32, seed=0)


@pytest.fixture(scope="module")
def deep_ensemble_job(toy_dir, tmp_path_factory):
    """Three checkpoint pairs (JAX, port) of random weights and the JAX job's
    results tree for their deep ensemble under ``member_chunk=2``."""
    from test_torch_port_infer import checkpoint_pair, j_config, random_variables, run_jax

    root = tmp_path_factory.mktemp("deep_ensemble")
    cfg = j_config(toy_dir, eu="ensemble")
    pairs = [checkpoint_pair(root / "ckpt", f"s{i}", cfg,
                             {"params": random_variables(cfg, 20 + i)}) for i in range(3)]
    return pairs, run_jax([p[0] for p in pairs], root / "jax", member_chunk=2, n_pred=1, seed=4)


@pytest.mark.parametrize("fields", [dict(member_chunk=2), dict(member_chunk=None)],
                         ids=["member_chunk2", "member_chunk_none"])
def test_job_deep_ensemble_under_member_chunk_equals_jax(deep_ensemble_job, tmp_path, fields):
    """Three checkpoints stacked into a deep ensemble: the port's job with
    ``member_chunk=2`` (blocks of 2 and 1) or None (one folded forward)
    against the JAX job with ``member_chunk=2``."""
    from test_torch_port_infer import assert_same_tree, run_port

    pairs, j_dir = deep_ensemble_job
    t_dir, inf = run_port([p[1] for p in pairs], tmp_path / "port", n_pred=1, seed=4, **fields)
    assert inf.spec.member_mode == "params_stack"
    assert inf.sampler.blocks == ([2, 1] if fields["member_chunk"] else [3])
    assert_same_tree(j_dir, t_dir)


def test_auto_member_chunk_is_read_by_device_and_family(monkeypatch, family_models):
    """"auto" for stacked members takes ``AUTO_MEMBER_CHUNK`` of the stack's
    device and the family; a family it does not name runs one member a
    block (on the card only the timed softmax ensemble folds)."""
    assert t_sampler_mod.AUTO_MEMBER_CHUNK == {("cuda", "softmax"): None}
    monkeypatch.setattr(t_sampler_mod, "AUTO_MEMBER_CHUNK", {("cpu", "softmax"): None})
    for model, blocks in (("softmax", [M]), ("diffusion", [1] * M), ("ssn", [1] * M)):
        _, tb, stack = family_models[model]
        fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
            n_pred=S, n_members=M, member_mode="params_stack"),
            members=flax_to_torch_stacked(stack))
        assert fn.blocks == blocks, model


def test_spec_refuses_a_bad_member_chunk():
    tb = build_model(load_config(eu_method="none", overrides=TINY), device="cpu")
    for bad in (0, -1, "all", 1.5, True):
        with pytest.raises(ValueError, match="member_chunk"):
            t_sampler_mod.make_sampler(tb, dataclasses.replace(
                t_sampler_mod.SamplerSpec(), member_chunk=bad))
