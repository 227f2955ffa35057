"""Port parity of the sub-ensemble mask trainer
(``diffuncertainty_tpu_torch/train/subensemble_trainer.py`` against
``diffuncertainty_tpu/train/subensemble_trainer.py``) on a tiny random
DiffUnet (8 channels, one level with attention, 32x32; no dropout: the
JAX trainer applies its members without a dropout key), 2 masks, two
batches of 2 images at 32x32 cycled over the steps.

The run is ``chip_smoke.py``'s mask-trainer run with the JAX defaults
(``SUBENSEMBLE_DEFAULTS``: ``normalize`` on, diversity 1.0, size 1.0, a
constant temperature of 1.0, learning rate 0.05, target fill 0.25, eight
steps) at 2 masks, on both sides in float64 (``jax.enable_x64``, the mask
logits' float32 zeros made float64 on both sides): Adam divides each
gradient by its own RMS, so in float32 a gradient near 0 (a channel whose
scale the next GroupNorm divides out) takes its sign from rounding and moves
its logit by the learning rate either way. The JAX loop draws each step's
key from ``split(key(seed))``, each member's from ``split(key, M)`` and each
layer's Gumbel noise from ``fold_in(member key, crc32(layer))``: those
arrays, computed here, are handed to the port's ``draw_gumbel`` in its call
order (step, member, layer, side). The logits are read after every step on
both sides (the JAX step's first argument, the port's ``adam_``) and held
after three steps and after eight to 1e-5; the hard masks' fill and IoU
after eight steps exactly, the members to float32's rounding (rtol 1e-6:
each package rescales a kept mask by a mean taken in float32) and their EU
through one forward to 1e-9. In float32, the materialized members to 1e-6,
and through the port's sampler (``params_stack``) folded and one at a time.
"""

from __future__ import annotations

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.train import subensemble_trainer as j_st
from diffuncertainty_tpu_torch.core.params import flax_to_torch, flax_to_torch_stacked
from diffuncertainty_tpu_torch.models import subensemble as t_se
from diffuncertainty_tpu_torch.models.factory import BuiltModel
from diffuncertainty_tpu_torch.models.unet import DiffUnet
from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
from diffuncertainty_tpu_torch.train import cli as t_cli
from diffuncertainty_tpu_torch.train import subensemble_trainer as t_st
from diffuncertainty_tpu_torch.train.loop import Trainer as TTrainer
from test_torch_port_train import tokens, toy_dir
from torch_threads import one_torch_thread  # noqa: F401

__all__ = ["one_torch_thread", "toy_dir"]
M, STEPS = 2, 8
# chip_smoke.SUBENSEMBLE_DEFAULTS at M masks
CFG = dict(num_masks=M, steps=STEPS, learning_rate=0.05, temp_start=1.0, temp_end=1.0,
           target_fraction=0.25, diversity_coeff=1.0, normalize=True, seed=7)


def jax_step_gumbels(logits: dict, cfg, steps: int) -> dict:
    """{(step, member, port layer, side): (2, C)} of JAX's loop."""
    out = {}
    rng = jax.random.key(cfg.seed)
    for i in range(steps):
        rng, key = jax.random.split(rng)
        for m, mk in enumerate(jax.random.split(key, cfg.num_masks)):
            for layer, sides in logits.items():
                k = jax.random.fold_in(mk, zlib.crc32(layer.encode()) % (2**31))
                for side, kk in zip(("in", "out"), jax.random.split(k)):
                    out[(i, m, layer.replace("/", "."), side)] = np.asarray(
                        jax.random.gumbel(kk, (2,) + sides[side][m].shape))
    return out


TINY = dict(in_channels=3, out_channels=2, model_channels=8, num_res_blocks=(1,),
            num_middle_res_blocks=1, attention_resolutions=(-1,), channel_mult=(1,),
            num_heads=2)
KW = dict(au_type="softmax", eu_type="none", is_generative=False, num_classes=2)


def tiny_pair():
    """The same random weights in a JAX and a port DiffUnet, each in a
    softmax ``BuiltModel`` without dropout: kernels normal with a standard
    deviation of 1/sqrt(fan-in), GroupNorm scales 1 + 0.05 noise, the rest
    0.05 noise (the shapes from ``eval_shape``: no compile)."""
    jm = JDiffUnet(**TINY)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros((1, 32, 32, 3))),
                            jax.random.key(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return 0.05 * noise + np.float32(1.0 if name == "scale" else 0.0)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tm = DiffUnet(**TINY)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return JBuilt(module=jm, **KW), BuiltModel(module=tm.eval(), **KW), params


class _JaxRecordingSteps:
    """``jax`` for the JAX trainer with ``jit`` recording the mask logits
    each compiled step is called with (the logits after the steps so far)."""

    def __init__(self, seen: list):
        def jit(fn):
            compiled = jax.jit(fn)

            def step(masks, *args):
                seen.append(jax.tree.map(np.asarray, masks))
                return compiled(masks, *args)
            return step
        self.jit = jit

    def __getattr__(self, name):
        return getattr(jax, name)


def float64_zeros(init, cast):
    """A mask-logit initializer whose float32 zeros are cast to float64."""
    def f64(params, num_masks):
        return {k: {s: cast(v) for s, v in d.items()} for k, d in init(params, num_masks).items()}
    return f64


@pytest.fixture(scope="module")
def trained():
    """Both trainers over the same float64 weights, batches and Gumbel noise;
    their logits after each step."""
    jb, tb, params = tiny_pair()
    params64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    rng = np.random.default_rng(3)
    batches = [{"image": rng.standard_normal((2, 32, 32, 3)),
                "seg": (rng.random((2, 32, 32)) < 0.3).astype(np.int32)} for _ in range(2)]
    cfg = j_st.SubensembleConfig(**CFG)
    jax_seen: list = []
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        noise = jax_step_gumbels(j_st.se.init_mask_logits(params["params"], M), cfg, STEPS)
        mp.setattr(j_st, "jax", _JaxRecordingSteps(jax_seen))
        mp.setattr(j_st.se, "init_mask_logits", float64_zeros(
            j_st.se.init_mask_logits, lambda v: v.astype(jnp.float64)))
        jax_seen.append(jax.tree.map(np.asarray, j_st.train_subensemble_masks(
            jb, params64, batches, cfg)))
    jax_steps = [t_se.jax_mask_keys(s) for s in jax_seen[1:]]  # after steps 1..STEPS
    calls: dict = {}

    def draw(layer, side, shape, generator, device):
        n = calls[(layer, side)] = calls.get((layer, side), -1) + 1
        step, member = divmod(n, M)
        return torch.from_numpy(noise[(step, member, layer, side)]).to(device)

    port_steps: list = []

    def adam(leaves, *args):
        real_adam(leaves, *args)
        port_steps.append([p.detach().clone() for p in leaves])

    real_adam = t_st.adam_
    state64 = {k: v.double() for k, v in flax_to_torch(params).items()}
    tb64 = BuiltModel(module=DiffUnet(**TINY, dtype=torch.float64).double().eval(), **KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_se, "draw_gumbel", draw)
        mp.setattr(t_se, "init_mask_logits", float64_zeros(t_se.init_mask_logits,
                                                            lambda v: v.double()))
        mp.setattr(t_st, "adam_", adam)
        history: list = []
        got = t_st.train_subensemble_masks(tb64, state64, batches, t_st.SubensembleConfig(**CFG),
                                           history=history)
    assert set(calls.values()) == {STEPS * M - 1}  # every layer's two sides, every member
    keys = [(layer, side) for layer in got for side in ("in", "out")]
    port_steps = [{layer: {side: snap[keys.index((layer, side))] for side in ("in", "out")}
                   for layer in got} for snap in port_steps]
    assert len(jax_steps) == len(port_steps) == STEPS
    return types.SimpleNamespace(jb=jb, tb=tb, params=params, params64=params64,
                                 state64=state64, tb64=tb64, jax_steps=jax_steps,
                                 port_steps=port_steps, history=history, batches=batches)


@pytest.mark.parametrize("steps", [3, STEPS])
def test_mask_logits_after_three_steps_match_jax(trained, steps):
    """After three steps and after the smoke's eight (float64, 1e-5)."""
    ref, got = trained.jax_steps[steps - 1], trained.port_steps[steps - 1]
    assert set(got) == set(ref) and len(got) > 10
    for k, sides in ref.items():
        for side, r in sides.items():
            np.testing.assert_allclose(got[k][side].numpy(), r, atol=1e-5, rtol=0,
                                       err_msg=f"{k} {side}")
    lr = CFG["learning_rate"]
    assert np.median(np.concatenate([np.abs(r).ravel() for sides in ref.values()
                                     for r in sides.values()])) > 0.5 * lr  # the logits moved
    history = trained.history
    assert all(h["temp"] == 1.0 for h in history)
    assert all(np.isfinite(h["loss"]) and 0.0 < h["iou"] <= 1.0 for h in history)
    # the annealed schedule as the JAX loop computes it (float32)
    c = j_st.SubensembleConfig(steps=5, temp_start=2.0, temp_end=0.3)
    assert [t_st.temperature(c, i) for i in range(5)] == [
        float(np.float32(c.temp_start * (c.temp_end / c.temp_start) ** (i / 4)))
        for i in range(5)]


def members_eu(probs: np.ndarray) -> float:
    """The mean EU over pixels of (M, B, H, W, K) member probabilities."""
    def entropy(p):
        return -(p * np.log(np.clip(p, 1e-30, None))).sum(-1)
    return float((entropy(probs.mean(0)) - entropy(probs).mean(0)).mean())


def test_jax_defaults_give_the_jax_hard_masks_and_eu(trained):
    """``normalize`` on (the JAX default) over the smoke's eight steps: the
    hard masks' fill and IoU are the JAX trainer's, and so are the members
    (JAX's materialized from its logits, the port's from its own) and their
    EU through one forward (the port's float64 DiffUnet, which
    ``test_torch_port_model.py`` holds to JAX's)."""
    t = trained
    jm = {k.replace(".", "/"): v for k, v in t.jax_steps[-1].items()}
    pm = t.port_steps[-1]
    j_stats, p_stats = j_st.se.compute_mask_stats(jm), t_se.compute_mask_stats(pm)
    for key in ("mean_fill_fraction", "mean_pairwise_iou", "fill_fraction_per_member"):
        np.testing.assert_array_equal(np.asarray(p_stats[key]), np.asarray(j_stats[key]),
                                      err_msg=key)
    with jax.enable_x64(True):
        j_members = flax_to_torch_stacked(jax.tree.map(np.asarray, j_st.materialize_for_inference(
            t.params64, jm, M)["params"]))
    members = t_st.materialize_for_inference(t.state64, pm, M)
    images = torch.from_numpy(t.batches[0]["image"])

    def probs(stack):
        with torch.no_grad():
            return np.stack([torch.softmax(functional_call(
                t.tb64.module, {k: v[m] for k, v in stack.items()}, (images, None)).logits,
                -1).numpy() for m in range(M)])

    # both packages rescale a kept mask by a mean taken in float32
    for k in members:
        np.testing.assert_allclose(members[k].numpy(), j_members[k].numpy(), atol=1e-7,
                                   rtol=1e-6, err_msg=k)
    assert members_eu(probs(members)) == pytest.approx(members_eu(probs(j_members)), abs=1e-9)


def test_materialized_members_match_jax_and_run_in_the_port_sampler(trained):
    """The port's trained masks materialized on both sides (JAX's on the
    same logits, keys mapped back), then through the port's sampler."""
    tb, params = trained.tb, trained.params
    got_masks = {k: {s: v.float() for s, v in d.items()}
                 for k, d in trained.port_steps[-1].items()}
    state = flax_to_torch(params)
    as_jax = {k.replace(".", "/"): {s: np.asarray(v) for s, v in d.items()}
              for k, d in got_masks.items()}
    ref = flax_to_torch_stacked(jax.tree.map(np.asarray, j_st.materialize_for_inference(
        params, as_jax, M)["params"]))
    stack = t_st.materialize_for_inference(state, got_masks, M)
    assert set(stack) == set(ref)
    for k in ref:
        np.testing.assert_allclose(stack[k].numpy(), ref[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    # the sampler runs on the trained logits plus seeded noise of 0.3 around
    # 0.2, so that the two members surely differ
    gen = torch.Generator().manual_seed(2)
    stack = t_st.materialize_for_inference(state, {
        k: {s: v + 0.2 + 0.3 * torch.randn(v.shape, generator=gen) for s, v in d.items()}
        for k, d in got_masks.items()}, M)
    images = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 32, 3))
                              .astype(np.float32))
    stacks = []
    for fields in (dict(member_chunk=None, member_fold=True), dict(member_chunk=1)):
        spec = SamplerSpec(n_pred=1, n_members=M, member_mode="params_stack", **fields)
        stacks.append(make_sampler(tb, spec, members=stack)(images, torch.Generator()).groups)
    assert stacks[0].shape == (M, 1, 2, 32, 32, 2)
    np.testing.assert_allclose(stacks[0].numpy(), stacks[1].numpy(), atol=1e-5)
    assert not torch.allclose(stacks[0][0], stacks[0][1])  # the members differ


def test_the_trainer_trains_eu_subensemble_as_a_plain_run(toy_dir, tmp_path):
    """``eu_method.name=subensemble`` trains the base network as a plain run,
    as the JAX trainer does; the masks come after, from its weights."""
    cfg, _ = t_cli.parse_args(tokens(toy_dir, tmp_path, "eu_method.name=subensemble",
                                     "trainer.max_epochs=1") + ["device=cpu"])
    trainer = TTrainer(cfg, device="cpu")
    assert trainer.built.eu_type == "subensemble"
    train, val, _ = t_cli.build_loaders(cfg)
    state = trainer.fit(train, val)
    assert state.step == len(train) == 2 and (trainer.workdir / "checkpoints" / "last").is_dir()
