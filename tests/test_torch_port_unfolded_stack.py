"""Stacks of the families with no member-folded form (the prob-U-Net and the
HRNet): the port runs them one member a block, each member drawing from a
generator of its own (``sampling/sampler.py``), held against the JAX
sampler's vmapped stack (``member_chunk=None``) of the same members.

Every draw is injected on both sides (TTA matrices, the HRNet's final
dropout by shape, the prob-U-Net's latents): the JAX member body under
``vmap`` is traced once, so every member sees one set of draws, and the
port's injected draws are the same arrays whichever member's generator asks.
Float32 at the families' CPU tolerances (stacks and heatmaps 1e-5). Then the
port's own draws: members of equal weights still differ (EU is not zero),
and one seed gives one stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.models.prob_unet as jpu
import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.prob_unet import ProbUnetSpec as JProbUnetSpec
from diffuncertainty_tpu.models.unet import DropoutSpec as JDropoutSpec
from diffuncertainty_tpu.sampling import tta as j_tta
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core.params import flax_to_torch_stacked
from diffuncertainty_tpu_torch.core.specs import DropoutSpec, ProbUnetSpec
from diffuncertainty_tpu_torch.models import prob_unet as tpu
from diffuncertainty_tpu_torch.models.factory import BuiltModel
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from diffuncertainty_tpu_torch.sampling import tta as t_tta
from test_torch_port_ensemble import (assert_stacks_match, inject_tta_and_masks, noisy_stack,
                                      run_jax)
from test_torch_port_hrnet import inject_final_dropout, masks_by_shape
from test_torch_port_hrnet import small_pair as hrnet_pair
from test_torch_port_prob_unet import SMALL, SPEC
from test_torch_port_slice import TTA
from torch_threads import one_torch_thread  # noqa: F401

HW, B, MEMBERS = 32, 2, 3


def prob_unet_pair():
    jm = jpu.build_prob_unet(dict(SMALL), JProbUnetSpec(**SPEC))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                              jnp.zeros((1, HW, HW, 2)), jnp.zeros((1, 6)))
    tm = tpu.build_prob_unet(dict(SMALL), ProbUnetSpec(**SPEC)).eval()
    kw = dict(au_type="prob_unet", eu_type="ensemble", is_generative=True, num_classes=2)
    return JBuilt(module=jm, **kw), BuiltModel(module=tm, **kw), params


def hrnet_models():
    jm, tm, variables = hrnet_pair(final_dropout=0.2, seed=11)
    kw = dict(au_type="softmax", eu_type="dropout", is_generative=False, num_classes=2,
              backbone="hrnet")
    return (JBuilt(module=jm, **kw, dropout_spec=JDropoutSpec(True, (0.2,))),
            BuiltModel(module=tm, **kw, dropout_spec=DropoutSpec(True, (0.2,))), variables)


def inject(monkeypatch, family: str, n_pred: int):
    """The family's draws, fixed arrays on both sides."""
    if family == "hrnet":
        inject_tta_and_masks(monkeypatch, B)
        inject_final_dropout(monkeypatch, masks_by_shape(seed=13))
        return
    eps = np.random.default_rng(12).standard_normal((B, 6)).astype(np.float32)
    monkeypatch.setattr(j_sampler_mod, "sample_latent",
                        lambda prior, key: prior.mu + prior.sigma * jnp.asarray(eps))
    monkeypatch.setattr(t_sampler_mod, "sample_latent", lambda prior, generator: (
        prior.mu + prior.sigma * torch.from_numpy(np.tile(eps, (n_pred, 1)))))


SPECS = {"prob_unet": (prob_unet_pair, dict(n_pred=2)),
         "hrnet": (hrnet_models, dict(n_pred=1, tta=True))}


@pytest.fixture(scope="module")
def models():
    """Each family's (JAX built, port built, variables), made once."""
    made = {}

    def get(family):
        if family not in made:
            made[family] = SPECS[family][0]()
        return made[family]

    return get


@pytest.mark.parametrize("family", sorted(SPECS))
def test_unfolded_stack_matches_the_jax_vmapped_stack(monkeypatch, models, family):
    """Three members of their own weights (noise on every leaf, the HRNet's
    BatchNorm statistics too), one a block in the port, under ``vmap`` in
    JAX, with the same injected draws."""
    fields = SPECS[family][1]
    jb, tb, variables = models(family)
    stack = noisy_stack(variables, MEMBERS, seed=4)
    images = np.random.default_rng(8).standard_normal((B, HW, HW, 3)).astype(np.float32)
    inject(monkeypatch, family, fields["n_pred"])
    spec = dict(fields, n_members=MEMBERS, member_mode="params_stack")
    j_fn, ref = run_jax(jb, dict(spec, member_chunk=None, tta_config=j_tta.TTAConfig(**TTA)),
                        stack, images, intercept=family == "hrnet")
    t_fn = t_sampler_mod.make_sampler(
        tb, t_sampler_mod.SamplerSpec(**spec, tta_config=t_tta.TTAConfig(**TTA)),
        members=flax_to_torch_stacked(stack))
    got = t_fn(torch.from_numpy(images), torch.Generator().manual_seed(0))
    assert t_fn.blocks == [1] * MEMBERS
    assert got.groups.shape == (MEMBERS, fields["n_pred"], B, HW, HW, 2)
    maps = assert_stacks_match(got, ref, j_fn.meta, t_fn.meta)
    assert float(maps["EU"].mean()) > 1e-4
    for m in range(1, MEMBERS):  # the members' weights give different stacks
        assert (got.groups[m] - got.groups[0]).abs().max() > 1e-3


@pytest.mark.parametrize("family", sorted(SPECS))
def test_members_of_equal_weights_draw_apart(models, family):
    """The same weights in every member: only the members' own generators
    tell them apart, so their samples differ and EU is not zero; one seed
    gives one stack, another seed another."""
    fields = SPECS[family][1]
    _, tb, variables = models(family)
    same = jax.tree.map(lambda a: np.stack([np.asarray(a)] * MEMBERS), variables)
    fn = t_sampler_mod.make_sampler(
        tb, t_sampler_mod.SamplerSpec(**fields, n_members=MEMBERS, member_mode="params_stack",
                                      tta_config=t_tta.TTAConfig(**TTA)),
        members=flax_to_torch_stacked(same))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((B, HW, HW, 3))
                         .astype(np.float32))
    a = fn(x, torch.Generator().manual_seed(0))
    for m in range(1, MEMBERS):
        assert (a.groups[m] - a.groups[0]).abs().max() > 1e-3
    maps = uncertainty_heatmaps(a.group_means, sample_axis=0, class_axis=-1)
    assert float(maps["EU"].mean()) > 1e-4
    torch.testing.assert_close(fn(x, torch.Generator().manual_seed(0)).groups, a.groups,
                               atol=0, rtol=0)
    assert not torch.equal(fn(x, torch.Generator().manual_seed(1)).groups, a.groups)
