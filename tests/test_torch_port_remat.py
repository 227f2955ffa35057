"""``trainer.remat`` in the port (``train/loop.py``: the loss's forward under
non-reentrant ``torch.utils.checkpoint`` with ``generator_replay``).

- For every family the trainer takes (softmax with MC-dropout, diffusion,
  SSN, prob-U-Net on the small DiffUnet of ``tests/test_train.py``, and the
  softmax HRNet of ``test_torch_port_train_hrnet.py`` with stage and final
  dropout), with the real draws of one generator (dropout masks, the rater,
  the diffusion times and noise, the SSN normals, the prob-U-Net latent): a
  remat step's loss, every gradient leaf, the generator's state after the
  step and (HRNet) the running statistics equal the stored forward's,
  exactly (float32 on the CPU, the same kernels in the same order); and a
  recompute that does not replay the generator gives other gradients (the
  draws it would redraw).
- The JAX trainer's remat step (``jax.checkpoint`` around its loss) against
  the port's, softmax with dropout, the masks injected: three steps'
  losses, ``grad_norm``, parameters, moments and EMA to 1e-5
  (``test_torch_port_train.py``'s tolerances).
"""

from __future__ import annotations

import contextlib
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.train.loop import Trainer as JTrainer
import diffuncertainty_tpu_torch.train.cli as t_cli
import diffuncertainty_tpu_torch.train.loop as t_loop
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.models.factory import build_model as t_build_model
from diffuncertainty_tpu_torch.models.hrnet import HRNet, HRNetSpec
from diffuncertainty_tpu_torch.models.unet import ChannelDropout
from diffuncertainty_tpu_torch.train.loop import Trainer as TTrainer
from test_torch_port_model import jax_mask_interceptor, torch_draw_mask
from test_torch_port_train import (STEP_TOL, assert_state_close, configs, jax_adam, jax_init,
                                   jax_state, noisy, tokens, toy_batch, toy_dir, track_flat)
from test_torch_port_train_diffusion import SCALE_SHIFT, family_tokens
from test_torch_port_train_hrnet import hrnet_tokens, spec_kw
from torch_threads import one_torch_thread  # noqa: F401

__all__ = ["one_torch_thread", "toy_dir"]


def port_trainer(tokens: list[str], tmp_path, remat: bool, hrnet: bool = False) -> TTrainer:
    cfg, _ = t_cli.parse_args(tokens + [f"trainer.remat={str(remat).lower()}", "device=cpu"])
    built = t_build_model(cfg, "cpu")
    if hrnet:
        built = dataclasses.replace(built, module=HRNet(2, HRNetSpec(**spec_kw())))
    return TTrainer(cfg, device="cpu", built=built, workdir=tmp_path / f"remat_{remat}")


def family_case(family: str, toy_dir, tmp_path) -> list[str]:
    if family == "hrnet":
        return hrnet_tokens(toy_dir, tmp_path, "softmax")
    if family == "softmax":
        return tokens(toy_dir, tmp_path, eu="dropout")
    extra = {"diffusion": SCALE_SHIFT, "ssn": ["model.ssn_pretrain_epochs=0"],
             "prob_unet": ["model.prob_unet.beta=0.01"]}[family]
    return family_tokens(family, toy_dir, tmp_path, *extra)


def step_grads(trainer: TTrainer, batch: dict, seed: int):
    """(loss, gradients, the generator's state after, statistics update) of one
    forward and backward with a generator seeded ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    loss, aux = trainer.forward_loss(batch, generator)
    grads = trainer.gradients(trainer.fresh_state(), loss)
    return loss.item(), grads, generator.get_state(), aux.get("model_state")


@pytest.mark.parametrize("family", ["softmax", "diffusion", "ssn", "prob_unet", "hrnet"])
def test_remat_gradients_equal_the_stored_forward_with_the_real_draws(toy_dir, tmp_path,
                                                                       family, monkeypatch):
    tokens = family_case(family, toy_dir, tmp_path)
    plain = port_trainer(tokens, tmp_path, remat=False, hrnet=family == "hrnet")
    remat = port_trainer(tokens, tmp_path, remat=True, hrnet=family == "hrnet")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every leaf non-zero, so that every gradient shows
        for p in plain.built.module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    remat.built.module.load_state_dict(plain.built.module.state_dict())
    images, seg = toy_batch(3, raters=None if family in ("softmax", "hrnet") else 4)
    batch = {"image": images, "seg": seg}
    loss, grads, gen_state, stats = step_grads(plain, batch, 11)
    r_loss, r_grads, r_gen_state, r_stats = step_grads(remat, batch, 11)
    assert r_loss == loss and torch.equal(r_gen_state, gen_state)
    names = [n for n, _ in plain.built.module.named_parameters()]
    assert sum(float(g.abs().max()) > 0 for g in grads) > 0.9 * len(grads)
    for name, g, r in zip(names, grads, r_grads):
        assert torch.equal(g, r), name
    if family == "hrnet":
        assert stats.keys() == r_stats.keys() and all(torch.equal(stats[k], r_stats[k])
                                                       for k in stats)
        # one step commits the statistics once: the remat step's buffers
        # equal the stored forward's
        for trainer in (plain, remat):
            trainer.train_step(trainer.fresh_state(), batch, torch.Generator().manual_seed(11))
        for (k, a), b in zip(plain.built.module.named_buffers(),
                             remat.built.module.buffers()):
            assert torch.equal(a, b), k
    # without the replay the recompute redraws (dropout masks, rater, t, eps,
    # SSN normals, latents) and the gradients part from the stored forward's
    monkeypatch.setattr(t_loop, "generator_replay",
                        lambda generator: (contextlib.nullcontext(), contextlib.nullcontext()))
    _, naive, _, _ = step_grads(remat, batch, 11)
    assert any(not torch.equal(g, r) for g, r in zip(grads, naive))


def test_the_jax_remat_step_matches_the_port(toy_dir, tmp_path, monkeypatch):
    """softmax with MC-dropout, three remat steps on both sides."""
    monkeypatch.setattr(ChannelDropout, "draw_mask", torch_draw_mask)
    extra = ("trainer.remat=true", "trainer.gradient_clip_val=1000000.0")
    jcfg, tcfg = configs(toy_dir, tmp_path, *extra, eu="dropout")
    assert jcfg.trainer.remat and tcfg.trainer.remat
    jt = JTrainer(jcfg, workdir=tmp_path / "j")
    params = noisy(jax_init(jcfg))
    state = jax_state(jt, params)
    tt = TTrainer(tcfg, workdir=tmp_path / "t", device="cpu")
    tt.built.module.load_state_dict(flax_to_torch(params))
    tstate = tt.fresh_state()
    flat = track_flat(tt)
    for i in range(3):
        images, seg = toy_batch(20 + i)
        with nn.intercept_methods(jax_mask_interceptor):
            state, aux = jt._get_step(False)(
                state, {"image": jnp.asarray(images), "seg": jnp.asarray(seg)},
                jax.random.key(i), {})
        tstate, taux = tt.train_step(tstate, {"image": images, "seg": seg}, torch.Generator())
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(taux[k]), float(aux[k]), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=k)
    adam = jax_adam(state.opt_state)
    for what, got, ref in (("mu", tstate.opt_state.mu, adam.mu),
                           ("nu", tstate.opt_state.nu, adam.nu)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what)
    for what, got, ref in (("params", tstate.params, state.params),
                           ("ema", tstate.ema_params, state.ema_params)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what,
                           flat, 2 * 3 * 0.003)
