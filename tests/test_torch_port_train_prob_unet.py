"""Port parity of the prob-U-Net family's training (``models/prob_unet.py``'s
``elbo_loss``, ``core/specs.py``'s beta warm-up, ``train/losses.py``,
``train/loop.py``) against the JAX package on the same numpy inputs, with
every draw injected on both sides (the posterior latent, the rater). The
small net, data and tolerances of ``test_torch_port_train_diffusion.py``,
whose helpers this file shares; beta 0.01 with ``beta_warmup_epochs=4``, so
the two-epoch runs train at beta 0.0025 and then 0.005 (the warm-up starts
at ``(epoch + 1) / warmup``; ``configs/model/prob_unet.yaml`` ends at
0.0025). From the noisy weights the KL is about 1e3, so a larger beta would
make the prior's and posterior's gradients 1e3 times the base's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.core.specs import ProbUnetSpec as JSpec
import diffuncertainty_tpu_torch.train.losses as t_losses
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.core.specs import ProbUnetSpec as TSpec
from diffuncertainty_tpu_torch.models.factory import build_model as t_build_model
from test_torch_port_train import toy_batch, toy_dir
from test_torch_port_train_diffusion import (check_evaluate, check_export_resume, check_fit,
                                             check_infer_job, check_new_init_leaves,
                                             check_step_gradients, check_three_steps,
                                             family_configs, inject_draws, run_both)
from torch_threads import one_torch_thread  # noqa: F401

__all__ = ["one_torch_thread", "toy_dir"]
WARMUP = ["model.prob_unet.beta=0.01", "model.prob_unet.beta_warmup_epochs=4"]
RUNS = [*WARMUP, "model.prob_unet.regularizer_coeff=1.0e-5"]
# the base unet's output head: computed, never used (the fcomb decodes)
UNUSED_HEAD = {"base.out_norm.weight", "base.out_norm.bias", "base.out_conv.weight",
               "base.out_conv.bias"}


@pytest.fixture(scope="module")
def runs(toy_dir, tmp_path_factory):
    return run_both("prob_unet", toy_dir, tmp_path_factory.mktemp("prob_unet"), *RUNS)


@pytest.mark.parametrize("warmup,epoch", [(0, 0), (32, 0), (32, 5), (4, 3), (4, 9), (1, 0)])
def test_beta_at_epoch_matches_jax(warmup, epoch):
    kw = dict(beta=2.5e-3, beta_warmup_epochs=warmup)
    assert TSpec(**kw).beta_at_epoch(epoch) == JSpec(**kw).beta_at_epoch(epoch)
    assert TSpec(**kw).beta_at_epoch(0) == (2.5e-3 / warmup if warmup else 2.5e-3)


def test_prob_unet_loss_and_every_gradient_match_jax(runs, monkeypatch):
    """Ignored pixels in the target, beta from the warm-up, the
    regularizer at the spec's default 1e-5."""
    inject_draws(monkeypatch)
    check_step_gradients(runs, toy_batch(3, ignore=-1), zero_grads=UNUSED_HEAD)


def test_prob_unet_regularizer_sums_the_jax_prior_posterior_and_fcomb_leaves(
        runs, toy_dir, tmp_path, monkeypatch):
    """``regularizer_coeff`` 1e-5 (the spec's default, the runs') against
    0.0 (``configs/model/prob_unet.yaml``): the loss differs by 1e-5 times
    the sum of squares over the leaves of JAX's ``prior``, ``posterior``
    and ``fcomb`` subtrees."""
    inject_draws(monkeypatch)
    images, seg = toy_batch(4)
    batch = {"image": torch.from_numpy(images), "seg": torch.from_numpy(seg)}
    losses = {}
    for coeff in ("0.0", "1.0e-5"):
        _, tcfg = family_configs("prob_unet", toy_dir, tmp_path / coeff, *WARMUP,
                                 f"model.prob_unet.regularizer_coeff={coeff}")
        built = t_build_model(tcfg, device="cpu")
        built.module.load_state_dict(flax_to_torch(runs.params))
        loss, _ = t_losses.make_loss_fn(built)(built.module, batch, torch.Generator())
        losses[float(coeff)] = loss.item()
    reg = sum(float(np.sum(np.asarray(leaf, np.float64) ** 2))
              for name in ("prior", "posterior", "fcomb")
              for leaf in jax.tree.leaves(runs.params["params"][name]))
    assert set(runs.params["params"]) == {"base", "prior", "posterior", "fcomb"}
    np.testing.assert_allclose(losses[1e-5] - losses[0.0], 1e-5 * reg, rtol=1e-3)


def test_prob_unet_three_optimizer_steps_across_the_beta_warmup_match_optax(runs, monkeypatch):
    inject_draws(monkeypatch)
    check_three_steps(runs, epochs=(0, 1, 2))


def test_prob_unet_fit_across_the_beta_warmup_matches_jax(runs):
    got = check_fit(runs, port_only=("beta",))
    spec = runs.jt.built.prob_unet_spec
    assert spec.regularizer_coeff == runs.tt.built.prob_unet_spec.regularizer_coeff == 1e-5
    assert [r["beta"] for r in got] == [float(np.float32(spec.beta_at_epoch(e)))
                                        for e in (0, 1)] == [float(np.float32(b))
                                                             for b in (0.0025, 0.005)]
    assert {"val_loss", "val_dice", "val_ged"} <= set(got[0])


@pytest.mark.parametrize("use_ema", [False, True])
def test_prob_unet_evaluate_matches_jax(runs, monkeypatch, use_ema):
    inject_draws(monkeypatch)
    check_evaluate(runs, use_ema)


def test_prob_unet_flax_init_of_the_latent_heads_and_fcomb(toy_dir, tmp_path):
    """At model channels 32, so that the latent heads (64 -> 12) and the
    fcomb's layers hold enough elements for their std."""
    check_new_init_leaves(*family_configs("prob_unet", toy_dir, tmp_path, *RUNS,
                                          "network.model_channels=32"), {
        "prior.param_head.weight": "kaiming", "posterior.param_head.weight": "kaiming",
        "prior.param_head.bias": "normal_1e-2", "posterior.param_head.bias": "normal_1e-2",
        "fcomb.body_0.weight": "lecun", "fcomb.body_2.weight": "lecun",
        "fcomb.head.weight": "lecun", "fcomb.body_0.bias": "zero",
        "base.out_conv.weight": "zero"})


def test_prob_unet_jax_run_exported_and_resumed_in_the_port_equals_jax(runs, tmp_path,
                                                                      monkeypatch):
    inject_draws(monkeypatch)
    check_export_resume(runs, tmp_path, port_only=("beta",))


def test_prob_unet_port_checkpoint_runs_in_the_port_infer_job(runs, tmp_path):
    check_infer_job(runs, tmp_path)
