"""Port parity of the SSN family's training (``train/losses.py``'s
Monte-Carlo log-likelihood over the low-rank normal, ``train/loop.py``'s
mean-only pretraining epochs) against the JAX package on the same numpy
inputs, with every draw injected on both sides (the eps_R and eps_N of the
S = ``n_aleatoric_samples`` draws, the rater). The small net, data and
tolerances of ``test_torch_port_train_diffusion.py``, whose helpers this
file shares; ``model.ssn_pretrain_epochs=1``, so the two-epoch runs flip
from the mean-only loss to the full one after epoch 0.

The port takes the capacitance I + W^T D^-1 W and its Cholesky factor in
float64, the JAX package in float32 (ROADMAP Queue 3, a deliberate
difference). The losses are held to 1e-5 where both sides agree that no
element's covariance failed (``cov_failed`` 0 on both); one case pins the
difference where JAX's float32 factor fails and the port's does not.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.train.losses as j_losses
from diffuncertainty_tpu_torch.models.unet import UnetOutput
import diffuncertainty_tpu_torch.train.losses as t_losses
from test_torch_port_train import noisy, toy_batch, toy_dir
from test_torch_port_train_diffusion import (check_evaluate, check_export_resume, check_fit,
                                             check_infer_job, check_loss_and_gradients,
                                             check_new_init_leaves, check_three_steps,
                                             family_configs, inject_draws, jax_family_init,
                                             records, run_both)
from torch_threads import one_torch_thread  # noqa: F401

__all__ = ["one_torch_thread", "toy_dir"]
PRETRAIN = ["model.ssn_pretrain_epochs=1"]
# The loss sums the log-probabilities of the 32x32 pixels of each draw (about
# 840 here, which float32 keeps to about 6e-5) before the logsumexp over the
# draws, whose weights pass that rounding on to every gradient: with three
# draws the port's own float32 gradient lies up to 3.6e-5 of a leaf's
# largest element from its float64 one, and JAX's (whose GroupNorm
# statistics stay float32 even under x64) as far. The loss case with three
# draws holds the gradients to 1e-4 of each leaf's scale, the loss to 1e-5.
# The runs take one draw per step, where the logsumexp is the identity: the
# losses, parameters and EMA to 1e-5, ``grad_norm`` and the Adam moments
# (averages of the raw gradients) to 1e-4 of their scale.
GRAD_SCALE = 1e-4
FACTOR_HEAD = {"ssn_factor_norm.weight", "ssn_factor_norm.bias", "ssn_factor_conv.weight",
               "ssn_factor_conv.bias"}


@pytest.fixture(scope="module")
def runs(toy_dir, tmp_path_factory):
    return run_both("ssn", toy_dir, tmp_path_factory.mktemp("ssn"), *PRETRAIN,
                    "model.n_aleatoric_samples=1")


def test_ssn_loss_and_every_gradient_match_jax(toy_dir, tmp_path, monkeypatch):
    """The full loss with three draws; no covariance fails on either side.
    The pretraining loss, whose factor head gets a zero gradient, is the
    first of the three optimizer steps below."""
    inject_draws(monkeypatch)
    jcfg, tcfg = family_configs("ssn", toy_dir, tmp_path, *PRETRAIN)
    params = noisy(jax_family_init(jcfg))
    (_, aux), (_, ref_aux) = check_loss_and_gradients(
        jcfg, tcfg, params, toy_batch(3, b=4, ignore=-1), scale_atol=GRAD_SCALE)
    assert float(aux["cov_failed"]) == float(ref_aux["cov_failed"]) == 0.0


def test_ssn_loss_where_jax_float32_capacitance_fails_and_the_port_does_not(monkeypatch):
    """Nearly collinear factor columns over N = 32768 logits with a small
    diag (``test_torch_port_ssn.py::test_a_valid_covariance_does_not_fail_for_float32_rounding``):
    JAX's float32 Cholesky fails, so it zeroes the factor and trains the
    diag-only normal (its loss is the port's loss with the factor zeroed,
    and its factor gets no gradient); the port's float64 one succeeds, so it
    trains the low-rank normal the outputs describe."""
    inject_draws(monkeypatch)
    rng = np.random.default_rng(4)
    b, hw, c, r = 2, 128, 2, 10
    n = hw * hw * c
    u = rng.standard_normal((b, n, 1)).astype(np.float32)
    outputs = {"mean": 0.1 * rng.standard_normal((b, n)).astype(np.float32),
               "diag": np.full((b, n), 1e-4, np.float32),
               "factor": (30.0 * u * rng.standard_normal((b, 1, r))
                          + 1e-3 * rng.standard_normal((b, n, r))).astype(np.float32)}
    seg = (rng.random((b, hw, hw)) < 0.3).astype(np.int32)

    def jax_apply(params, x, rngs=None, mean_only=False):
        return types.SimpleNamespace(
            logits=params["mean"].reshape(b, hw, hw, c), ssn_mean=params["mean"],
            ssn_cov_diag=params["diag"], ssn_cov_factor=params["factor"])

    built = types.SimpleNamespace(au_type="ssn", num_classes=c, backbone="diff_unet",
                                  needs_dropout_rng=False,
                                  module=types.SimpleNamespace(apply=jax_apply))
    j_loss = j_losses.make_loss_fn(built, ignore_index=-1, n_aleatoric_samples=3)
    (ref, ref_aux), ref_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {"image": jnp.zeros((b, hw, hw, 3)), "seg": jnp.asarray(seg)}, jax.random.key(0), {})
    assert float(ref_aux["cov_failed"]) == 1.0 and not np.asarray(ref_grads["factor"]).any()

    def port_loss(factor_scale: float):
        leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in outputs.items()}

        def module(x, generator, mean_only=False):
            return UnetOutput(logits=leaves["mean"].reshape(b, hw, hw, c),
                              ssn_mean=leaves["mean"], ssn_cov_diag=leaves["diag"],
                              ssn_cov_factor=factor_scale * leaves["factor"])

        port = types.SimpleNamespace(au_type="ssn", num_classes=c, backbone="diff_unet")
        loss, aux = t_losses.make_loss_fn(port, ignore_index=-1, n_aleatoric_samples=3)(
            module, {"image": torch.zeros(b, hw, hw, 3), "seg": torch.from_numpy(seg)},
            torch.Generator())
        (g_factor,) = torch.autograd.grad(loss, [leaves["factor"]])
        return loss.item(), float(aux["cov_failed"]), g_factor

    full, failed, g_full = port_loss(1.0)
    diag_only, _, _ = port_loss(0.0)
    assert failed == 0.0 and g_full.abs().max() > 0
    np.testing.assert_allclose(diag_only, float(ref), rtol=1e-5)
    # the difference: the port's loss keeps the low-rank term JAX dropped
    assert abs(full - float(ref)) > 1e-2 * abs(float(ref))


def test_ssn_three_optimizer_steps_across_the_mean_only_flip_match_optax(runs, monkeypatch):
    """A mean-only step, whose factor head gets a zero gradient on both sides
    (its Adam moments stay 0), then two full ones."""
    inject_draws(monkeypatch)
    tstate = check_three_steps(runs, mean_only_steps=(True, False, False), epochs=(0, 1, 1),
                               grad_rel=GRAD_SCALE)
    assert all(tstate.opt_state.mu[k].any() for k in FACTOR_HEAD)


def test_ssn_fit_across_the_mean_only_flip_matches_jax(runs):
    got = check_fit(runs, port_only=("train_cov_failed",), moment_scale=GRAD_SCALE)
    assert [r["train_cov_failed"] for r in got] == [0.0, 0.0]
    assert {"val_loss", "val_dice", "val_ged"} <= set(got[0])


@pytest.mark.parametrize("use_ema", [False, True])
def test_ssn_evaluate_matches_jax(runs, monkeypatch, use_ema):
    inject_draws(monkeypatch)
    check_evaluate(runs, use_ema)


def test_ssn_flax_init_of_the_heads(toy_dir, tmp_path):
    check_new_init_leaves(*family_configs("ssn", toy_dir, tmp_path, *PRETRAIN), {
        "ssn_cov_conv.weight": "zero", "ssn_factor_conv.weight": "zero",
        "ssn_cov_conv.bias": "zero", "ssn_factor_conv.bias": "zero",
        "ssn_cov_norm.bias": "zero", "dec0_res.in_conv.weight": "lecun",
        "input_conv.weight": "lecun"})


def test_ssn_jax_run_exported_and_resumed_in_the_port_equals_jax(runs, tmp_path, monkeypatch):
    """Saved after the mean-only epoch, resumed in the full phase."""
    inject_draws(monkeypatch)
    check_export_resume(runs, tmp_path, port_only=("train_cov_failed",),
                        moment_scale=GRAD_SCALE)
    assert records(runs.jt.workdir)[1]["epoch"] == 1


def test_ssn_port_checkpoint_runs_in_the_port_infer_job(runs, tmp_path):
    check_infer_job(runs, tmp_path)
