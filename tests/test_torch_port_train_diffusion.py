"""Port parity of the diffusion family's training (``models/diffusion.py``'s
training half, ``train/losses.py``, ``train/loop.py``) against the JAX
package on the same numpy inputs, and the helpers the SSN and prob-U-Net
files share (``test_torch_port_train_ssn.py``,
``test_torch_port_train_prob_unet.py``).

The net is the small one of ``tests/test_train.py`` on unet16's config
group at 32x32 (16 train and 6 val images, batch 8), float32, both sides on
the CPU, eu none; the JAX weights are carried across with ``flax_to_torch``
from the JAX trainer's own init with noise on every leaf
(``test_torch_port_train.py::noisy``). JAX and torch draw differently, so
every draw is injected on both sides (:func:`inject_draws`) as a fixed
normal array chosen by its shape (:func:`fixed_normal`): the diffusion
times ``t`` and noise ``eps`` (JAX ``sample_t`` and ``jax.random.normal`` in
``models/diffusion.py`` and ``train/loop.py``; the port's
``models/diffusion.py::draw_t`` and ``draw_eps``), the SSN's eps_R and eps_N
(JAX ``models/ssn.py::sample_n``; the port's ``draw_normal``), the
posterior latent (``sample_latent`` in both ``train/losses.py``) and the
rater (``test_torch_port_train_fit.py::fixed_rater_patches``). A jitted JAX
function traces once, so it sees the same draws at every call; the port's
replacements return the same arrays at every call.

Cases here: the gamma schedules on the device, the loss weights, the masked
losses and the t samplers; the loss and every gradient; three optimizer
steps; a two-epoch ``fit`` with DDPM validation; ``evaluate`` with the raw
and the EMA weights; the flax init of the time embedding; a JAX run saved
after its first epoch, exported (``export_torch_checkpoint.py``, Adam state
included) and resumed in the port, equal to JAX going on; a port-trained
checkpoint through the port's inference job. Tolerances: the loss and
gradients atol 1e-5 / rtol 1e-4, parameters, moments, EMA and metrics 1e-5,
AdamW's eps-dominated elements to its bound
(``test_torch_port_train.py::mark_flat``).
"""

from __future__ import annotations

import json
import shutil
import types
import zlib
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.models.diffusion as j_diffusion
import diffuncertainty_tpu.models.ssn as j_ssn
import diffuncertainty_tpu.train.cli as j_cli
import diffuncertainty_tpu.train.losses as j_losses
import diffuncertainty_tpu.train.loop as j_loop
import export_torch_checkpoint
from diffuncertainty_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.train.loop import Trainer as JTrainer
import diffuncertainty_tpu_torch.models.diffusion as t_diffusion
import diffuncertainty_tpu_torch.models.ssn as t_ssn
import diffuncertainty_tpu_torch.train.cli as t_cli
import diffuncertainty_tpu_torch.train.losses as t_losses
from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.infer import cli as t_infer_cli
from diffuncertainty_tpu_torch.models.factory import build_model as t_build_model
from diffuncertainty_tpu_torch.models.unet import flax_init_
from diffuncertainty_tpu_torch.train.loop import Trainer as TTrainer
from test_torch_port_train import (ATOL, RTOL, STEP_TOL, assert_state_close, jax_adam,
                                   jax_state, noisy, tokens, toy_batch, toy_dir, track_flat)
from test_torch_port_train_fit import assert_same_checkpoint, fixed_rater_patches, records
from torch_threads import one_torch_thread  # noqa: F401

LR = 0.003  # SMALL_NET's learning rate
__all__ = ["one_torch_thread", "toy_dir"]


# ---- shared by the three family files ---------------------------------------


def fixed_normal(shape) -> np.ndarray:
    """A float32 standard normal array that depends on ``shape`` alone."""
    shape = tuple(int(s) for s in shape)
    rng = np.random.default_rng(zlib.crc32(repr(shape).encode()))
    return rng.standard_normal(shape).astype(np.float32)


def fixed_t(bs: int) -> np.ndarray:
    """Stratified training times in (0, 1), fixed by the batch size."""
    rng = np.random.default_rng(1000 + bs)
    return ((rng.permutation(bs) + rng.uniform(0.05, 0.95, bs)) / bs).astype(np.float32)


class _JaxWithFixedNormal:
    """``jax`` for a JAX module whose normal draws are replaced: everything
    else is jax's own."""

    def __init__(self):
        self.random = types.SimpleNamespace(
            **{k: getattr(jax.random, k) for k in dir(jax.random) if not k.startswith("_")})
        self.random.normal = lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
            fixed_normal(shape), dtype)

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_sample_n(dist, rng, num_samples):
    b, n = dist.mean.shape
    r = dist.cov_factor.shape[-1]
    eps_r = jnp.asarray(fixed_normal((num_samples, b, r)))
    eps_n = jnp.asarray(fixed_normal((num_samples, b, n)))
    return (dist.mean + jnp.einsum("bnr,sbr->sbn", dist.cov_factor, eps_r)
            + jnp.sqrt(dist.cov_diag) * eps_n)


def _torch_fixed(shape, dtype, device="cpu"):
    return torch.from_numpy(fixed_normal(shape)).to(device=device, dtype=dtype)


def inject_draws(mp: pytest.MonkeyPatch) -> None:
    """The same draws on both sides (module docstring), the rater ``b % R``
    and JAX's python loader path."""
    fixed_rater_patches(mp)
    mp.setattr(j_diffusion.ContinuousGaussianDiffusion, "sample_t",
               lambda self, rng, bs: jnp.asarray(fixed_t(bs)))
    mp.setattr(j_diffusion, "jax", _JaxWithFixedNormal())
    mp.setattr(j_loop, "jax", _JaxWithFixedNormal())
    mp.setattr(j_ssn, "sample_n", _jax_sample_n)
    mp.setattr(j_losses, "sample_latent",
               lambda p, rng: p.mu + p.sigma * jnp.asarray(fixed_normal(p.mu.shape)))
    mp.setattr(t_diffusion, "draw_t", lambda diff, bs, g: torch.from_numpy(fixed_t(bs)))
    mp.setattr(t_diffusion, "draw_eps", lambda shape, g, dtype: _torch_fixed(shape, dtype))
    mp.setattr(t_ssn, "draw_normal", lambda shape, g, dtype: _torch_fixed(shape, dtype))
    mp.setattr(t_losses, "sample_latent",
               lambda p, g: p.mu + p.sigma * _torch_fixed(p.mu.shape, p.mu.dtype))


def family_tokens(model: str, toy_dir, save_dir, *extra) -> list[str]:
    return [f"model={model}" if t.startswith("model=") else t
            for t in tokens(toy_dir, save_dir, *extra)]


def family_configs(model: str, toy_dir, tmp_path, *extra):
    """The same tokens through both command lines (the port's on the CPU)."""
    jcfg, _ = j_cli.parse_args(family_tokens(model, toy_dir, tmp_path / "jax", *extra))
    tcfg, special = t_cli.parse_args(family_tokens(model, toy_dir, tmp_path / "port", *extra)
                                     + ["device=cpu"])
    assert special["device"] == "cpu" and tcfg.model.au_type == model
    assert dict(tcfg.to_dict(), save_dir="") == dict(jcfg.to_dict(), save_dir="")
    return jcfg, tcfg


def jax_family_init(jcfg) -> dict:
    """The JAX trainer's initial weights (``init_state``'s inputs for the
    family, ``fold_in(key(seed), 7919)``), jitted; computed once per family,
    network and seed."""
    key = (jcfg.model.au_type, json.dumps(jcfg.to_dict()["network"], sort_keys=True),
           jcfg.seed)
    if key not in _JAX_INITS:
        _JAX_INITS[key] = _jax_family_init(jcfg)
    return jax.tree.map(np.copy, _JAX_INITS[key])


_JAX_INITS: dict = {}


def _jax_family_init(jcfg) -> dict:
    built = j_build_model(jcfg)
    module = built.module
    img = jnp.zeros((1, 32, 32, 3))
    if built.au_type == "diffusion":
        args = (jnp.zeros((1, 32, 32, module.in_channels)), jnp.zeros((1,)))
    elif built.au_type == "prob_unet":
        args = (img, jnp.zeros((1, 32, 32, built.num_classes)), module.init_input_latent(1))
    else:
        args = (img,)
    key = jax.random.fold_in(jax.random.key(jcfg.seed), 7919)
    variables = jax.jit(lambda k: module.init({"params": k}, *args))(key)
    return {"params": jax.tree.map(np.asarray, variables["params"])}


class Runs(NamedTuple):
    """The two-epoch run of one family on both sides, from the same weights."""

    jcfg: object
    tcfg: object
    params: dict
    jt: JTrainer
    jstate: object
    tt: TTrainer
    tstate: object
    flat: dict


FIT = ["trainer.max_epochs=2", "ckpt_save_freq.last_every_n_epochs=1",
       "ckpt_save_freq.use_linear_saving=true", "ckpt_save_freq.linear_freq=1"]
# The small net's GroupNorms have one channel per group (widths 8 and 16 are
# not multiples of 32), which normalizes away a constant added per channel:
# unet16's time embedding, added before ``out_norm``, then has an exact
# gradient of 0 and only rounding noise, which AdamW turns into steps of the
# learning rate. The diffusion runs apply it as a scale and shift after the
# norm (unet16's form, added before the norm, is a plain broadcast add).
SCALE_SHIFT = ["network.use_scale_shift_norm=true"]
# the runs: the loss weights of the JAX default (the config takes uniform)
RUNS = [*SCALE_SHIFT, "model.diffusion.weights_type=sigmoid_-4",
        "model.diffusion.decouple_loss_weights=true"]


def run_both(model: str, toy_dir, tmp, *extra) -> Runs:
    """The JAX and the port ``fit`` with the draws injected; JAX's ``last``
    checkpoint after epoch 0 is kept as ``last_epoch0`` beside its
    checkpoint directory."""
    with pytest.MonkeyPatch.context() as mp:
        inject_draws(mp)
        jcfg, tcfg = family_configs(model, toy_dir, tmp, *FIT, *extra)
        params = noisy(jax_family_init(jcfg))
        save_last = JTrainer._save_last

        def keep_epoch0(self, state, epoch):
            save_last(self, state, epoch)
            if epoch == 0:
                shutil.copytree(self._ckpt_dir() / "last", self.workdir / "last_epoch0")

        mp.setattr(JTrainer, "_save_last", keep_epoch0)
        jt = JTrainer(jcfg)
        train, val, train_eval = j_cli.build_loaders(jcfg)
        jstate = jt.fit(train, val, train_eval_loader=train_eval,
                        resume_state=jax_state(jt, params))
        tt = TTrainer(tcfg, device="cpu")
        flat = track_flat_relative(tt)
        tt.built.module.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
        train, val, train_eval = t_cli.build_loaders(tcfg)
        tstate = tt.fit(train, val, train_eval_loader=train_eval, resume_state=tt.fresh_state())
    return Runs(jcfg, tcfg, params, jt, jstate, tt, tstate, flat)


def track_flat_relative(trainer, rel: float = 1e-6) -> dict:
    """``test_torch_port_train.py::track_flat`` with the floor relative to
    the step's largest RMS gradient: the elements whose bias-corrected RMS
    gradient was in (0, rel * largest) after some step. The clip and the
    size of the loss scale every gradient alike, and so their rounding,
    which AdamW's eps turns into steps of the learning rate where the
    gradient is not far above it; ``mark_flat``'s absolute 1e-6 is this
    floor for the softmax loss, whose largest RMS gradient is of order 1."""
    flat: dict = {}
    step = trainer.train_step

    def marked(*args, **kwargs):
        state, aux = step(*args, **kwargs)
        opt = state.opt_state
        rms = {k: torch.sqrt(v / (1 - 0.999 ** opt.count)) for k, v in opt.nu.items()}
        floor = rel * max(float(r.max()) for r in rms.values())
        for k, r in rms.items():
            low = (r > 0) & (r < floor)
            flat[k] = low if k not in flat else flat[k] | low
        return state, aux

    trainer.train_step = marked
    return flat


def without(recs: list[dict], *keys) -> list[dict]:
    return [{k: v for k, v in r.items() if k not in keys} for r in recs]


def assert_records_close(got: list[dict], ref: list[dict]) -> None:
    """``metrics.jsonl`` records: the same keys in order, every value to 1e-5
    absolute or relative (the SSN's losses are in the hundreds)."""
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, atol=1e-5, rtol=1e-5, err_msg=k)


def assert_checkpoint_close(got_dir, ref_dir, flat, bound, moment_scale: float = STEP_TOL):
    """``test_torch_port_train_fit.py::assert_same_checkpoint``, with the
    Adam moments held to ``moment_scale`` of each leaf's largest element
    (at least ``moment_scale``): they are averages of the raw gradients and
    carry their float32 rounding."""
    if moment_scale == STEP_TOL:
        assert_same_checkpoint(got_dir, ref_dir, flat, bound)
        return
    ref, _, ref_meta = j_load_checkpoint(ref_dir)
    got, _, got_meta = load_checkpoint(got_dir)
    assert got_meta == ref_meta and set(got) == set(ref)
    for name in ("params", "ema_params"):
        if name in ref:
            assert_state_close(flax_to_torch(got[name]), flax_to_torch(ref[name]), STEP_TOL,
                               name, flat, bound)
    if "opt_state" in ref:
        adam = export_torch_checkpoint.adam_state(ref["opt_state"])
        assert int(got["step"]) == int(ref["step"]) == int(got["opt_state"]["count"]) == int(
            adam["count"])
        for m in ("mu", "nu"):
            assert_moments_close(flax_to_torch(got["opt_state"][m]), flax_to_torch(adam[m]),
                                 moment_scale, m)


def assert_moments_close(got: dict, ref: dict, scale: float, what: str) -> None:
    assert set(got) == set(ref), what
    for k, r in ref.items():
        g = got[k].detach() if torch.is_tensor(got[k]) else torch.as_tensor(got[k])
        atol = scale * max(1.0, float(r.abs().max()))
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=atol, rtol=STEP_TOL,
                                   err_msg=f"{what} {k}")


def check_fit(runs: Runs, port_only=(), moment_scale: float = STEP_TOL) -> list[dict]:
    """Both runs' records (the port's keys ``port_only`` set aside), their
    checkpoint directories and every array of each checkpoint; returns the
    port's records."""
    marked = sum(int(f.sum()) for f in runs.flat.values()) / sum(
        f.numel() for f in runs.flat.values())
    print(f"elements held to the AdamW bound: {marked:.4%}")
    assert marked < 0.02
    got = records(runs.tt.workdir)
    assert all(set(port_only) <= set(r) for r in got)
    assert_records_close(without(got, *port_only), records(runs.jt.workdir))
    names = sorted(p.name for p in (runs.jt.workdir / "checkpoints").iterdir())
    assert sorted(p.name for p in (runs.tt.workdir / "checkpoints").iterdir()) == names
    assert names == ["epoch_000001", "last"]
    for name in names:
        assert_checkpoint_close(runs.tt.workdir / "checkpoints" / name,
                                runs.jt.workdir / "checkpoints" / name, runs.flat, 2 * 4 * LR,
                                moment_scale)
    return got


def check_three_steps(runs: Runs, mean_only_steps=(False, False, False), epochs=(0, 0, 0),
                      grad_rel: float = STEP_TOL):
    """Three optimizer steps on fresh states from the run's initial weights
    (the JAX run's compiled steps, a new port trainer): parameters, EMA and
    count to STEP_TOL; each step's loss and the gradient-derived numbers
    (``grad_norm`` relative, the Adam moments as :func:`assert_moments_close`)
    to ``grad_rel``."""
    jt = runs.jt
    tt = TTrainer(runs.tcfg, workdir=runs.tt.workdir.parent / "steps", device="cpu")
    state = jax_state(jt, runs.params)
    tt.built.module.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, runs.params)))
    tstate = tt.fresh_state()
    flat = track_flat_relative(tt)
    for i, (mean_only, epoch) in enumerate(zip(mean_only_steps, epochs)):
        images, seg = toy_batch(10 + i)
        state, aux = jt._get_step(mean_only)(
            state, {"image": jnp.asarray(images), "seg": jnp.asarray(seg)}, jax.random.key(i),
            jt._sched_for_epoch(epoch))
        tt.set_epoch(epoch)
        assert tt.ssn_mean_only == mean_only
        tstate, taux = tt.train_step(tstate, {"image": images, "seg": seg}, torch.Generator())
        np.testing.assert_allclose(float(taux["loss"]), float(aux["loss"]), atol=STEP_TOL,
                                   rtol=STEP_TOL, err_msg="loss")
        np.testing.assert_allclose(float(taux["grad_norm"]), float(aux["grad_norm"]),
                                   atol=STEP_TOL, rtol=grad_rel, err_msg="grad_norm")
    adam = jax_adam(state.opt_state)
    assert tstate.step == int(state.step) == tstate.opt_state.count == int(adam.count) == 3
    for what, got, ref in (("mu", tstate.opt_state.mu, adam.mu),
                           ("nu", tstate.opt_state.nu, adam.nu)):
        assert_moments_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), grad_rel, what)
    for what, got, ref in (("params", tstate.params, state.params),
                           ("ema", tstate.ema_params, state.ema_params)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what,
                           flat, 2 * 3 * LR)
    return tstate


def check_evaluate(runs: Runs, use_ema: bool) -> dict:
    """``evaluate`` of the final states on the validation split (epoch 1)."""
    _, val, _ = j_cli.build_loaders(runs.jcfg)
    ref = runs.jt.evaluate(runs.jstate, val, epoch=1, use_ema=use_ema)
    _, val, _ = t_cli.build_loaders(runs.tcfg)
    got = runs.tt.evaluate(runs.tstate, val, epoch=1, use_ema=use_ema)
    assert list(got) == list(ref) == ["val_loss", "val_dice", "val_ged"]
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-5, err_msg=k)
    return got


def check_export_resume(runs: Runs, tmp_path, port_only=(), moment_scale: float = STEP_TOL
                        ) -> None:
    """JAX's checkpoint after epoch 0, exported and resumed in the port for
    epoch 1, equal to JAX's own epoch 1."""
    exported = export_torch_checkpoint.export(runs.jt.workdir / "last_epoch0",
                                              tmp_path / "exported")
    saved, _, meta = load_checkpoint(exported)
    assert meta["epoch"] == 0 and set(saved["opt_state"]) == {"count", "mu", "nu"}
    trainer = TTrainer(runs.tcfg, workdir=tmp_path / "resumed", device="cpu")
    flat = track_flat_relative(trainer)
    state = trainer.restore_state(saved)
    assert state.step == state.opt_state.count == 2
    train, val, train_eval = t_cli.build_loaders(runs.tcfg)
    trainer.fit(train, val, train_eval_loader=train_eval, resume_state=state, start_epoch=1)
    assert_records_close(without(records(trainer.workdir), *port_only),
                         records(runs.jt.workdir)[1:])
    assert_checkpoint_close(trainer.workdir / "checkpoints" / "last",
                            runs.jt.workdir / "checkpoints" / "last", flat, 2 * 2 * LR,
                            moment_scale)


def check_infer_job(runs: Runs, tmp_path, n_pred: int = 2) -> list[dict]:
    """The port-trained ``last`` checkpoint through the port's inference job
    on the CPU: six images, every Dice in [0, 1]."""
    ckpt = runs.tt.workdir / "checkpoints" / "last"
    summaries = t_infer_cli.main([
        "--checkpoint_paths", str(ckpt), "--test_split", "id", "--n_pred", str(n_pred),
        "--n_models", "1", "--ema_mode", "true", "--test_batch_size", "4", "--device", "cpu",
        "--metrics_only", "--save_dir", str(tmp_path / "results")])
    assert len(summaries) == 1 and summaries[0]["n_images"] == 6
    metrics = json.loads((Path(summaries[0]["out_dir"]) / "metrics.json").read_text())
    dice = [r["metrics"]["dice"] for r in metrics.values()]
    assert len(dice) == 6 and all(0.0 <= d <= 1.0 for d in dice)
    return summaries


def check_loss_and_gradients(jcfg, tcfg, params, batch, *, zero_grads=frozenset(),
                             sched=None, mean_only: bool = False, scale_atol: float = ATOL):
    """The loss and every gradient leaf of one batch (draws injected), JAX's
    loss jitted on its own: the loss to ATOL relative to its size, each
    leaf as :func:`compare_gradients` holds it."""
    images, seg = batch
    ignore = tcfg.data.ignore_index
    j_loss = j_losses.make_loss_fn(j_build_model(jcfg), ignore_index=ignore,
                                   n_aleatoric_samples=jcfg.model.n_aleatoric_samples,
                                   ssn_mean_only=mean_only)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        params, {"image": jnp.asarray(images), "seg": jnp.asarray(seg)}, jax.random.key(5),
        {k: jnp.float32(v) for k, v in (sched or {}).items()}, None)
    built = t_build_model(tcfg, device="cpu")
    built.module.load_state_dict(flax_to_torch(params))
    loss, aux = t_losses.make_loss_fn(
        built, ignore_index=ignore, n_aleatoric_samples=tcfg.model.n_aleatoric_samples,
        ssn_mean_only=mean_only)(
        built.module, {"image": torch.from_numpy(images), "seg": torch.from_numpy(seg)},
        torch.Generator(), sched)
    names, leaves = zip(*built.module.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=ATOL, rtol=ATOL)
    got = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, leaves, grads)}
    compare_gradients(got, flax_to_torch(jax.tree.map(np.asarray, ref_grads)), zero_grads,
                      float64_gradient_norms(tcfg, params, batch, sched, mean_only), scale_atol)
    return (loss.item(), aux), (float(ref_loss), ref_aux)


def check_step_gradients(runs: Runs, batch, *, epoch: int = 0, zero_grads=frozenset(),
                         scale_atol: float = ATOL):
    """The loss and every gradient leaf of one batch through one optimizer
    step from the run's initial weights: the run's compiled JAX step and a
    new port trainer. The first Adam moment after one step is (1 - b1) times
    the clipped gradient; divided by that factor (from JAX's ``grad_norm``,
    which the port's matches) it is the gradient, each leaf held as
    :func:`compare_gradients` holds it."""
    jt = runs.jt
    images, seg = batch
    state, aux = jt._get_step(False)(
        jax_state(jt, runs.params), {"image": jnp.asarray(images), "seg": jnp.asarray(seg)},
        jax.random.key(0), jt._sched_for_epoch(epoch))
    tt = TTrainer(runs.tcfg, workdir=runs.tt.workdir.parent / "grads", device="cpu")
    tt.built.module.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, runs.params)))
    tt.set_epoch(epoch)
    tstate, taux = tt.train_step(tt.fresh_state(), {"image": images, "seg": seg},
                                 torch.Generator())
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), atol=ATOL, rtol=ATOL,
                                   err_msg=k)
    norm, clip = float(aux["grad_norm"]), runs.tcfg.trainer.gradient_clip_val
    factor = 0.1 * (1.0 if norm < clip else clip / norm)  # (1 - b1) times the clip's
    ref = flax_to_torch(jax.tree.map(np.asarray, jax_adam(state.opt_state).mu))
    compare_gradients({k: v / factor for k, v in tstate.opt_state.mu.items()},
                      {k: v / factor for k, v in ref.items()}, zero_grads,
                      float64_gradient_norms(runs.tcfg, runs.params, batch, tt.sched, False),
                      scale_atol)
    return taux, aux


def compare_gradients(got: dict, ref: dict, zero_grads, exact: dict, scale_atol: float):
    """Each leaf to RTOL plus ``scale_atol`` times its largest element (at
    least ``scale_atol``: the SSN's and prob-U-Net's losses sum
    log-probabilities over the pixels, so their gradients reach the
    hundreds, where float32 keeps about 1e-5 of each leaf's scale).
    ``zero_grads`` are the leaves whose gradient is exactly 0 on both sides
    (their parameters do not reach the loss). The leaves whose exact
    gradient is 0 although they reach the loss (a bias before a GroupNorm of
    one channel per group), found by the port's same loss in float64
    (``exact``: every leaf's gradient norm), hold rounding alone on both
    sides: under 1e-6 of the largest gradient."""
    assert set(got) == set(ref)
    got_zero = {n for n, g in got.items() if not g.any()}
    assert {n for n, r in ref.items() if not r.any()} == got_zero == set(zero_grads)
    top = max(exact.values())
    null = {n for n, v in exact.items() if v < 1e-8 * top} - got_zero
    for name, g in got.items():
        g, r = g.detach(), ref[name]
        if name in null:
            assert max(float(g.abs().max()), float(r.abs().max())) < 1e-6 * top, name
        elif name not in got_zero:
            atol = scale_atol * max(1.0, float(r.abs().max()))
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=atol, rtol=RTOL,
                                       err_msg=name)


def float64_gradient_norms(tcfg, params, batch, sched, mean_only) -> dict[str, float]:
    """The L2 norm of every gradient leaf of the port's same loss in float64."""
    built = t_build_model(tcfg, device="cpu")
    built.module.load_state_dict(flax_to_torch(params))
    built.module.double()
    for m in built.module.modules():
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = torch.float64
    images, seg = batch
    loss, _ = t_losses.make_loss_fn(
        built, ignore_index=tcfg.data.ignore_index,
        n_aleatoric_samples=tcfg.model.n_aleatoric_samples, ssn_mean_only=mean_only)(
        built.module, {"image": torch.from_numpy(images).double(), "seg": torch.from_numpy(seg)},
        torch.Generator(), sched)
    names, leaves = zip(*built.module.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: 0.0 if g is None else float(g.norm()) for n, g in zip(names, grads)}


def check_new_init_leaves(jcfg, tcfg, new_leaves: dict) -> None:
    """``flax_init_`` of the family's module against JAX's ``init`` at the
    config's widths: the same leaves, the same zero leaves, and each leaf of
    ``new_leaves`` (name -> "lecun" | "kaiming" | "normal_1e-2" | "zero")
    drawn as JAX draws it: the std within 10% of JAX's and of the
    initializer's (15% for fewer than 256 elements; a normal(1e-2) bias of
    12 elements within a factor 2 of 1e-2), and a truncated kernel within
    2 std."""
    ref = flax_to_torch(jax_family_init(jcfg))
    built = t_build_model(tcfg, device="cpu")
    flax_init_(built.module, torch.Generator().manual_seed(0))
    got = built.module.state_dict()
    assert set(got) == set(ref)
    zeros = {k for k, v in ref.items() if not v.any()}
    assert {k for k, v in got.items() if not v.any()} == zeros
    for k, kind in new_leaves.items():
        g, r = got[k], ref[k]
        if kind == "zero":
            assert k in zeros, k
            continue
        assert k not in zeros, k
        if kind == "normal_1e-2":
            for v in (g, r):
                assert 0.5e-2 < float(v.std()) < 2e-2, k
            continue
        tol = 0.1 if r.numel() >= 256 else 0.15
        assert abs(float(g.std()) / float(r.std()) - 1) < tol, k
        std = np.sqrt((2.0 if kind == "kaiming" else 1.0) / g[0].numel())
        assert abs(float(r.std()) / std - 1) < tol, k
        for v in (g, r):
            assert float(v.abs().max()) <= 2 * std / 0.87962566 + 1e-6, k


# ---- the diffusion process's training half --------------------------------------

TS = np.array([0.0, 0.013, 0.25, 0.5, 0.77, 0.999], np.float32)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "linear_simple", "parabola"])
def test_device_gamma_schedule_matches_jax(schedule):
    jg = j_diffusion.GammaSchedule(schedule)
    tg = t_diffusion.GammaSchedule(schedule)
    t = torch.from_numpy(TS)
    for fn in ("gamma", "snr", "alpha", "sigma", "logsnr", "diff_logsnr"):
        got = getattr(tg, fn)(t)
        ref = np.asarray(getattr(jg, fn)(jnp.asarray(TS)))
        assert got.dtype == torch.float32, fn
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=fn)
    # the float32 device schedule against the float64 host one, away from t = 0
    # (there 1 - gamma is 4.5e-5, and float32 keeps its logSNR to about 0.02)
    np.testing.assert_allclose(tg.logsnr(t[1:]).numpy(), tg.logsnr_np(TS[1:]), atol=2e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("decouple", [False, True])
@pytest.mark.parametrize("weights", ["SNR", "SNR_plus1", "SNR_trunc", "uniform", "sigmoid",
                                     "sigmoid_-4"])
def test_loss_weights_match_jax(weights, decouple):
    kw = dict(weights_type=weights, decouple_loss_weights=decouple)
    t = np.array([0.05, 0.3, 0.6, 0.95], np.float32)
    ref = np.asarray(j_diffusion.ContinuousGaussianDiffusion(**kw).loss_weights(jnp.asarray(t)))
    got = t_diffusion.ContinuousGaussianDiffusion(**kw).loss_weights(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss_type", ["MSE", "BCE"])
def test_masked_loss_matches_jax(loss_type, masked):
    rng = np.random.default_rng(3)
    pred = rng.random((3, 5, 4, 2), dtype=np.float32)
    gt = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 5, 4))]
    mask = (rng.random((3, 5, 4, 1)) < 0.7).astype(np.float32) * np.ones((1, 1, 1, 2), np.float32)
    j = j_diffusion.ContinuousGaussianDiffusion(loss_type=loss_type)
    t = t_diffusion.ContinuousGaussianDiffusion(loss_type=loss_type)
    ref = np.asarray(j._masked_loss(jnp.asarray(pred), jnp.asarray(gt),
                                    jnp.asarray(mask) if masked else None))
    got = t._masked_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                         torch.from_numpy(mask) if masked else None)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("sampler", ["uniform", "low_discrepency", "uniform_low_d"])
def test_sample_t_draws_as_jax_does(sampler):
    """The PRNGs differ, so the draws are held to their law: in [0, 1),
    and for the stratified samplers one time in each of the bs strata, as
    JAX's own draws are."""
    bs = 16
    ref = np.asarray(j_diffusion.ContinuousGaussianDiffusion(sampler_type=sampler).sample_t(
        jax.random.key(0), bs))
    got = t_diffusion.ContinuousGaussianDiffusion(sampler_type=sampler).sample_t(
        torch.Generator().manual_seed(0), bs).numpy()
    assert got.shape == ref.shape == (bs,) and got.dtype == ref.dtype == np.float32
    for t in (got, ref):
        assert ((t >= 0) & (t < 1)).all()
        if sampler != "uniform":
            assert sorted(np.floor(t * bs).astype(int).tolist()) == list(range(bs))
    if sampler == "low_discrepency":  # one offset for all strata
        for t in (got, ref):
            assert np.ptp(t * bs - np.floor(t * bs)) < 1e-5
    with pytest.raises(NotImplementedError):
        t_diffusion.ContinuousGaussianDiffusion(sampler_type="sobol").sample_t(
            torch.Generator(), bs)


# ---- the family's training ----------------------------------------------------------

@pytest.fixture(scope="module")
def runs(toy_dir, tmp_path_factory):
    return run_both("diffusion", toy_dir, tmp_path_factory.mktemp("diffusion"), *RUNS)


def test_diffusion_loss_and_every_gradient_match_jax(runs, monkeypatch):
    """Ignored pixels (the ``loss_mask``) and the runs' ``sigmoid_-4``
    weights times -d logSNR/dt (the unmasked loss is
    ``test_masked_loss_matches_jax``)."""
    inject_draws(monkeypatch)
    check_step_gradients(runs, toy_batch(3, ignore=-1))


def test_diffusion_three_optimizer_steps_match_optax(runs, monkeypatch):
    inject_draws(monkeypatch)
    check_three_steps(runs)


def test_diffusion_fit_with_ddpm_validation_matches_jax(runs):
    got = check_fit(runs)
    assert {"val_loss", "val_dice", "val_ged", "train_eval_dice"} <= set(got[0])
    assert runs.tt.built.diffusion_sampler_type == "ddpm" and runs.tt.built.diffusion_num_steps == 3


@pytest.mark.parametrize("use_ema", [False, True])
def test_diffusion_evaluate_matches_jax(runs, monkeypatch, use_ema):
    inject_draws(monkeypatch)
    check_evaluate(runs, use_ema)


def test_diffusion_flax_init_of_the_time_embedding(toy_dir, tmp_path):
    check_new_init_leaves(*family_configs("diffusion", toy_dir, tmp_path, *RUNS), {
        "time_embed_0.weight": "lecun", "time_embed_1.weight": "lecun",
        "enc0_res.emb_proj.weight": "lecun", "mid0_res.emb_proj.weight": "lecun",
        "time_embed_0.bias": "zero", "enc0_res.emb_proj.bias": "zero",
        "input_conv.weight": "lecun"})


def test_diffusion_jax_run_exported_and_resumed_in_the_port_equals_jax(runs, tmp_path,
                                                                      monkeypatch):
    inject_draws(monkeypatch)
    check_export_resume(runs, tmp_path)


def test_diffusion_port_checkpoint_runs_in_the_port_infer_job(runs, tmp_path):
    check_infer_job(runs, tmp_path)
