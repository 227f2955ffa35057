"""Port parity of the HRNet's training (``models/hrnet.py``'s train mode and
stage dropout, ``train/losses.py``'s HRNet branch, ``train/loop.py``'s
``model_state``, the flax initializers) against the JAX package on the same
numpy inputs.

The net is the width-8 ``SMALL`` spec of ``test_torch_port_hrnet.py`` (one
module per stage, one block per branch) with stage dropout in stages 3 and
4 and the final dropout, on unet16's toy data at 32x32 (batch 8), both
sides on the CPU, float32; random weights and randomized BatchNorm
statistics (``test_torch_port_hrnet.py::random_variables``: zero means and
unit variances would hide a mean/var swap). Every draw is injected: the
stage dropout's channel masks (``test_torch_port_model.py::mask_for`` by
site, a JAX interceptor and the port's ``ChannelDropout.draw_mask``), the
final dropout's keep masks by shape (``jax`` in the JAX ``models/hrnet.py``
replaced by a namespace whose ``random.bernoulli`` returns them, the port's
``HRNet.draw_keep``), the SSN's normals and the rater
(``test_torch_port_train_diffusion.py::inject_draws``).

Tolerances. In train mode every BatchNorm divides by its batch's standard
deviation, and the float32 rounding of both sides grows through the
network: on these weights JAX's float32 logits sit up to 5e-5 from its own
float64 forward (the port's 2e-5). So the forward is held (a) in float64 on
both sides (``jax.enable_x64``) to 1e-9, where the semantics show with no
rounding in the way, and (b) in float32 no farther from the float64 logits
than JAX's own float32 forward (times 1.5); the running statistics to 1e-5
in float32. Training trajectories (a two-epoch ``fit`` with validation,
export and resume, three SSN steps) run in float64 on both sides and are
held to 1e-7 (the checkpoints hold the port's float32 and JAX's float64);
each float32 step (loss 1e-5, gradients and ``grad_norm`` to 1e-4 of their
scale, statistics 1e-5) against JAX's float64 step from the same state
(see the comment above ``F64_TOL`` for why).
"""

from __future__ import annotations

import copy
import dataclasses
import shutil
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffuncertainty_tpu.models.hrnet as j_hrnet
import diffuncertainty_tpu.train.cli as j_cli
import export_torch_checkpoint
from diffuncertainty_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.train.loop import Trainer as JTrainer
from diffuncertainty_tpu.train.loop import TrainState as JTrainState
import diffuncertainty_tpu_torch.train.cli as t_cli
from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.models.factory import build_model as t_build_model
from diffuncertainty_tpu_torch.models.hrnet import HRNet, HRNetSpec
from diffuncertainty_tpu_torch.models.unet import ChannelDropout, flax_init_
from diffuncertainty_tpu_torch.train.loop import Trainer as TTrainer
from test_torch_port_hrnet import SMALL, masks_by_shape, random_variables
from test_torch_port_model import jax_mask_interceptor, torch_draw_mask
from test_torch_port_train import STEP_TOL, assert_state_close, jax_adam, tokens, toy_batch, toy_dir
from test_torch_port_train_diffusion import (assert_moments_close, assert_records_close,
                                             inject_draws)
from test_torch_port_train_fit import records
from torch_threads import one_torch_thread  # noqa: F401

__all__ = ["one_torch_thread", "toy_dir"]
STAGE_DROPOUT = (0.1, 0.2, 0.3, 0.4)
GRAD_SCALE = 1e-4
TWO_EPOCHS = ["trainer.max_epochs=2", "ckpt_save_freq.last_every_n_epochs=1"]


def spec_kw(final_dropout: float = 0.2) -> dict:
    return dict(SMALL, stage_dropout=STAGE_DROPOUT, final_dropout=final_dropout)


class _JaxWithKeepMasks:
    """``jax`` for the JAX ``models/hrnet.py`` with its final dropout's
    ``random.bernoulli`` replaced by ``mask(shape)``."""

    def __init__(self, mask):
        self.random = types.SimpleNamespace(
            **{k: getattr(jax.random, k) for k in dir(jax.random) if not k.startswith("_")})
        self.random.bernoulli = lambda key, p, shape: jnp.asarray(mask(shape))

    def __getattr__(self, name):
        return getattr(jax, name)


def inject_masks(mp: pytest.MonkeyPatch):
    """The final dropout's keep masks by shape and the stage dropout's
    channel masks by site, on both sides (the JAX stage masks need
    :func:`jax_masks` around the trace)."""
    mask = masks_by_shape()
    mp.setattr(j_hrnet, "jax", _JaxWithKeepMasks(mask))
    mp.setattr(HRNet, "draw_keep", lambda self, branch, shape, generator, device:
               torch.from_numpy(mask(shape)).to(device))
    mp.setattr(ChannelDropout, "draw_mask", torch_draw_mask)


def jax_masks():
    return nn.intercept_methods(jax_mask_interceptor)


def hrnet_tokens(toy_dir, save_dir, model: str, *extra) -> list[str]:
    out = [t for t in tokens(toy_dir, save_dir, *extra, eu="dropout")
           if not t.startswith("network.")]
    return [{"network=unet16": "network=hrnet-s", "model=softmax": f"model={model}"}.get(t, t)
            for t in out] + ["model.ssn_rank=3", "trainer.learning_rate=0.003"]


def hrnet_pair(toy_dir, tmp_path, model: str = "softmax", *extra):
    """(JAX trainer, port trainer, JAX variables): the small HRNet in both
    trainers (the configs' hrnet-s replaced, as ``tests/test_hrnet.py`` does),
    the port's loaded with the same random weights and statistics."""
    jcfg, _ = j_cli.parse_args(hrnet_tokens(toy_dir, tmp_path / "jax", model, *extra))
    tcfg, _ = t_cli.parse_args(hrnet_tokens(toy_dir, tmp_path / "port", model, *extra)
                               + ["device=cpu"])
    assert dict(tcfg.to_dict(), save_dir="") == dict(jcfg.to_dict(), save_dir="")
    ssn = model == "ssn"
    jm = j_hrnet.HRNet(num_classes=2, spec=j_hrnet.HRNetSpec(**spec_kw()), ssn=ssn, ssn_rank=3)
    jt = JTrainer(jcfg, built=dataclasses.replace(j_build_model(jcfg), module=jm))
    tm = HRNet(2, HRNetSpec(**spec_kw()), ssn=ssn, ssn_rank=3)
    tt = TTrainer(tcfg, device="cpu", built=dataclasses.replace(t_build_model(tcfg, "cpu"),
                                                                module=tm))
    variables = random_variables(jm, seed=0, hw=32)
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    return jt, tt, variables


# ---- the train-mode forward ------------------------------------------------------

def test_train_mode_forward_and_running_statistics_match_jax(monkeypatch):
    inject_masks(monkeypatch)
    jm = j_hrnet.HRNet(num_classes=2, spec=j_hrnet.HRNetSpec(**spec_kw()))
    variables = random_variables(jm, seed=0, hw=64)
    tm = HRNet(2, HRNetSpec(**spec_kw()))
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    x = np.random.default_rng(1).standard_normal((4, 64, 64, 3))

    def jax_train(dtype):
        module = j_hrnet.HRNet(num_classes=2, spec=jm.spec, dtype=dtype)
        v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        with jax_masks():
            out, upd = jax.jit(lambda v, x: module.apply(
                v, x, True, rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"]))(
                v, jnp.asarray(x, dtype))
        stats = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": jax.tree.map(lambda a: np.asarray(a, np.float64),
                                             upd["batch_stats"])}
        return np.asarray(out.logits), np.asarray(out.features), stats

    # float64: the same semantics, no rounding in the way
    with jax.enable_x64(True):
        ref64, feat64, stats64 = jax_train(jnp.float64)
    t64 = copy.deepcopy(tm).double()
    t64.dtype = torch.float64
    out64 = t64(torch.from_numpy(x), torch.Generator(), train=True)
    np.testing.assert_allclose(out64.logits.detach().numpy(), ref64, atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(out64.features.detach().numpy(), feat64, atol=1e-9, rtol=1e-9)
    ref_stats = {k: v for k, v in _convert64(stats64).items() if "running" in k}
    assert set(out64.batch_stats) == set(ref_stats) and len(ref_stats) == 2 * 63
    for k, v in ref_stats.items():
        np.testing.assert_allclose(out64.batch_stats[k].numpy(), v, atol=1e-9, rtol=1e-9,
                                   err_msg=k)

    # float32: the statistics to 1e-5, the logits as near the float64 ones as JAX's
    ref32, _, stats32 = jax_train(jnp.float32)
    out = tm(torch.from_numpy(x).float(), torch.Generator(), train=True)
    own = np.abs(ref32 - ref64).max()
    got = np.abs(out.logits.detach().numpy() - ref64).max()
    assert own < 1e-4 and got <= 1.5 * own, (got, own)
    for k, v in _convert64(stats32).items():
        if "running" in k:
            np.testing.assert_allclose(out.batch_stats[k].numpy(), v, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
            # flax's rule: 0.9 * running + 0.1 * the batch's (float32, biased)
            assert not torch.equal(out.batch_stats[k], before[k]), k
    # the forward wrote no buffer; the eval forward still reads the old ones
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    # the masks act: stage dropout differs from a net without it
    plain = HRNet(2, HRNetSpec(**dict(spec_kw(), stage_dropout=(0.0,) * 4)))
    plain.load_state_dict(tm.state_dict())
    diff = plain(torch.from_numpy(x).float(), torch.Generator(), train=True).logits - out.logits
    assert diff.abs().max() > 1e-2


def _convert64(tree: dict) -> dict:
    """``flax_to_torch`` without its float32 cast (for the float64 statistics)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree["batch_stats"]):
        *mod, name = [p.key for p in path]
        out[".".join(mod + [{"mean": "running_mean", "var": "running_var"}[name]])] = leaf
    return out


def test_flax_init_of_the_hrnet_matches_flax_initializers():
    """The HRNet's flax initializers (``models/unet.py::flax_init_``) on the
    leaves of the JAX model's init (its shapes, ``jax.eval_shape``): every
    BatchNorm scale 1, bias 0, mean 0 and variance 1, the head convs' biases
    0, every conv kernel flax's ``lecun_normal`` (a normal truncated at two
    standard deviations whose std is 1/sqrt(fan_in): within 15% on each
    kernel)."""
    jm = j_hrnet.HRNet(num_classes=2, spec=j_hrnet.HRNetSpec(**SMALL), ssn=True, ssn_rank=3)
    shapes = jax.eval_shape(lambda k, x: jm.init({"params": k}, x, True), jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    ref = flax_to_torch(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), dict(shapes)))
    tm = HRNet(2, HRNetSpec(**SMALL), ssn=True, ssn_rank=3)
    for p in tm.parameters():  # so that every leaf is drawn or set
        torch.nn.init.constant_(p, 7.0)
    flax_init_(tm, torch.Generator().manual_seed(0))
    got = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                           for k, v in ref.items()}
    for k, v in got.items():
        leaf = k.rsplit(".", 1)[-1]
        if v.ndim == 4:  # conv kernels
            std = 1.0 / np.sqrt(v[0].numel())
            assert abs(float(v.std()) / std - 1) < 0.15, k
            assert float(v.abs().max()) <= 2 * std / 0.87962566 + 1e-6, k
        elif leaf in ("weight", "running_var"):
            assert torch.equal(v, torch.ones_like(v)), k
        else:  # biases, running means
            assert leaf in ("bias", "running_mean") and not v.any(), k


# ---- training -------------------------------------------------------------------
# Train mode makes this small random network chaotic: after the first AdamW
# step (every weight moved by about the learning rate) some channels carry
# almost no batch variance, and BatchNorm divides by it, so a change of 1e-8
# in the weights moves the next step's gradients by up to 1e-3 and AdamW
# turns that into steps of the learning rate. In float32 the two sides part
# after one step for that reason alone; so the trajectories are compared in
# float64 on both sides (``jax.enable_x64``, the port's module in float64,
# float64 images), where they agree to 1e-12 over the steps, and each
# float32 quantity of one step (loss, gradients, ``grad_norm``, statistics)
# against JAX's float64 step from the same state.
F64_TOL = 1e-7  # the checkpoints hold float32 (port) and float64 (JAX) arrays


class Float64Images:
    """A loader whose batches carry float64 images."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            yield dict(batch, image=batch["image"].astype(np.float64))


def loaders64(build, cfg):
    train, val, _ = build(cfg)
    return Float64Images(train), Float64Images(val)


def to_float64(trainer: TTrainer) -> None:
    trainer.built.module.double()
    trainer.built.module.dtype = torch.float64


def jax_hrnet_state64(trainer, variables, adam: dict | None = None, step: int = 0,
                      ema: dict | None = None) -> JTrainState:
    """The JAX state in float64 (call under ``jax.enable_x64``), from flax
    ``variables`` and, given them, the Adam state, step and EMA."""
    def f64(tree):  # float32 values, as the port's bridge reads every array
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), tree)

    params = {"params": f64(variables["params"])}
    opt_state = trainer.tx.init(params)
    if adam is not None:
        opt_state = jax.tree.map(
            lambda s: optax.ScaleByAdamState(jnp.asarray(adam["count"], jnp.int32),
                                             {"params": f64(adam["mu"]["params"])},
                                             {"params": f64(adam["nu"]["params"])})
            if isinstance(s, optax.ScaleByAdamState) else s,
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    ema = params if ema is None else {"params": f64(ema["params"])}
    return JTrainState(jnp.asarray(step, jnp.int32), params, opt_state,
                       jax.tree.map(jnp.copy, ema),
                       {"batch_stats": f64(variables["batch_stats"])})


def check_float32_step(jt, state64, tcfg, variables, batch, tmp_path) -> None:
    """One float32 port step from ``variables`` against JAX's float64 step
    from the same state (``state64``, under x64): loss 1e-5, gradients
    (``mu`` / 0.1) and ``grad_norm`` to GRAD_SCALE of their scale, the
    running statistics to 1e-5."""
    with jax.enable_x64(True), jax_masks():
        state, aux = jt._get_step(False)(
            state64, {k: jnp.asarray(batch[k], jnp.float64 if k == "image" else None)
                      for k in ("image", "seg")}, jax.random.key(0), {})
        mu = jax.tree.map(lambda m: np.asarray(m, np.float64) / 0.1,
                          jax_adam(state.opt_state).mu)
        stats = jax.tree.map(np.asarray, state.model_state["batch_stats"])
        loss, norm = float(aux["loss"]), float(aux["grad_norm"])
    ssn = tcfg.model.au_type == "ssn"
    tm = HRNet(2, HRNetSpec(**spec_kw()), ssn=ssn, ssn_rank=3)
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    tt = TTrainer(tcfg, device="cpu", workdir=tmp_path / "f32",
                  built=dataclasses.replace(t_build_model(tcfg, "cpu"), module=tm))
    tstate, taux = tt.train_step(tt.fresh_state(), {"image": np.asarray(batch["image"],
                                                                         np.float32),
                                                    "seg": batch["seg"]}, torch.Generator())
    np.testing.assert_allclose(float(taux["loss"]), loss, rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(float(taux["grad_norm"]), norm, rtol=GRAD_SCALE)
    grads = flax_to_torch(mu)
    assert sum(float(v.abs().max()) > 0 for v in grads.values()) > 0.9 * len(grads)
    assert_moments_close({k: v / 0.1 for k, v in tstate.opt_state.mu.items()}, grads,
                         GRAD_SCALE, "gradient")
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, variables["params"]),
                         "batch_stats": stats})
    for k, v in tstate.model_state.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def softmax_runs(toy_dir, tmp_path_factory):
    """Two epochs of ``fit`` on both sides in float64 (validation each epoch),
    the masks injected; JAX's ``last`` after epoch 0 kept as ``last_epoch0``.
    Then one float32 port step against JAX's compiled float64 step."""
    tmp = tmp_path_factory.mktemp("hrnet_fit")
    with pytest.MonkeyPatch.context() as mp:
        inject_draws(mp)
        inject_masks(mp)
        jt, tt, variables = hrnet_pair(toy_dir, tmp, "softmax", *TWO_EPOCHS)
        to_float64(tt)
        save_last = JTrainer._save_last

        def keep_epoch0(self, state, epoch):
            save_last(self, state, epoch)
            if epoch == 0:
                shutil.copytree(self._ckpt_dir() / "last", self.workdir / "last_epoch0")

        mp.setattr(JTrainer, "_save_last", keep_epoch0)
        train, val = loaders64(j_cli.build_loaders, jt.cfg)
        with jax.enable_x64(True), jax_masks():  # the jitted step and evaluation trace inside
            jstate = jt.fit(train, val, resume_state=jax_hrnet_state64(jt, variables))
            ref_ema = jt.evaluate(jstate, val, epoch=1, use_ema=True)
            start = jax_hrnet_state64(jt, variables)
        train, val = loaders64(t_cli.build_loaders, tt.cfg)
        tstate = tt.fit(train, val, resume_state=tt.fresh_state())
        got_ema = tt.evaluate(tstate, val, epoch=1, use_ema=True)
        check_float32_step(jt, start, tt.cfg, variables, next(iter(train)), tmp)
    return types.SimpleNamespace(jt=jt, tt=tt, jstate=jstate, tstate=tstate,
                                 variables=variables, ref_ema=ref_ema, got_ema=got_ema)


def assert_hrnet_checkpoint_close(got_dir, ref_dir):
    """Meta, keys, ``params`` and ``ema_params`` with the run's statistics,
    the Adam moments and the counts."""
    ref, _, ref_meta = j_load_checkpoint(ref_dir)
    got, _, got_meta = load_checkpoint(got_dir)
    assert got_meta == ref_meta and set(got) == set(ref) == {"params", "ema_params",
                                                              "opt_state", "step"}
    for name in ("params", "ema_params"):
        assert set(got[name]) == {"params", "batch_stats"}
        assert_state_close(flax_to_torch(got[name]), flax_to_torch(ref[name]), F64_TOL, name)
    # the EMA carries the raw run's statistics
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got["ema_params"]["batch_stats"]),
        jax.tree.leaves(got["params"]["batch_stats"])))
    adam = export_torch_checkpoint.adam_state(ref["opt_state"])
    assert int(got["step"]) == int(ref["step"]) == int(got["opt_state"]["count"]) == int(
        adam["count"])
    for m in ("mu", "nu"):
        assert_moments_close(flax_to_torch(got["opt_state"][m]), flax_to_torch(adam[m]),
                             F64_TOL, m)


def test_hrnet_fit_and_evaluate_match_jax(softmax_runs):
    r = softmax_runs
    got = records(r.tt.workdir)
    assert_records_close(got, records(r.jt.workdir))
    assert {"val_loss", "val_dice", "val_ged"} <= set(got[0]) and len(got) == 2
    for k, v in r.ref_ema.items():
        np.testing.assert_allclose(r.got_ema[k], v, atol=1e-5, rtol=1e-5, err_msg=k)
    assert_hrnet_checkpoint_close(r.tt.workdir / "checkpoints" / "last",
                                  r.jt.workdir / "checkpoints" / "last")
    # the statistics moved from the random start, in the module's own buffers
    start = flax_to_torch(r.variables)
    moved = [k for k, v in r.tstate.model_state.items() if not torch.equal(v.float(), start[k])]
    assert len(moved) == len(r.tstate.model_state) == 2 * 63
    assert r.tstate.model_state["stem_bn1.running_mean"].data_ptr() == (
        r.tt.built.module.stem_bn1.running_mean.data_ptr())


def test_hrnet_export_and_resume_match_jax(softmax_runs, tmp_path, monkeypatch):
    """JAX's checkpoint after epoch 0 (params with batch_stats, the Adam
    state, step, EMA) exported and restored by the port: every array as
    exported; then epoch 1 in the port and in JAX, both from the exported
    arrays (float32: JAX's float64 run goes on from their rounding too), the
    same records and ``last`` checkpoint."""
    inject_draws(monkeypatch)
    inject_masks(monkeypatch)
    r = softmax_runs
    exported = export_torch_checkpoint.export(r.jt.workdir / "last_epoch0", tmp_path / "exp")
    saved, _, meta = load_checkpoint(exported)
    assert meta["epoch"] == 0 and set(saved["params"]) == {"params", "batch_stats"}
    _, trainer, _ = hrnet_pair(r.tt.cfg.data.data_input_dir, tmp_path, "softmax", *TWO_EPOCHS)
    to_float64(trainer)
    state = trainer.restore_state(saved)
    for got, name in ((({**state.params, **state.model_state}), "params"),
                      (state.ema_params, "ema_params")):
        ref = flax_to_torch(saved[name])
        assert all(torch.equal(got[k].float(), ref[k]) for k in got) and set(ref) >= set(got)
    assert set(state.ema_params) == set(state.params) and state.step == 2
    train, val = loaders64(t_cli.build_loaders, trainer.cfg)
    trainer.fit(train, val, resume_state=state, start_epoch=1)
    jt = r.jt
    jt.workdir, jt._logger = tmp_path / "jax_resumed", None
    train, val = loaders64(j_cli.build_loaders, jt.cfg)
    with jax.enable_x64(True), jax_masks():
        jt.fit(train, val, start_epoch=1, resume_state=jax_hrnet_state64(
            jt, saved["params"], adam=saved["opt_state"], step=int(saved["step"]),
            ema=saved["ema_params"]))
    assert_records_close(records(trainer.workdir), records(jt.workdir))
    assert_hrnet_checkpoint_close(trainer.workdir / "checkpoints" / "last",
                                  jt.workdir / "checkpoints" / "last")


def test_hrnet_ssn_gradients_and_three_adamw_steps_match_jax(toy_dir, tmp_path, monkeypatch):
    """The SSN family on the HRNet (multi-rater targets, three draws): three
    steps in float64, each step's loss and ``grad_norm``, and the
    parameters, EMA, moments and statistics after them; one float32 step's
    loss, gradients and statistics."""
    inject_draws(monkeypatch)
    inject_masks(monkeypatch)
    jt, tt, variables = hrnet_pair(toy_dir, tmp_path, "ssn", "model.n_aleatoric_samples=3",
                                   "model.ssn_pretrain_epochs=0")
    to_float64(tt)
    tstate = tt.fresh_state()
    batches = [toy_batch(10 + i, raters=4) for i in range(3)]
    with jax.enable_x64(True), jax_masks():
        state = start = jax_hrnet_state64(jt, variables)
        start = jax.tree.map(jnp.copy, start)  # the step donates its state
        for images, seg in batches:
            images = images.astype(np.float64)
            state, aux = jt._get_step(False)(
                state, {"image": jnp.asarray(images), "seg": jnp.asarray(seg)},
                jax.random.key(0), {})
            tstate, taux = tt.train_step(tstate, {"image": images, "seg": seg},
                                         torch.Generator())
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=F64_TOL,
                                           err_msg=k)
            assert float(taux["cov_failed"]) == float(aux["cov_failed"]) == 0.0
        adam = jax_adam(state.opt_state)
        moments = {m: flax_to_torch(jax.tree.map(np.asarray, getattr(adam, m)))
                   for m in ("mu", "nu")}
        ref = flax_to_torch({"params": jax.tree.map(np.asarray, state.params["params"]),
                             "batch_stats": jax.tree.map(np.asarray,
                                                         state.model_state["batch_stats"])})
        ema = flax_to_torch(jax.tree.map(np.asarray, state.ema_params))
    for m, r in moments.items():
        assert_moments_close(getattr(tstate.opt_state, m), r, F64_TOL, m)
    assert_state_close({**tstate.params, **tstate.model_state}, ref, F64_TOL,
                       "params and statistics")
    assert_state_close(tstate.ema_params, ema, F64_TOL, "ema")
    images, seg = batches[0]
    check_float32_step(jt, start, tt.cfg, variables, {"image": images, "seg": seg}, tmp_path)


def test_ckpt_path_loads_the_hrnet_weights_and_statistics(toy_dir, tmp_path, monkeypatch):
    """``ckpt_path=`` on an HRNet checkpoint: the command line's trainer
    starts from its weights and its ``batch_stats`` (the module's buffers,
    in ``model_state``) with a fresh optimizer."""
    toks = [t for t in hrnet_tokens(toy_dir, tmp_path, "softmax") if not t.startswith("model.")]
    cfg, _ = t_cli.parse_args(toks + ["device=cpu"])
    source = TTrainer(cfg, device="cpu", workdir=tmp_path / "source")
    state = source.init_state()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for v in list(state.params.values()) + list(state.model_state.values()):
            v.add_(0.1 * torch.rand(v.shape, generator=gen))
    source._save_last(state, epoch=3)
    ckpt = source.workdir / "checkpoints" / "last"
    seen = {}

    def capture(self, *args, resume_state=None, start_epoch=0, **kw):
        seen.update(state=resume_state, start_epoch=start_epoch)
        return resume_state

    monkeypatch.setattr(TTrainer, "fit", capture)
    t_cli.main(toks + [f"ckpt_path={ckpt}", "device=cpu"])
    got = seen["state"]
    assert seen["start_epoch"] == 0 and got.step == 0 and got.opt_state.count == 0
    assert not any(v.any() for v in got.opt_state.mu.values())
    for k, v in {**state.params, **state.model_state}.items():
        mine = got.model_state[k] if "running" in k else got.params[k]
        assert torch.equal(mine, v), k
