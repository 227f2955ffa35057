"""Port parity of whole training runs: ``fit`` of the port's trainer against
the JAX trainer's on the same toy data (16 train and 6 val images at 32x32,
the small net of ``tests/test_train.py``, batch 8, two epochs of two steps,
float32, both on the CPU), from the same initial weights (the JAX trainer's
own with noise on every leaf, carried across with ``flax_to_torch``).

JAX's loaders take their python path (the native reader draws raters its own
way); the one rater each validation loss picks is injected on both sides as
rater ``b % R`` of element ``b``. Cases:

- (c) ``eu_method=none`` with the recipe's ``augment_mult=0``, so only the
  loaders' numpy draws are random: every ``metrics.jsonl`` value to 1e-5,
  the same checkpoint directories, and every array of the ``last`` and the
  scheduled checkpoints to 1e-5;
- (d) the same with ``eu_method=dropout`` and ``augment_mult=1``, the
  dropout masks (``tests/test_torch_port_model.py``) and the augmentation
  draws (``tests/test_torch_port_train.py``) injected on both sides;
- (e) SWAG-diag collection: the snapshot epochs and the moments;
- (f) ``resume_from`` after epoch 0 equal to the uninterrupted run, bit for
  bit, and ``ckpt_path`` giving a fresh optimizer (port only);
- a JAX run saved after its first epoch, exported with
  ``export_torch_checkpoint.py`` (its Adam state included) and resumed in
  the port for one epoch, equal to JAX's two-epoch run to 1e-5.

Parameters, the EMA and the SWAG means are held to 1e-5 except the
elements whose RMS gradient was above 0 and below 1e-6 at some step, where AdamW turns
float rounding into steps of up to the learning rate
(``test_torch_port_train.py::mark_flat``); those stay within 2 * lr per step.
"""

from __future__ import annotations

import contextlib
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.data.native_loader as j_native_loader
import diffuncertainty_tpu.train.cli as j_cli
import diffuncertainty_tpu.train.losses as j_losses
import export_torch_checkpoint
from diffuncertainty_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint
from diffuncertainty_tpu.train.loop import Trainer as JTrainer
import diffuncertainty_tpu_torch.train.cli as t_cli
import diffuncertainty_tpu_torch.train.losses as t_losses
from diffuncertainty_tpu_torch.core.checkpoint import flatten_state, load_checkpoint
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.models.unet import ChannelDropout
from diffuncertainty_tpu_torch.train.loop import Trainer as TTrainer
from test_torch_port_model import jax_mask_interceptor, torch_draw_mask
from test_torch_port_train import (assert_state_close, configs, inject_augment_draws, jax_init,
                                   jax_state, noisy, tokens, toy_dir, track_flat)
from torch_threads import one_torch_thread  # noqa: F401

LR = 0.003  # SMALL_NET's learning rate
METRIC_TOL = ARRAY_TOL = 1e-5
TWO_EPOCHS = ["trainer.max_epochs=2", "ckpt_save_freq.use_linear_saving=true",
              "ckpt_save_freq.linear_freq=1"]
__all__ = ["toy_dir"]


def fixed_rater_patches(mp: pytest.MonkeyPatch) -> None:
    """JAX's python loader path, and rater ``b % R`` for every multi-rater loss."""

    def select(seg, rng):
        if seg.ndim == 3:
            return seg
        idx = jnp.arange(seg.shape[0]) % seg.shape[1]
        return jnp.take_along_axis(seg, idx[:, None, None, None], axis=1)[:, 0]

    mp.setattr(j_native_loader, "native_available", lambda: False)
    mp.setattr(j_losses, "_select_random_rater", select)
    mp.setattr(t_losses, "draw_rater", lambda b, r, g: torch.arange(b) % r)


def start(jcfg):
    """The JAX trainer's initial weights with noise on every leaf: from the
    zero-initialized convs the first steps' gradients are near 0 almost
    everywhere, where AdamW turns float rounding into steps of the learning
    rate (:func:`test_torch_port_train.mark_flat`)."""
    return noisy(jax_init(jcfg))


def run_jax(jcfg, params, masks: bool = False):
    trainer = JTrainer(jcfg)
    train, val, train_eval = j_cli.build_loaders(jcfg)
    state = jax_state(trainer, params)
    ctx = nn.intercept_methods(jax_mask_interceptor) if masks else contextlib.nullcontext()
    with ctx:  # the jitted step and evaluation trace inside it
        trainer.fit(train, val, train_eval_loader=train_eval, resume_state=state)
    return trainer


def run_port(tcfg, params):
    """The port's ``fit`` from the JAX initial weights ``params``; returns the
    trainer and its :func:`track_flat` marks."""
    trainer = TTrainer(tcfg, device="cpu")
    flat = track_flat(trainer)
    trainer.built.module.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, params)))
    train, val, train_eval = t_cli.build_loaders(tcfg)
    trainer.fit(train, val, train_eval_loader=train_eval, resume_state=trainer.fresh_state())
    return trainer, flat


def records(workdir) -> list[dict]:
    return [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]


def assert_same_records(got: list[dict], ref: list[dict]):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, atol=METRIC_TOL, rtol=0, err_msg=k)


def assert_same_checkpoint(got_dir, ref_dir, flat, bound):
    """The port's checkpoint against JAX's: meta, keys, every array."""
    ref, ref_cfg, ref_meta = j_load_checkpoint(ref_dir)
    got, got_cfg, got_meta = load_checkpoint(got_dir)
    assert got_meta == ref_meta
    assert dict(got_cfg.to_dict(), save_dir="") == dict(ref_cfg.to_dict(), save_dir="")
    if "opt_state" in ref:
        ref["opt_state"] = export_torch_checkpoint.adam_state(ref["opt_state"])
    assert sorted(flatten_state(got)) == sorted(flatten_state(ref))
    for key in ("step", "opt_state/count", "swag_state/n_models"):
        node_g, node_r = got, ref
        for part in key.split("/"):
            node_g, node_r = node_g.get(part, {}), node_r.get(part, {})
        assert np.array_equal(np.asarray(node_g), np.asarray(node_r)), key
    trees = [(name, got[name], ref[name]) for name in ("params", "ema_params") if name in ref]
    trees += [(f"opt_state/{m}", got["opt_state"][m], ref["opt_state"][m])
              for m in ("mu", "nu") if "opt_state" in ref]
    trees += [(f"swag_state/{m}", got["swag_state"][m], ref["swag_state"][m])
              for m in ("mean", "sq_mean") if "swag_state" in ref]
    for name, g, r in trees:
        moments = name.startswith("opt_state")  # linear in the gradients: no marks
        assert_state_close(flax_to_torch(g), flax_to_torch(r), ARRAY_TOL, name,
                           None if moments else flat, bound)


def assert_same_runs(jt, tt, flat, steps: int):
    marked = sum(int(f.sum()) for f in flat.values()) / sum(f.numel() for f in flat.values())
    print(f"elements held to the AdamW bound: {marked:.4%}")
    assert marked < 0.02
    assert_same_records(records(tt.workdir), records(jt.workdir))
    names = sorted(p.name for p in (jt.workdir / "checkpoints").iterdir())
    assert sorted(p.name for p in (tt.workdir / "checkpoints").iterdir()) == names
    for name in names:
        assert_same_checkpoint(tt.workdir / "checkpoints" / name,
                               jt.workdir / "checkpoints" / name, flat, 2 * steps * LR)
    return names


@pytest.fixture(scope="module")
def jax_two_epochs(toy_dir, tmp_path_factory):
    """The JAX trainer's two-epoch run of case (c), shared with the export case."""
    tmp = tmp_path_factory.mktemp("jax_two_epochs")
    with pytest.MonkeyPatch.context() as mp:
        fixed_rater_patches(mp)
        jcfg, _ = configs(toy_dir, tmp, *TWO_EPOCHS)
        params = start(jcfg)
        return run_jax(jcfg, params), params


def test_fit_matches_jax_without_dropout_or_augmentation(toy_dir, tmp_path, monkeypatch,
                                                         jax_two_epochs):
    fixed_rater_patches(monkeypatch)
    jt, init = jax_two_epochs
    _, tcfg = configs(toy_dir, tmp_path, *TWO_EPOCHS)
    assert tcfg.data.augmentations.augment_mult == 0.0 and tcfg.eu_method.name == "none"
    tt, flat = run_port(tcfg, init)
    names = assert_same_runs(jt, tt, flat, steps=4)
    assert names == ["epoch_000001", "last"]
    assert {"val_loss", "val_dice", "val_ged", "train_eval_dice"} <= set(records(tt.workdir)[0])


def test_fit_matches_jax_with_dropout_and_augmentation_injected(toy_dir, tmp_path, monkeypatch):
    fixed_rater_patches(monkeypatch)
    jcfg, tcfg = configs(toy_dir, tmp_path, *TWO_EPOCHS, "data.augmentations.augment_mult=1.0",
                         eu="dropout")
    probe = TTrainer(tcfg, device="cpu", workdir=tmp_path / "probe")
    assert probe.built.needs_dropout_rng and probe.aug_cfg.effective.rotation_limit > 0
    inject_augment_draws(monkeypatch, probe.aug_cfg.effective, 8)
    monkeypatch.setattr(ChannelDropout, "draw_mask", torch_draw_mask)
    params = start(jcfg)
    jt = run_jax(jcfg, params, masks=True)
    tt, flat = run_port(tcfg, params)
    assert_same_runs(jt, tt, flat, steps=4)


def test_swag_diag_collection_matches_jax(toy_dir, tmp_path, monkeypatch):
    fixed_rater_patches(monkeypatch)
    jcfg, tcfg = configs(toy_dir, tmp_path, "trainer.max_epochs=3",
                         "eu_method.swag.max_snapshots=2", eu="swag_diag")
    epochs = {"jax": [], "port": []}
    j_collect, t_collect = JTrainer._maybe_collect_swag, TTrainer._maybe_collect_swag

    def spy(side, fn):
        def collect(self, params, epoch):
            took = fn(self, params, epoch)
            if took:
                epochs[side].append(epoch)
            return took
        return collect

    monkeypatch.setattr(JTrainer, "_maybe_collect_swag", spy("jax", j_collect))
    monkeypatch.setattr(TTrainer, "_maybe_collect_swag", spy("port", t_collect))
    params = start(jcfg)
    jt = run_jax(jcfg, params)
    tt, flat = run_port(tcfg, params)
    assert epochs["port"] == epochs["jax"] == [1, 2]  # start = (3 - 1) - 1 * (2 - 1)
    assert_same_runs(jt, tt, flat, steps=6)
    saved, _, _ = load_checkpoint(tt.workdir / "checkpoints" / "last")
    assert int(saved["swag_state"]["n_models"]) == 2 and "dev" not in saved["swag_state"]


def test_resume_is_the_uninterrupted_run_and_ckpt_path_starts_a_fresh_optimizer(toy_dir,
                                                                                tmp_path):
    live = ["data.augmentations.augment_mult=1.0", "device=cpu"]
    whole = t_cli.main(tokens(toy_dir, tmp_path / "whole", "trainer.max_epochs=2", *live,
                              eu="dropout"))
    first = t_cli.main(tokens(toy_dir, tmp_path / "first", "trainer.max_epochs=1", *live,
                              eu="dropout"))
    resumed = t_cli.main(tokens(
        toy_dir, tmp_path / "resumed", "trainer.max_epochs=2", *live,
        f"resume_from={first.workdir / 'checkpoints' / 'last'}", eu="dropout"))
    assert records(resumed.workdir) == records(whole.workdir)[1:]
    ref, _, ref_meta = load_checkpoint(whole.workdir / "checkpoints" / "last")
    got, _, meta = load_checkpoint(resumed.workdir / "checkpoints" / "last")
    assert meta == ref_meta == {"epoch": 1, "kind": "full"}
    ref_flat, got_flat = flatten_state(ref), flatten_state(got)
    assert list(got_flat) == list(ref_flat)
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)
    assert int(got["opt_state"]["count"]) == int(got["step"]) == 4

    fresh = t_cli.main(tokens(
        toy_dir, tmp_path / "fresh", "trainer.max_epochs=1", *live,
        f"ckpt_path={whole.workdir / 'checkpoints' / 'last'}", eu="dropout"))
    state, _, _ = load_checkpoint(fresh.workdir / "checkpoints" / "last")
    assert int(state["opt_state"]["count"]) == int(state["step"]) == 2
    start = flax_to_torch(ref["params"])
    moved = {k: float((v - start[k]).abs().max())
             for k, v in flax_to_torch(state["params"]).items()}
    assert 0 < max(moved.values()) <= 2 * 2 * LR + 1e-6  # two fresh AdamW steps from `whole`


def test_a_jax_run_exported_and_resumed_in_the_port_equals_jax(toy_dir, tmp_path, monkeypatch,
                                                              jax_two_epochs):
    fixed_rater_patches(monkeypatch)
    jt_two, params = jax_two_epochs
    jcfg, tcfg = configs(toy_dir, tmp_path, *TWO_EPOCHS[1:], "trainer.max_epochs=1")
    jt_one = run_jax(jcfg, params)
    exported = export_torch_checkpoint.export(jt_one.workdir / "checkpoints" / "last",
                                              tmp_path / "exported")
    saved, _, meta = load_checkpoint(exported)
    assert meta["epoch"] == 0 and set(saved["opt_state"]) == {"count", "mu", "nu"}
    _, tcfg = configs(toy_dir, tmp_path, *TWO_EPOCHS)
    trainer = TTrainer(tcfg, device="cpu")
    flat = track_flat(trainer)
    state = trainer.restore_state(saved)
    assert state.step == state.opt_state.count == 2
    train, val, train_eval = t_cli.build_loaders(tcfg)
    trainer.fit(train, val, train_eval_loader=train_eval, resume_state=state, start_epoch=1)
    assert_same_records(records(trainer.workdir), records(jt_two.workdir)[1:])
    assert_same_checkpoint(trainer.workdir / "checkpoints" / "last",
                           jt_two.workdir / "checkpoints" / "last", flat, 2 * 2 * LR)
