"""Port parity of the trainer's parts (``diffuncertainty_tpu_torch/train``,
``data/augment.py``, ``data/loader.py``, ``models/unet.py::flax_init_``,
``train/cli.py``) against the JAX package on the same numpy inputs.

The net is the small one of ``tests/test_train.py`` (model channels 8, one
res block per level, two levels, attention at the bottom) on unet16's config
group at 32x32, float32 on both sides; the JAX weights are carried across
with ``flax_to_torch``. Cases:

- (a) the loss and every gradient leaf of one batch, to atol 1e-5 / rtol
  1e-4 (the full-model tolerance of ``tests/test_torch_parity.py:146``):
  masked cross entropy, soft Dice + cross entropy (``ignore_index=0``), and
  a multi-rater target with JAX's rater draw handed to the port;
- (b) three optimizer steps (clip active with a linear schedule and weight
  decay, clip inactive with a cosine schedule; no schedule in the ``fit``
  cases): parameters, Adam moments, EMA, count and each step's
  ``grad_norm`` to 1e-5;
- (g) the loader's order and raters equal to JAX ``BatchLoader(use_native=
  False)`` over three epochs, exactly, and ``augment_batch`` equal to JAX's
  with the draws injected (images to 1e-5, masks exactly);
- (h) the flax initializers over a full unet16: the same zero leaves as
  JAX's ``init``, every other leaf's std within 10% of JAX's;
- (i) the command line's ``parse_args`` equal to JAX's;
- (j) a port-trained checkpoint read by the port's inference job on the CPU;
- (k) the street-scene dataset (``data/cityscapes.py``) and its loader equal
  to JAX's, and one multiclass step (24 classes, switched masks) to 1e-5.

Whole runs of ``fit`` are in ``test_torch_port_train_fit.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffuncertainty_tpu.data.augment as j_augment
import diffuncertainty_tpu.train.cli as j_cli
from diffuncertainty_tpu.data.dataset import MultiRaterDataset as JDataset
from diffuncertainty_tpu.data.loader import BatchLoader as JLoader
from diffuncertainty_tpu.data.toy import generate_toy_dataset
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.train.losses import make_loss_fn as j_make_loss_fn
from diffuncertainty_tpu.models import swag as j_swag
from diffuncertainty_tpu.train.loop import Trainer as JTrainer
from diffuncertainty_tpu.train.loop import TrainState as JTrainState
import diffuncertainty_tpu_torch.data.augment as t_augment
import diffuncertainty_tpu_torch.train.cli as t_cli
import diffuncertainty_tpu_torch.train.losses as t_losses
from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
from diffuncertainty_tpu_torch.core.config import load_config as t_load_config
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset as TDataset
from diffuncertainty_tpu_torch.data.loader import BatchLoader as TLoader
from diffuncertainty_tpu_torch.infer import cli as t_infer_cli
from diffuncertainty_tpu_torch.models.factory import build_model as t_build_model
from diffuncertainty_tpu_torch.models.unet import flax_init_
from diffuncertainty_tpu_torch.train.loop import Trainer as TTrainer
from torch_threads import one_torch_thread  # noqa: F401

SMALL_NET = [  # tests/test_train.py:14-22
    "network.model_channels=8",
    "network.num_res_blocks=[1,1]",
    "network.channel_mult=[1,2]",
    "network.attention_resolutions=[-1]",
    "model.diffusion_sampling.num_steps=3",
    "model.n_aleatoric_samples=3",
    "trainer.learning_rate=0.003",
]
ATOL, RTOL = 1e-5, 1e-4  # loss and gradients (tests/test_torch_parity.py:146)
STEP_TOL = 1e-5  # parameters, moments, EMA and grad_norm after the steps


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    return generate_toy_dataset(tmp_path_factory.mktemp("toy"), num_train=16, num_val=6,
                                num_test=6, num_ood=4, size=32, seed=0)


def tokens(toy_dir, save_dir, *extra, eu: str = "none") -> list[str]:
    return ["data=toy64", "network=unet16", "model=softmax", f"eu_method={eu}",
            f"data.data_input_dir={toy_dir}", f"save_dir={save_dir}", "data.batch_size=8",
            "trainer.loggers=[jsonl]", *SMALL_NET, *extra]


def configs(toy_dir, tmp_path, *extra, eu: str = "none"):
    """The same tokens through both command lines (the port's on the CPU)."""
    jcfg, _ = j_cli.parse_args(tokens(toy_dir, tmp_path / "jax", *extra, eu=eu))
    tcfg, special = t_cli.parse_args(tokens(toy_dir, tmp_path / "port", *extra, eu=eu)
                                     + ["device=cpu"])
    assert special["device"] == "cpu"
    return jcfg, tcfg


def jax_init(jcfg) -> dict:
    """The JAX trainer's initial weights, as its ``fit`` draws them
    (``init_state``: the module's ``init`` with ``fold_in(key(seed), 7919)``),
    jitted: the trainer's eager init compiles op by op."""
    key = jax.random.fold_in(jax.random.key(jcfg.seed), 7919)
    variables = jax.jit(j_build_model(jcfg).module.init)({"params": key},
                                                          jnp.zeros((1, 32, 32, 3)))
    return {"params": variables["params"]}


def jax_state(trainer, params):
    """The JAX trainer's ``TrainState`` (and SWAG state) from ``params``, as
    its ``init_state`` builds them: step 0, fresh optax state, EMA a copy."""
    params = jax.tree.map(jnp.asarray, params)
    if trainer.swag_enabled:
        swag = trainer.cfg.eu_method.swag
        trainer.swag_state = j_swag.init(params, swag.max_snapshots, diag_only=swag.diag_only)
    return JTrainState(jnp.zeros((), jnp.int32), params, trainer.tx.init(params),
                       jax.tree.map(jnp.copy, params), {})


def noisy(params, seed: int = 1, scale: float = 0.05):
    """``params`` with noise on every leaf, so that no gradient is zero (the
    zero-initialized convs would stop the gradient to everything before them)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape)
                        .astype(np.float32), params)


def toy_batch(seed: int, b: int = 8, raters: int | None = None, ignore: int | None = None):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 32, 32, 3), dtype=np.float32)
    shape = (b, 32, 32) if raters is None else (b, raters, 32, 32)
    seg = (rng.random(shape) < 0.3).astype(np.int32)
    if ignore is not None:
        seg[rng.random(shape) < 0.1] = ignore
    return images, seg


def assert_state_close(got: dict, ref: dict, tol: float, what: str,
                       flat: dict | None = None, bound: float = 0.0):
    """Every leaf to ``tol``, but the elements marked in ``flat``
    (:func:`track_flat`) within ``bound``."""
    assert set(got) == set(ref), what
    for k in ref:
        a = np.asarray(got[k].detach() if torch.is_tensor(got[k]) else got[k])
        b = np.asarray(ref[k])
        f = np.zeros(a.shape, bool) if flat is None else flat[k].numpy()
        np.testing.assert_allclose(a[~f], b[~f], atol=tol, rtol=tol, err_msg=f"{what} {k}")
        assert np.abs(a[f] - b[f]).max(initial=0.0) <= bound, f"{what} {k}"


def mark_flat(flat: dict, state) -> None:
    """Mark the elements whose bias-corrected RMS gradient is above 0 and
    below 1e-6 after this step (an exact 0 moves neither side). Their
    update, ``lr * m / (sqrt(v) + 1e-8)`` (optax's eps), turns the float32 rounding of their gradient (about 1e-9 here; the
    whole gradient of a parameter no output depends on, such as a bias before
    a GroupNorm of one channel per group) into steps of up to ``lr`` that
    differ between any two implementations. Such elements are held to the
    most AdamW can move them, 2 * lr per step."""
    opt = state.opt_state
    for k, v in opt.nu.items():
        rms = torch.sqrt(v / (1 - 0.999 ** opt.count))
        low = (rms > 0) & (rms < 1e-6)
        flat[k] = low if k not in flat else flat[k] | low


def track_flat(trainer) -> dict:
    """:func:`mark_flat` after every step of ``trainer``."""
    flat: dict = {}
    step = trainer.train_step

    def marked(*args, **kwargs):
        state, aux = step(*args, **kwargs)
        mark_flat(flat, state)
        return state, aux

    trainer.train_step = marked
    return flat


# ---- (a) the loss and its gradients ---------------------------------------

@pytest.mark.parametrize("case", ["masked_ce", "dice_ce", "multi_rater"])
def test_loss_and_every_gradient_match_jax(toy_dir, tmp_path, monkeypatch, case):
    ignore = 0 if case == "dice_ce" else -1
    jcfg, tcfg = configs(toy_dir, tmp_path, f"data.ignore_index={ignore}")
    params = noisy(jax_init(jcfg))
    images, seg = toy_batch(3, b=4, raters=4 if case == "multi_rater" else None,
                            ignore=-1 if case == "masked_ce" else None)
    key = jax.random.key(5)
    j_loss = j_make_loss_fn(j_build_model(jcfg), ignore_index=ignore)
    (ref_loss, _), ref_grads = jax.value_and_grad(j_loss, has_aux=True)(
        params, {"image": jnp.asarray(images), "seg": jnp.asarray(seg)}, key, {}, None)
    if case == "multi_rater":  # JAX's draw: randint(fold_in(rng, 1), (B,), 0, R)
        idx = np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (4,), 0, 4))
        assert len(set(idx.tolist())) > 1
        monkeypatch.setattr(t_losses, "draw_rater", lambda b, r, g: torch.from_numpy(idx))

    built = t_build_model(tcfg, device="cpu")
    built.module.load_state_dict(flax_to_torch(params))
    loss, _ = t_losses.make_loss_fn(built, ignore_index=ignore)(
        built.module, {"image": torch.from_numpy(images), "seg": torch.from_numpy(seg)},
        torch.Generator())
    names, leaves = zip(*built.module.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=ATOL, rtol=RTOL)
    ref = flax_to_torch(jax.tree.map(np.asarray, ref_grads))
    assert set(names) == set(ref)
    for name, g in zip(names, grads):
        assert float(ref[name].abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# ---- (b) the optimizer ------------------------------------------------------

def jax_adam(opt_state):
    (adam,) = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


@pytest.mark.parametrize("clip,schedule,decay", [("active", "linear", 0.01),
                                                   ("inactive", "cosine", 0.0)])
def test_three_optimizer_steps_match_optax(toy_dir, tmp_path, clip, schedule, decay):
    jcfg, tcfg = configs(toy_dir, tmp_path, f"trainer.lr_schedule={schedule}",
                         f"trainer.gradient_clip_val={1e-3 if clip == 'active' else 1e6}",
                         f"trainer.weight_decay={decay}", "trainer.lr_schedule_total_steps=5")
    jt = JTrainer(jcfg, workdir=tmp_path / "j")
    params = noisy(jax_init(jcfg))
    state = jax_state(jt, params)
    tt = TTrainer(tcfg, workdir=tmp_path / "t", device="cpu")
    tt.built.module.load_state_dict(flax_to_torch(params))
    tstate = tt.fresh_state()
    flat = track_flat(tt)
    step = jt._get_step(False)
    for i in range(3):
        images, seg = toy_batch(10 + i)
        state, aux = step(state, {"image": jnp.asarray(images), "seg": jnp.asarray(seg)},
                          jax.random.key(i), {})
        tstate, taux = tt.train_step(tstate, {"image": images, "seg": seg}, torch.Generator())
        norm = float(aux["grad_norm"])
        assert (norm > 1e-3) if clip == "active" else (norm < 1e6)
        np.testing.assert_allclose(float(taux["grad_norm"]), norm, atol=STEP_TOL,
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(float(taux["loss"]), float(aux["loss"]), atol=STEP_TOL,
                                   rtol=STEP_TOL)
    adam = jax_adam(state.opt_state)
    assert tstate.step == int(state.step) == tstate.opt_state.count == int(adam.count) == 3
    for what, got, ref in (("mu", tstate.opt_state.mu, adam.mu),
                           ("nu", tstate.opt_state.nu, adam.nu)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what)
    for what, got, ref in (("params", tstate.params, state.params),
                           ("ema", tstate.ema_params, state.ema_params)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what,
                           flat, 2 * 3 * 0.003)


def test_learning_rate_schedules_match_optax(toy_dir, tmp_path):
    for schedule, fn in (("linear", optax.linear_schedule(0.003, 0.0, 7)),
                         ("cosine", optax.cosine_decay_schedule(0.003, 7))):
        _, tcfg = configs(toy_dir, tmp_path, f"trainer.lr_schedule={schedule}",
                          "trainer.lr_schedule_total_steps=7")
        tt = TTrainer(tcfg, workdir=tmp_path / schedule, device="cpu")
        got = [tt.learning_rate(c) for c in range(10)]
        np.testing.assert_allclose(got, [float(fn(c)) for c in range(10)], rtol=1e-6, atol=0)


# ---- (g) the loader and the augmentation ------------------------------------

def splits(toy_dir):
    return toy_dir / "splits" / "default" / "firstCycle" / "splits.pkl"


def assert_same_batches(j_batches, t_batches):
    assert len(j_batches) == len(t_batches) > 0
    for jb, tb in zip(j_batches, t_batches):
        assert jb["image_id"] == tb["image_id"]
        for key in ("image", "seg", "num_raters", "valid"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_loader_order_and_raters_match_the_jax_python_path(toy_dir):
    kw = dict(split="train", return_all_raters=False)
    jl = JLoader(JDataset(splits(toy_dir), toy_dir, **kw), 5, shuffle=True, seed=11,
                 drop_last=True, use_native=False)
    tl = TLoader(TDataset(splits(toy_dir), toy_dir, **kw), 5, shuffle=True, seed=11,
                 drop_last=True)
    assert len(jl) == len(tl) == 3
    seen = []
    for _ in range(3):  # each iteration moves the epoch on
        j_batches, t_batches = list(jl), list(tl)
        assert_same_batches(j_batches, t_batches)
        seen.append([i for b in t_batches for i in b["image_id"]])
    assert seen[0] != seen[1] != seen[2]
    jl.set_epoch(1)
    tl.set_epoch(1)
    assert_same_batches(list(jl), list(tl))
    # every rater, the padded tail, and single_rater's stable pick
    jl = JLoader(JDataset(splits(toy_dir), toy_dir, split="val"), 4, use_native=False)
    tl = TLoader(TDataset(splits(toy_dir), toy_dir, split="val"), 4, drop_last=False)
    assert_same_batches(list(jl), list(tl))
    kw = dict(split="train", return_all_raters=False, single_rater=True)
    jl = JLoader(JDataset(splits(toy_dir), toy_dir, **kw), 8, shuffle=True, use_native=False)
    tl = TLoader(TDataset(splits(toy_dir), toy_dir, **kw), 8, shuffle=True, drop_last=False)
    assert_same_batches(list(jl), list(tl))
    # a process's shard: the strided slice of the shared order, wrap-padded
    for shard in ((0, 2), (1, 2), (2, 3)):
        jl = JLoader(JDataset(splits(toy_dir), toy_dir, split="train"), 3, shuffle=True,
                     drop_last=False, use_native=False, process_shard=shard)
        tl = TLoader(TDataset(splits(toy_dir), toy_dir, split="train"), 3, shuffle=True,
                     drop_last=False, process_shard=shard)
        assert len(jl) == len(tl)
        assert_same_batches(list(jl), list(tl))


class FakeJaxRandom:
    """Stands in for ``jax.random`` inside the JAX ``augment_batch``: the
    same split, and fixed draws in the order the function takes them."""

    def __init__(self, draws: dict):
        self.draws = draws
        self.calls = {"bernoulli": 0, "uniform": 0}
        self.split = jax.random.split

    def _next(self, kind, order):
        i = self.calls[kind] % len(order)
        self.calls[kind] += 1
        return jnp.asarray(self.draws[order[i]])

    def bernoulli(self, key, p, shape):
        return self._next("bernoulli", ("flip", "apply_noise"))

    def uniform(self, key, shape, minval, maxval):
        return self._next("uniform", ("angle", "scale_raw", "noise_var"))

    def normal(self, key, shape, dtype):
        return jnp.asarray(self.draws["noise"], dtype)


def inject_augment_draws(monkeypatch, eff, b: int, hw: int = 32, seed: int = 21):
    """The same augmentation draws on both sides, for every batch: flips and
    noise switches fixed, uniforms mapped onto the effective limits."""
    rng = np.random.default_rng(seed)
    lim, (lo, hi), (nlo, nhi) = eff.rotation_limit, eff.scale_limit, eff.gauss_noise_var_limit
    draws = {
        "flip": np.arange(b) % 2 == 0,
        "angle": (-lim + 2 * lim * rng.random(b)).astype(np.float32),
        "scale_raw": (lo + (hi - lo) * rng.random(b)).astype(np.float32),
        "noise_var": (nlo + (nhi - nlo) * rng.random(b)).astype(np.float32),
        "apply_noise": np.arange(b) % 3 != 0,
        "noise": rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
    }
    monkeypatch.setattr(j_augment, "jax", types.SimpleNamespace(random=FakeJaxRandom(draws)))
    t = {k: torch.from_numpy(v) for k, v in draws.items()}
    monkeypatch.setattr(t_augment, "draw_augment", lambda e, g, images: t_augment.AugmentDraws(
        t["flip"], t["angle"], 1.0 + t["scale_raw"], t["noise_var"], t["apply_noise"],
        t["noise"].to(images.device)))
    return draws


@pytest.mark.parametrize("mult", [1.0, 0.5])
def test_augment_batch_matches_jax_with_the_draws_injected(toy_dir, monkeypatch, mult):
    kw = dict(augment_mult=mult, mean=(0.5,), std=(0.25,), gauss_noise_var_limit=(0.05, 0.1))
    jcfg, tcfg = j_augment.TrainAugmentConfig(**kw), t_augment.TrainAugmentConfig(**kw)
    j_eff = dataclasses.asdict(jcfg.effective)
    assert j_eff.pop("separable_warp") and dataclasses.asdict(tcfg.effective) == j_eff
    inject_augment_draws(monkeypatch, tcfg.effective, 4)
    ds = TDataset(splits(toy_dir), toy_dir, split="train", return_all_raters=False)
    samples = [ds.load(i, np.random.default_rng(i)) for i in range(4)]
    images = np.stack([s["image"] for s in samples])
    masks = np.stack([s["seg"] for s in samples]).astype(np.int32)
    j_images, j_masks = j_augment.augment_batch(jcfg, jax.random.key(0), jnp.asarray(images),
                                                jnp.asarray(masks))
    t_images, t_masks = t_augment.augment_batch(tcfg, torch.Generator(),
                                                torch.from_numpy(images), torch.from_numpy(masks))
    np.testing.assert_allclose(t_images.numpy(), np.asarray(j_images), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(t_masks.numpy(), np.asarray(j_masks))
    assert t_masks.dtype == torch.int32 and (t_masks.numpy() != masks).any()
    for transforms in ({"TRAIN": [{"Rotate": {}}, {"Normalize": {}}]}, {"a": [{"Affine": {}}]}):
        try:
            j_augment.check_geometric_transform_support(transforms)
        except ValueError as exc:
            with pytest.raises(ValueError, match="Affine"):
                t_augment.check_geometric_transform_support(transforms)
            assert "Affine" in str(exc)
        else:
            t_augment.check_geometric_transform_support(transforms)


# ---- (h) the initializers ------------------------------------------------------

def test_flax_init_matches_jax_zero_leaves_and_stds():
    jcfg = j_cli.load_config(data="lidc128", network="unet16", model="softmax", eu_method="none")
    variables = jax.jit(j_build_model(jcfg).module.init)(
        {"params": jax.random.key(0)}, jnp.zeros((1, 8, 8, 3)))
    ref = flax_to_torch(jax.tree.map(np.asarray, variables))
    built = t_build_model(t_load_config(data="lidc128", network="unet16", model="softmax",
                                        eu_method="none"), device="cpu")
    flax_init_(built.module, torch.Generator().manual_seed(0))
    got = built.module.state_dict()
    assert set(got) == set(ref) and len(ref) == 290
    zeros = {k for k, v in ref.items() if not v.any()}
    assert {k for k, v in got.items() if not v.any()} == zeros
    assert {k for k in zeros if k.endswith("weight")} >= {"out_conv.weight",
                                                           "mid0_attn.proj_out.weight",
                                                           "enc0_res.out_conv.weight"}
    for k, r in ref.items():
        if k in zeros:
            continue
        if r.std() == 0:  # GroupNorm scales: ones
            assert torch.equal(got[k], r), k
            continue
        std = 1.0 / np.sqrt(got[k][0].numel())
        assert abs(float(got[k].std()) / float(r.std()) - 1) < 0.1, k
        assert float(got[k].abs().max()) <= 2 * std / 0.87962566 + 1e-6, k


# ---- (i) the command line ------------------------------------------------------

def test_parse_args_matches_jax(monkeypatch):
    argv = ["data=toy64", "network=unet16", "model=softmax", "eu_method=dropout", "seed=2024",
            "data.batch_size=16", "data.augmentations.mean=[0.485,0.456,0.406]",
            "data.augmentations.std=[0.229, 0.224, 0.225]", "trainer.max_epochs=150",
            "trainer.precision=bf16", "trainer.val_every_n_epochs=100",
            "ckpt_save_freq.last_every_n_epochs=100", "trainer.lr_schedule=cosine",
            "ema.track_ema_weights=false", "trainer.learning_rate=0.0001",
            "exp_name=run_a", "resume_from=/ckpt/last"]
    for env in ({}, {"DATASET_LOCATION": "/data", "EXPERIMENT_LOCATION": "/exp",
                     "LSB_JOBID": "4711"}):
        for name in ("DATASET_LOCATION", "EXPERIMENT_LOCATION", "LSB_JOBID"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        for tokens_ in (argv, []):
            jcfg, jspecial = j_cli.parse_args(tokens_)
            tcfg, tspecial = t_cli.parse_args(tokens_)
            assert tcfg.to_dict() == jcfg.to_dict()
            assert tspecial == dict(jspecial, device="cuda")
    assert t_cli.parse_args(["device=cpu"])[1]["device"] == "cpu"
    for bad in (["trainer.max_epochs"], ["data.bogus=1"]):
        with pytest.raises((SystemExit, KeyError)):
            j_cli.parse_args(bad)
        with pytest.raises((SystemExit, KeyError)):
            t_cli.parse_args(bad)
    with pytest.raises(SystemExit) as exc:
        t_cli.parse_args(["--help"])
    assert exc.value.code == 0


def test_the_trainer_refuses_what_is_not_ported_and_a_missing_card(toy_dir, tmp_path):
    """A data-parallel mesh larger than the process group (one rank here)
    and a missing card.
    ``trainer.remat``, ``eu_method.name=subensemble`` and the HRNet train
    now (``test_torch_port_remat.py``, ``test_torch_port_subensemble_train.py``,
    ``test_torch_port_train_hrnet.py``)."""
    tcfg, _ = t_cli.parse_args(tokens(toy_dir, tmp_path, "trainer.mesh_shape=[2,1]")
                               + ["device=cpu"])
    with pytest.raises(ValueError, match="covers every rank"):
        TTrainer(tcfg, device="cpu", workdir=tmp_path / "w")
    if not torch.cuda.is_available():
        tcfg, _ = t_cli.parse_args(tokens(toy_dir, tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            TTrainer(tcfg, workdir=tmp_path / "w")


# ---- (k) the street-scene data and one multiclass step --------------------------

@pytest.fixture(scope="module")
def gta_dir(tmp_path_factory):
    from diffuncertainty_tpu.data.gta_toy import generate_gta_toy

    return generate_gta_toy(tmp_path_factory.mktemp("gta"), num_train=8, num_val=2, num_test=2,
                            train_size=(32, 32), test_size=(32, 64), seed=3)


def test_cityscapes_dataset_loads_like_jax(gta_dir):
    """``data/cityscapes.py``: switched single masks for training (the
    loader's generator), stable switched references for evaluation, the
    shuffled loader's batches: all equal to the JAX dataset's."""
    from diffuncertainty_tpu.data.cityscapes import CityscapesDataset as JCity
    from diffuncertainty_tpu_torch.data.cityscapes import CityscapesDataset as TCity

    sp = gta_dir / "splits" / "default" / "firstCycle" / "splits.pkl"
    for split, all_raters in (("train", False), ("id", True)):
        jd, td = JCity(sp, gta_dir, split=split, return_all_raters=all_raters), TCity(
            sp, gta_dir, split=split, return_all_raters=all_raters)
        assert len(jd) == len(td) > 0 and td.dataset_label == jd.dataset_label == "cityscapes"
        for i in range(len(jd)):
            j, t = jd.load(i, np.random.default_rng(i)), td.load(i, np.random.default_rng(i))
            assert j.keys() == t.keys()
            np.testing.assert_array_equal(t["image"], j["image"])
            np.testing.assert_array_equal(t["seg"], j["seg"])
            assert t["seg"].dtype == np.int32 and t["seg"].ndim == (3 if all_raters else 2)
    refs = TCity(sp, gta_dir, split="id").load(0)["seg"]
    assert refs.shape[0] == 4 and len({r.tobytes() for r in refs}) > 1  # switched references
    jl = JLoader(JCity(sp, gta_dir, return_all_raters=False), 4, shuffle=True, seed=2,
                 use_native=False)
    tl = TLoader(TCity(sp, gta_dir, return_all_raters=False), 4, shuffle=True, seed=2)
    for _ in range(2):
        assert_same_batches(list(jl), list(tl))


def test_one_multiclass_training_step_matches_jax(gta_dir, tmp_path):
    """unet16's small net with 24 classes on a batch of switched gta-toy
    masks (the multiclass recipe's data), one step of the gta_toy config
    (ignore_index -1: masked cross entropy): loss, ``grad_norm``, parameters,
    moments and EMA to 1e-5."""
    from diffuncertainty_tpu_torch.data.cityscapes import CityscapesDataset as TCity

    gta = ["data=gta_toy", f"data.data_input_dir={gta_dir}", "data.batch_size=4"]
    toks = [t for t in tokens(gta_dir, tmp_path) if not t.startswith(("data=", "data."))]
    jcfg, _ = j_cli.parse_args(gta + [t.replace(str(tmp_path), str(tmp_path / "j"))
                                      for t in toks])
    tcfg, _ = t_cli.parse_args(gta + toks + ["device=cpu"])
    assert tcfg.data.num_classes == 24 and tcfg.network.out_channels == 24
    jt = JTrainer(jcfg, workdir=tmp_path / "jw")
    params = noisy(jax_init(jcfg))
    state = jax_state(jt, params)
    tt = TTrainer(tcfg, workdir=tmp_path / "tw", device="cpu")
    tt.built.module.load_state_dict(flax_to_torch(params))
    tstate = tt.fresh_state()
    flat = track_flat(tt)
    sp = gta_dir / "splits" / "default" / "firstCycle" / "splits.pkl"
    batch = next(iter(TLoader(TCity(sp, gta_dir, return_all_raters=False), 4, shuffle=True)))
    assert len(np.unique(batch["seg"])) > 2
    state, aux = jt._get_step(False)(state, {k: jnp.asarray(batch[k]) for k in ("image", "seg")},
                                     jax.random.key(0), {})
    tstate, taux = tt.train_step(tstate, batch, torch.Generator())
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=k)
    adam = jax_adam(state.opt_state)
    for what, got, ref in (("mu", tstate.opt_state.mu, adam.mu),
                           ("nu", tstate.opt_state.nu, adam.nu)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what)
    for what, got, ref in (("params", tstate.params, state.params),
                           ("ema", tstate.ema_params, state.ema_params)):
        assert_state_close(got, flax_to_torch(jax.tree.map(np.asarray, ref)), STEP_TOL, what,
                           flat, 2 * 0.003)


# ---- (j) a port-trained checkpoint in the port's inference job ------------------

def test_a_port_trained_checkpoint_runs_in_the_port_infer_job(toy_dir, tmp_path):
    trainer = t_cli.main(tokens(toy_dir, tmp_path / "train", "trainer.max_epochs=1",
                                eu="dropout") + ["device=cpu"])
    ckpt = trainer.workdir / "checkpoints" / "last"
    state, cfg, meta = load_checkpoint(ckpt)
    assert meta == {"epoch": 0, "kind": "full"} and cfg.eu_method.name == "dropout"
    assert set(state) == {"params", "ema_params", "opt_state", "step"}
    assert int(state["step"]) == int(state["opt_state"]["count"]) == 2
    summaries = t_infer_cli.main([
        "--checkpoint_paths", str(ckpt), "--test_split", "id", "--n_pred", "2",
        "--n_models", "2", "--ema_mode", "both", "--test_batch_size", "4", "--device", "cpu",
        "--metrics_only", "--save_dir", str(tmp_path / "results")])
    assert [s["use_ema"] for s in summaries] == [False, True]
    for s in summaries:
        assert s["n_images"] == 6
        metrics = json.loads((Path(s["out_dir"]) / "metrics.json").read_text())
        dice = [r["metrics"]["dice"] for r in metrics.values()]
        assert len(dice) == 6 and all(0.0 <= d <= 1.0 for d in dice)


def test_chip_smoke_train_bands_come_from_the_jax_members():
    """The train path's bands: each metric's range over the 16 JAX-trained
    members of the recipe, widened by half the range on each side."""
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    import chip_smoke

    record = json.loads(chip_smoke.ENSEMBLE16_QUALITY.read_text())
    assert record["recipe"]["epochs"] == chip_smoke.TRAIN_EPOCHS
    assert record["recipe"]["seeds"][0] == chip_smoke.TRAIN_SEED
    members = record["member_quality"]
    assert len(members) == 16
    for metric, (lo, hi) in chip_smoke.TRAIN_BANDS.items():
        values = [m[metric] for m in members]
        half = (max(values) - min(values)) / 2
        assert abs(lo - (min(values) - half)) <= 5e-5 and abs(hi - (max(values) + half)) <= 5e-5
    tcfg, _ = t_cli.parse_args(chip_smoke.train_tokens("/data", "/saves"))
    assert (tcfg.seed, tcfg.trainer.max_epochs, tcfg.trainer.precision) == (2024, 150, "bf16")
    assert tcfg.data.augmentations.augment_mult == 0.0 and tcfg.eu_method.name == "none"
