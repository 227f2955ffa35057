"""Port parity of the multiclass full-frame family: the gta-toy generator,
the label-switch references and the analytic switch map, the sliding-window
stitch, multiclass Dice, GED and NCC, and the whole ``gta_toy_quality_eval``
at the JAX test's small size (tests/test_multiclass_quality.py: unet4 with
SMALL_NET, 2 frames 64x96, window 32, stride 16, 2 members).

Dropout masks are injected per member on both sides. The JAX members run
under ``lax.map``, whose body is traced once; the test replaces
``jax.lax.map`` with the equivalent Python loop over the member keys, so
each member is traced on its own, and an interceptor on ``ChannelDropout``
gives the n-th call at a site the n-th member's mask. The port's members
run one after another, and a replacement of ``ChannelDropout.draw_mask``
does the same by call count. The JAX eval rounds its results to 4 decimals;
the test compares the unrounded values (``round`` shadowed in that module).
"""

import dataclasses
import filecmp
import zlib
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.tools.multiclass_quality as j_mcq
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.data import augment_extra as j_aug
from diffuncertainty_tpu.data import cityscapes_labels as j_cs
from diffuncertainty_tpu.data.dataset import MultiRaterDataset as JDataset
from diffuncertainty_tpu.data.dataset import infer_num_raters as j_infer_num_raters
from diffuncertainty_tpu.data.gta_toy import generate_gta_toy as j_generate
from diffuncertainty_tpu.evaln.tasks import compute_ncc as j_ncc
from diffuncertainty_tpu.infer import sliding_window as j_sw
from diffuncertainty_tpu.metrics.dice import dice_multiclass_macro as j_dice
from diffuncertainty_tpu.metrics.ged import ged_multiclass as j_ged
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.unet import ChannelDropout as JChannelDropout
from diffuncertainty_tpu_torch.core.config import load_config
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.data import augment_extra, cityscapes_labels as cs
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset, infer_num_raters
from diffuncertainty_tpu_torch.data.gta_toy import generate_gta_toy
from diffuncertainty_tpu_torch.evaln.tasks import compute_ncc
from diffuncertainty_tpu_torch.infer import sliding_window as t_sw
from diffuncertainty_tpu_torch.metrics.dice import dice_multiclass_macro
from diffuncertainty_tpu_torch.metrics.ged import ged_multiclass
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.unet import ChannelDropout
from diffuncertainty_tpu_torch.tools.multiclass_quality import gta_toy_quality_eval
from torch_threads import one_torch_thread  # noqa: F401

SMALL_NET = dict(model_channels=8, num_res_blocks=(1, 1), channel_mult=(1, 2),
                 attention_resolutions=(-1,))
TOY = dict(num_train=3, num_val=2, num_test=2, train_size=(32, 32), test_size=(48, 64), seed=0)


def _files(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_gta_toy_files_are_byte_equal_to_jax(tmp_path):
    ref = j_generate(tmp_path / "jax", **TOY)
    got = generate_gta_toy(tmp_path / "port", **TOY)
    names = _files(ref)
    assert names == _files(got) and len(names) == 2 + 2 * 7
    for name in names:
        assert filecmp.cmp(ref / name, got / name, shallow=False), name
    assert generate_gta_toy(tmp_path / "port", **TOY) == got  # manifest short-circuit

    splits = "splits/default/firstCycle/splits.pkl"
    for split in ("train", "id"):
        jds, tds = JDataset(ref / splits, ref, split=split), MultiRaterDataset(got / splits, got,
                                                                               split=split)
        assert tds.num_raters == jds.num_raters == 1 and len(tds) == len(jds)
        for i in range(len(tds)):
            a, b = jds.load(i), tds.load(i)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["seg"], b["seg"])
    for name in ("lidc128", "gta_toy", "riga", "LIDC-IDRI", "toy128", "none"):
        assert infer_num_raters(name) == j_infer_num_raters(name)


def test_label_constants_switches_and_switch_map_match_jax():
    for name in ("LABELS", "name2trainId", "trainId2color", "color2trainId", "NUM_TRAIN_CLASSES",
                 "LABEL_SWITCH_PROBS", "GT_SWITCH_PROBS", "SWITCHABLE"):
        assert getattr(cs, name) == getattr(j_cs, name), name
    assert cs.palette() == j_cs.palette()
    mask = generate_toy_mask()
    for n_ref, probs in ((1, None), (4, cs.GT_SWITCH_PROBS), (3, {"road": 0.9, "car": 0.5})):
        for seed in range(3):
            ref = j_aug.stochastic_label_switches(mask, np.random.default_rng(seed), n_ref, probs)
            got = augment_extra.stochastic_label_switches(mask, np.random.default_rng(seed),
                                                          n_ref, probs)
            np.testing.assert_array_equal(got, ref)
    assert (got != mask).any()  # switches happened
    np.testing.assert_array_equal(cs.gt_switch_uncertainty_map(mask),
                                  j_cs.gt_switch_uncertainty_map(mask))
    np.testing.assert_array_equal(cs.gt_switch_uncertainty_map(mask, {"sky": 0.25}),
                                  j_cs.gt_switch_uncertainty_map(mask, {"sky": 0.25}))


def generate_toy_mask(h: int = 40, w: int = 56) -> np.ndarray:
    from diffuncertainty_tpu_torch.data.gta_toy import _scene

    return _scene(np.random.default_rng(5), h, w)


@pytest.mark.parametrize("size,window,stride", [((48, 70), 32, 12), ((40, 40), 16, None),
                                                ((32, 50), 32, 16)])
def test_sliding_window_matches_jax_on_a_stride_that_does_not_divide(size, window, stride):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2,) + size + (3,)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)

    def j_apply(tiles):  # position-dependent: a window's tiles must land in place
        return jnp.tanh(tiles @ w + jnp.cumsum(tiles[..., :1], axis=1))

    def t_apply(tiles):
        return torch.tanh(tiles @ torch.from_numpy(w) + torch.cumsum(tiles[..., :1], dim=1))

    for n in (size[0], size[1]):
        assert t_sw._window_offsets(n, window, stride or window // 2) == j_sw._window_offsets(
            n, window, stride or window // 2)
    np.testing.assert_array_equal(t_sw._tent(window), j_sw._tent(window))
    ref = j_sw.sliding_window_predict(j_apply, jnp.asarray(images), window=window, stride=stride)
    got = t_sw.sliding_window_predict(t_apply, torch.from_numpy(images), window=window,
                                      stride=stride)
    assert got.shape == (2,) + size + (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # a constant field stitches to itself
    const = t_sw.sliding_window_predict(lambda t: torch.full(t.shape[:3] + (2,), 0.3),
                                        torch.from_numpy(images), window=window, stride=stride)
    np.testing.assert_allclose(const.numpy(), 0.3, atol=1e-6)


@pytest.mark.parametrize("ignore_index", [None, -1, 0, 255])
def test_multiclass_dice_ged_and_ncc_match_jax(ignore_index):
    rng = np.random.default_rng(1 if ignore_index is None else ignore_index + 10)
    c, p, g, h, w = 5, 3, 4, 24, 20
    labels = rng.integers(0, c, (g, h, w))
    labels[:, :3] = -1  # out of range, and the ignore label where it is -1
    labels[:, -2:] = 255
    labels[1:, 5:8] = labels[0, 5:8]
    probs = rng.dirichlet(np.ones(c), (p, h, w)).astype(np.float32)
    pred = probs.mean(0).argmax(-1)
    for include_background in (False, True):
        for r in labels:
            ref = j_dice(jnp.asarray(pred), jnp.asarray(r), c, ignore_index=ignore_index,
                         include_background=include_background)
            got = dice_multiclass_macro(torch.from_numpy(pred), torch.from_numpy(r), c,
                                        ignore_index=ignore_index,
                                        include_background=include_background)
            assert abs(float(got) - float(ref)) <= 1e-6
        batched = dice_multiclass_macro(torch.from_numpy(pred).expand(g, h, w),
                                        torch.from_numpy(labels), c, ignore_index=ignore_index,
                                        include_background=include_background)
        assert batched.shape == (g,)
    assert float(dice_multiclass_macro(torch.zeros(4, 4, dtype=torch.long),
                                       torch.zeros(4, 4, dtype=torch.long), 3)) == 1.0
    for n_p, stack in ((p, probs), (1, probs[:1])):
        for n_g in (g, 1):
            ref = j_ged(jnp.asarray(stack), jnp.asarray(labels[:n_g]), c,
                        ignore_index=ignore_index)
            got = ged_multiclass(torch.from_numpy(stack), torch.from_numpy(labels[:n_g]), c,
                                 ignore_index=ignore_index)
            assert set(got) == set(ref)
            for k in ref:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6,
                                           err_msg=f"{k} P={n_p} G={n_g}")
    a, b = rng.random((h, w)).astype(np.float32), rng.random((h, w)).astype(np.float32)
    for x, y in ((a, b), (a, a + 0.1 * b), (np.zeros_like(a), b)):
        assert abs(compute_ncc(x, y) - j_ncc(x, y)) <= 1e-7


def mask_for(path: str, member: int, shape, rate: float) -> np.ndarray:
    seed = zlib.crc32(f"{path}#{member}".encode())
    return np.random.default_rng(seed).random(shape) >= rate


def test_gta_toy_quality_eval_matches_jax_with_injected_member_masks(tmp_path, monkeypatch):
    members, rate = 2, 0.2
    j_cfg = j_load_config(data="gta_toy", network="unet4", model="softmax", eu_method="dropout",
                          overrides=["network.model_channels=8", "network.num_res_blocks=[1,1]",
                                     "network.channel_mult=[1,2]",
                                     "network.attention_resolutions=[-1]"])
    jb = j_build_model(j_cfg)
    shapes = jax.eval_shape(jb.module.init, {"params": jax.random.key(0),
                                             "dropout": jax.random.key(1)},
                            jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
                          shapes)

    cfg = load_config(data="gta_toy", network="unet16", model="softmax", eu_method="dropout")
    cfg = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network, **SMALL_NET))
    tb = build_model(cfg, device="cpu")
    tb.module.load_state_dict(flax_to_torch(params), strict=True)
    assert tb.num_classes == jb.num_classes == 24

    j_calls, t_calls = {}, {}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, JChannelDropout) and context.method_name == "__call__" and mod.rate > 0:
            x, path = args[0], "/".join(mod.path)
            member = j_calls[path] = j_calls.get(path, -1) + 1
            m = mask_for(path, member, (x.shape[0], x.shape[-1]), mod.rate)
            m = jnp.asarray(m.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)))
            return jnp.where(m, x / (1.0 - mod.rate), 0.0).astype(x.dtype)
        return next_fun(*args, **kwargs)

    def member_loop(f, xs, batch_size=None):  # lax.map as a loop: one trace per member
        return jnp.stack([f(xs[i]) for i in range(xs.shape[0])])

    def t_draw(self, shape, generator, device):
        path = self.path.replace(".", "/")
        member = t_calls[path] = t_calls.get(path, -1) + 1
        return torch.from_numpy(mask_for(path, member, shape, self.rate)).to(device)

    monkeypatch.setattr(jax.lax, "map", member_loop)
    monkeypatch.setattr(j_mcq, "round", lambda x, ndigits=None: x, raising=False)
    monkeypatch.setattr(ChannelDropout, "draw_mask", t_draw)
    kw = dict(frames=2, frame_size=(64, 96), window=32, stride=16, members=members,
              n_references=3, timing_reps=1)
    with nn.intercept_methods(interceptor):
        ref = j_mcq.gta_toy_quality_eval(jb, params, j_cfg.data,
                                         data_dir=str(tmp_path / "jax"), **kw)
    got = gta_toy_quality_eval(tb, cfg.data, data_dir=tmp_path / "port", device="cpu", **kw)
    assert set(j_calls) == set(t_calls) and len(j_calls) > 1
    assert set(j_calls.values()) == {members - 1}  # every site traced once per member
    assert set(t_calls.values()) == {2 * members - 1}  # the stack's call, then the timed one
    assert ref["palette_png_roundtrip"] is True
    assert got["palette_png_roundtrip"] is True  # the port's ResultsWriter and PNG reader
    for k in ("dice_macro", "ged_multiclass", "ncc_tu_vs_analytic", "ncc_au_vs_analytic"):
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    for k in ("frame_size", "window", "stride", "members", "n_references"):
        assert got[k] == ref[k], k
    assert got["frames_per_sec"] > 0
    assert 0.0 < got["dice_macro"] < 1.0 and got["ged_multiclass"] > 0.0
