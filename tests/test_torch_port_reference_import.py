"""The reference-checkpoint importer, the ``assets/`` npz writer and the
profiling helpers of the port against the JAX package's.

No reference model is importable here, so the reference state dicts are
synthetic: the torch names and layouts come from the JAX ``build_mapping``
of a small ``DiffUnet`` (its flax shapes from ``jax.eval_shape``), each
entry filled with seeded numbers. The port's import must equal
``flax_to_torch`` of the JAX import exactly, and the two models' forwards
must agree to atol 1e-5 / rtol 1e-4 (``tests/test_torch_parity.py:146``)."""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.core import torch_import as j_import
from diffuncertainty_tpu.core.specs import DropoutSpec as JDropoutSpec
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu_torch.core import torch_import as t_import
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.core.specs import DropoutSpec
from diffuncertainty_tpu_torch.models.unet import DiffUnet
from torch_threads import one_torch_thread  # noqa: F401

# two levels, attention at the deeper one; the SSN head; a diffusion net
# (time embedding, emb_layers); dropout inside in_layers (per_block off)
CONFIGS = {
    "attention_ssn": dict(in_channels=3, out_channels=2, model_channels=8,
                          num_res_blocks=(1, 2), num_middle_res_blocks=2,
                          attention_resolutions=(-1,), channel_mult=(1, 2), num_heads=2,
                          ssn=True, ssn_rank=4),
    "diffusion": dict(in_channels=5, out_channels=2, model_channels=8, num_res_blocks=(1, 1),
                      num_middle_res_blocks=1, attention_resolutions=(-1,), channel_mult=(1, 2),
                      num_heads=2, diffusion=True, use_scale_shift_norm=True),
    "dropout_in_layers": dict(in_channels=3, out_channels=2, model_channels=8,
                              num_res_blocks=(1, 1), num_middle_res_blocks=1,
                              attention_resolutions=(), channel_mult=(1, 2), num_heads=2,
                              new_upsample_method=True, one_skip_per_reso=True),
}
DROPOUT = {"dropout_in_layers": dict(enabled=True, probability_values=(0.1,), per_block=False)}


def models(name):
    spec = DROPOUT.get(name, {})
    jm = JDiffUnet(**CONFIGS[name], dropout_spec=JDropoutSpec(**spec))
    tm = DiffUnet(**CONFIGS[name], dropout_spec=DropoutSpec(**spec)).eval()
    return jm, tm


def jax_skeleton(jm, name):
    cfg = CONFIGS[name]
    x = jnp.zeros((1, 16, 16, cfg["in_channels"]))
    args = (x, jnp.zeros((1,))) if cfg.get("diffusion") else (x,)
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))


TORCH_SHAPE = {"_conv2d": lambda s: (s[3], s[2], s[0], s[1]),
               "_conv1d": lambda s: (s[1], s[0], 1),
               "_linear": lambda s: (s[1], s[0]),
               "_ident": lambda s: tuple(s)}


def reference_state(jm, skeleton, seed):
    """A synthetic reference state dict for ``jm``: one seeded tensor per
    entry of the JAX mapping whose flax leaf exists, plus the keys the
    importers leave out (the diffusion process's buffers, dead emb_layers)."""
    rng = np.random.default_rng(seed)
    state = {}
    for torch_key, flax_path, transform in j_import.build_mapping(jm).entries:
        node = skeleton["params"]
        for k in flax_path:
            node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                break
        if node is None:
            continue
        shape = TORCH_SHAPE[transform.__name__](node.shape)
        base = 1.0 if flax_path[-1] == "scale" else 0.0
        state[torch_key] = torch.from_numpy(
            (base + 0.2 * rng.standard_normal(shape)).astype(np.float32))
    state["diffusion_process.betas"] = torch.ones(4)
    if not jm.diffusion:
        state["input_blocks.1.0.emb_layers.1.weight"] = torch.zeros(3, 3)
    return state


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_import_equals_the_jax_import(name):
    jm, tm = models(name)
    skeleton = jax_skeleton(jm, name)
    state = reference_state(jm, skeleton, seed=len(name))
    ref = flax_to_torch(j_import.import_torch_state_dict(
        jm, skeleton, {k: v.numpy() for k, v in state.items()}))
    got = t_import.import_torch_state_dict(tm, state)
    assert set(got) == set(ref) == set(tm.state_dict())
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    # numpy inputs import the same
    again = t_import.import_torch_state_dict(tm, {k: v.numpy() for k, v in state.items()})
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_import_forward_matches_jax_and_unmapped_keys_raise():
    name = "attention_ssn"
    jm, tm = models(name)
    skeleton = jax_skeleton(jm, name)
    state = reference_state(jm, skeleton, seed=3)
    jparams = j_import.import_torch_state_dict(jm, skeleton,
                                               {k: v.numpy() for k, v in state.items()})
    tm.load_state_dict(t_import.import_torch_state_dict(tm, state), strict=True)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for field in ("logits", "ssn_mean", "ssn_cov_diag", "ssn_cov_factor"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-5, rtol=1e-4, err_msg=field)
    bad = dict(state, **{"bogus.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="Unmapped"):
        t_import.import_torch_state_dict(tm, bad)
    missing = {k: v for k, v in state.items() if k != "out.3.weight"}
    with pytest.raises(KeyError, match="out.3.weight"):
        t_import.import_torch_state_dict(tm, missing)
    wrong = dict(state, **{"out.3.bias": torch.zeros(5)})
    with pytest.raises(ValueError, match="Shape mismatch"):
        t_import.import_torch_state_dict(tm, wrong)
    lightning = {f"model.{k}": v for k, v in state.items()}
    lightning.update({f"ema_model.module.{k}": 2 * v for k, v in state.items()})
    lightning["ema_model.module.n_averaged"] = torch.tensor(3)
    for use_ema in (False, True):
        assert (t_import.strip_prefixes(lightning, use_ema).keys()
                == j_import.strip_prefixes(lightning, use_ema).keys())


class DictConfig(dict):
    """Stands in for omegaconf's container in a pickled checkpoint."""


class ListConfig(list):
    pass


def lightning_checkpoint(path, omegaconf_classes: bool):
    """A reference-format ``.ckpt`` as ``tests/test_torch_parity.py:199-245``
    builds it: raw weights under ``model.``, EMA ones (x1.01) under
    ``ema_model.module.``, epoch 7 and the hydra ``hyper_parameters``."""
    name = "attention_ssn"
    jm, _ = models(name)
    state = reference_state(jm, jax_skeleton(jm, name), seed=11)
    state = {k: v for k, v in state.items() if not k.startswith("ssn_")
             and k != "diffusion_process.betas"}
    payload = {"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 7}
    payload["state_dict"].update({f"ema_model.module.{k}": v * 1.01 for k, v in state.items()})
    model = {"IN_CHANNELS": 3, "OUT_CHANNELS": 2, "MODEL_CHANNELS": 8,
             "NUM_RES_BLOCKS": [1, 2], "NUM_MIDDLE_RES_BLOCKS": 2, "CHANNEL_MULT": [1, 2],
             "ATTENTION_RESOLUTIONS": [-1]}
    data = {"name": "lidc64", "num_classes": 2, "ignore_index": -1}
    if omegaconf_classes:
        module = types.ModuleType("omegaconf")
        module.DictConfig, module.ListConfig = DictConfig, ListConfig
        DictConfig.__module__ = ListConfig.__module__ = "omegaconf"
        sys.modules["omegaconf"] = module
        try:
            model = DictConfig({k: ListConfig(v) if isinstance(v, list) else v
                                for k, v in model.items()})
            payload["hyper_parameters"] = DictConfig(
                {"model": DictConfig({"cfg": DictConfig({"MODEL": model})}),
                 "data": DictConfig(data)})
            torch.save(payload, path)
        finally:
            del sys.modules["omegaconf"]
    else:
        payload["hyper_parameters"] = {"model": {"cfg": {"MODEL": model}}, "data": data}
        torch.save(payload, path)
    return path


@pytest.mark.parametrize("omegaconf_classes", [False, True])
def test_convert_equals_the_jax_translation_and_import(tmp_path, omegaconf_classes):
    from diffuncertainty_tpu.models.factory import build_model as j_build
    from diffuncertainty_tpu.tools.import_reference_checkpoint import translate_hparams
    from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.tools.import_reference_checkpoint import (
        convert, load_reference_checkpoint)

    ckpt = lightning_checkpoint(tmp_path / "ref.ckpt", omegaconf_classes)
    payload = load_reference_checkpoint(ckpt)
    hparams = payload["hyper_parameters"]
    assert type(hparams) is not DictConfig and isinstance(hparams, dict)
    assert isinstance(hparams["model"]["cfg"]["MODEL"]["CHANNEL_MULT"], list)
    out = convert(ckpt, tmp_path / "imported")
    state, cfg, meta = load_checkpoint(out)
    plain = {"model": {"cfg": {"MODEL": dict(hparams["model"]["cfg"]["MODEL"])}},
             "data": dict(hparams["data"])}
    ref_cfg = translate_hparams(plain)
    assert cfg.to_dict() == ref_cfg.to_dict()
    assert meta == {"epoch": 7, "kind": "imported"}
    jm = j_build(ref_cfg).module
    skeleton = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    sd = payload["state_dict"]
    for key, prefix in (("params", "model."), ("ema_params", "ema_model.module.")):
        ref = flax_to_torch(j_import.import_torch_state_dict(
            jm, skeleton, {k[len(prefix):]: v.numpy() for k, v in sd.items()
                           if k.startswith(prefix)}))
        got = flax_to_torch(state[key])
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref), key
    # the EMA weights of an ``ema_state_dict`` (a torch AveragedModel's)
    payload = {"state_dict": {k: v for k, v in sd.items() if k.startswith("model.")},
               "ema_state_dict": {f"module.{k[6:]}": v * 2 for k, v in sd.items()
                                  if k.startswith("model.")},
               "hyper_parameters": plain, "epoch": 2}
    payload["ema_state_dict"]["n_averaged"] = torch.tensor(4)
    torch.save(payload, tmp_path / "swa.ckpt")
    state, _, meta = load_checkpoint(convert(tmp_path / "swa.ckpt", tmp_path / "swa", epoch=5))
    assert meta["epoch"] == 5
    raw, ema = flax_to_torch(state["params"]), flax_to_torch(state["ema_params"])
    assert all(torch.equal(ema[k], 2 * raw[k]) for k in raw)


def test_bench_weights_npz_reads_back_in_jax(tmp_path):
    from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load
    from diffuncertainty_tpu_torch.core.params import load_params_npz, torch_to_flax
    from diffuncertainty_tpu_torch.tools.bench_weights import save_params_npz

    name = "attention_ssn"
    _, tm = models(name)
    state = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
             for i, (k, v) in enumerate(tm.state_dict().items())}
    path = save_params_npz(torch_to_flax(state), tmp_path / "w.npz")
    ref = j_load(path)
    assert flax_to_torch(ref).keys() == state.keys()
    assert all(torch.equal(flax_to_torch(ref)[k], state[k]) for k in state)
    with np.load(path) as got:
        assert all(k.startswith("params/") for k in got.files)
        assert {got[k].dtype for k in got.files} == {np.dtype(np.float32)}
    # float16 storage, promoted back to float32 by both readers
    half = save_params_npz(torch_to_flax(state), tmp_path / "h.npz", dtype="float16")
    a, b = load_params_npz(half), j_load(half)
    flat = jax.tree_util.tree_leaves_with_path(b)
    assert flat and all(np.asarray(leaf).dtype == np.float32 for _, leaf in flat)
    assert all(torch.equal(flax_to_torch(a)[k], flax_to_torch(b)[k]) for k in state)


@pytest.mark.parametrize("model,dtype", [("softmax", np.float32), ("ssn", np.float16)])
def test_train_recipe_save_npz_writes_a_checkpoints_ema_weights(tmp_path, model, dtype):
    """``train_recipe --save-npz``'s writer on a port checkpoint: the EMA
    weights (not the raw ones), stored at the family's dtype of the JAX tool,
    read back by JAX's ``load_params_npz``."""
    from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load
    from diffuncertainty_tpu_torch.core.checkpoint import save_checkpoint
    from diffuncertainty_tpu_torch.core.config import ExperimentConfig
    from diffuncertainty_tpu_torch.core.params import torch_to_flax
    from diffuncertainty_tpu_torch.tools.train_recipe import save_ema_npz

    _, tm = models("attention_ssn")
    ema = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
           for i, (k, v) in enumerate(tm.state_dict().items())}
    raw = {k: v + 1 for k, v in ema.items()}
    ckpt = save_checkpoint(tmp_path / "last", {"params": torch_to_flax(raw),
                                               "ema_params": torch_to_flax(ema)},
                           ExperimentConfig(), epoch=3)
    path = save_ema_npz(ckpt, tmp_path / "out" / f"{model}_recipe.npz", model)
    with np.load(path) as got:
        assert {got[k].dtype for k in got.files} == {np.dtype(dtype)}
    back = flax_to_torch(j_load(path))
    assert back.keys() == ema.keys()
    assert all(torch.equal(back[k], ema[k].to(getattr(torch, np.dtype(dtype).name)).float())
               for k in ema)


def test_assets_key_format_and_dtypes_round_trip(tmp_path):
    """The softmax asset's leaves, read and written again by the port: the
    same keys and dtypes, the same arrays (the attention and head layers,
    every kind of leaf; the whole asset takes seconds to compress)."""
    from pathlib import Path

    from diffuncertainty_tpu_torch.core.params import load_params_npz, torch_to_flax
    from diffuncertainty_tpu_torch.tools.bench_weights import save_params_npz

    asset = Path(__file__).resolve().parent.parent / "assets" / "bench_unet16_toy128.npz"
    state = {k: v for k, v in flax_to_torch(load_params_npz(asset)).items()
             if k.startswith(("dec0_attn.", "out_", "input_conv."))}
    path = save_params_npz(torch_to_flax(state), tmp_path / "again.npz")
    with np.load(asset) as ref, np.load(path) as got:
        assert len(got.files) == len(state) == 12
        assert all(got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
                   for k in got.files)


def test_profiling_trace_and_phase_timer(tmp_path):
    from diffuncertainty_tpu_torch.utils.profiling import phase_timer, trace_to

    with trace_to(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    timers = phase_timer()
    for _ in range(3):
        with timers("data"):
            sum(range(1000))
    with timers("step"):
        torch.ones(8).sum()
    summary = timers.summary()
    assert summary["data"]["count"] == 3 and summary["step"]["count"] == 1
    assert all(v["total_s"] >= 0 for v in summary.values())
    timers.dump(tmp_path / "timers.json")
    assert "data" in (tmp_path / "timers.json").read_text()
    assert dataclasses.is_dataclass(DropoutSpec)
