"""Port parity of the checkpoint format, the exporter, the config dict and the
job's member expansion from checkpoints.

- ``export_torch_checkpoint.py`` turns a JAX (orbax) checkpoint into the
  port's: the port's ``load_checkpoint`` returns every array of the JAX
  ``load_checkpoint`` exactly, at its dtype, the same config and meta, and
  no ``opt_state``;
- the config dict round-trips both ways, ``load_config`` composes what the
  JAX ``load_config`` composes from its YAML files, ``auto_exp_name`` equals
  JAX's, and each network option round-trips and builds the JAX network;
- the job on (c) a SWAG-diag checkpoint (members drawn by the port from
  JAX's own normals), (d) a two-checkpoint deep ensemble and (e) two mixes
  of checkpoints, run through the JAX job and the port's on the same split,
  compared as in ``test_torch_port_infer`` (JSON and TIFFs to atol 1e-5,
  PNGs decoded equal, the same files), with the same ``SamplerMeta``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import export_torch_checkpoint
from diffuncertainty_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint
from diffuncertainty_tpu.core.checkpoint import save_checkpoint as j_save_checkpoint
from diffuncertainty_tpu.core.config import ExperimentConfig as JExperimentConfig
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.models import ssn as j_ssn
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu_torch.core import checkpoint as t_checkpoint
from diffuncertainty_tpu_torch.core.config import ExperimentConfig, load_config
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.models import ssn as t_ssn
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models import swag as t_swag
from test_torch_port_infer import (BATCH, HW, assert_same_tree, checkpoint_pair, j_config,
                                   random_variables, run_jax, run_port, toy_dir)  # noqa: F401
from test_torch_port_infer import inject_draws  # noqa: F401
from test_torch_port_ssn import jax_ssn_eps
from torch_threads import one_torch_thread  # noqa: F401

GROUPS = [  # (data, network, model, eu_method, precision)
    ("lidc128", "unet16", "softmax", "dropout", "bf16"),
    ("lidc128", "unet16", "diffusion", "none", "fp32"),
    ("lidc128", "unet16", "ssn", "swag", "fp32"),
    ("lidc128", "unet16", "prob_unet", "swag_diag", "bf16"),
    ("lidc128", "hrnet-s", "softmax", "ensemble", "fp32"),
    ("gta_toy", "hrnet-m", "ssn", "none", "bf16"),
    ("gta_toy", "unet16", "softmax", "dropout", "fp32"),
    ("lidc128", "unet4", "softmax", "dropout", "bf16"),
    ("lidc128", "unet64", "diffusion", "none", "fp32"),
    ("lidc64", "unet256", "ssn", "swag_diag", "bf16"),
]


@pytest.mark.parametrize("groups", GROUPS, ids=lambda g: "-".join(g))
def test_config_dict_round_trips_both_ways_and_load_config_equals_jax(groups):
    *names, precision = groups
    ref = j_load_config(*names, overrides=[f"trainer.precision={precision}"])
    got = load_config(*names, precision=precision)
    assert got.to_dict() == ref.to_dict()  # every field of every group, as the YAML composes it
    assert got.auto_exp_name == ref.auto_exp_name
    # JAX dict -> port -> dict, and port dict -> JAX -> dict, through JSON
    assert ExperimentConfig.from_dict(json.loads(json.dumps(ref.to_dict()))).to_dict() \
        == ref.to_dict()
    assert JExperimentConfig.from_dict(json.loads(json.dumps(got.to_dict()))).to_dict() \
        == got.to_dict()
    named = dataclasses.replace(got, exp_name="study_a")
    assert named.auto_exp_name == dataclasses.replace(ref, exp_name="study_a").auto_exp_name
    with pytest.raises(KeyError, match="not_a_key"):
        ExperimentConfig.from_dict({"trainer": {"not_a_key": 1}})


@pytest.mark.parametrize("override,option", [
    ("network.new_upsample_method=true", "new_upsample_method"),
    ("network.one_skip_per_reso=true", "one_skip_per_reso"),
    ("network.mlp_attn=true", "mlp_attn"),
    ("network.act=relu", "act"),
    ("network.final_act=tanh", "final_act"),
    ("network.num_heads_upsample=2", "num_heads_upsample")])
def test_an_unported_network_option_raises_and_is_never_dropped(override, option, tmp_path):
    """Each of the six network options that raised before they were ported
    round-trips through ``from_dict``, ``to_dict`` and a checkpoint, and
    builds the JAX network: the same logits on the same variables
    (``one_skip_per_reso`` with ``new_upsample_method``, which it needs on
    both sides)."""
    from test_torch_port_unet_options import forward_pair

    ref = j_load_config("lidc128", "unet16", "softmax", "none", overrides=[override])
    got = ExperimentConfig.from_dict(ref.to_dict())
    assert got.to_dict() == ref.to_dict() and getattr(got.network, option) == getattr(
        ref.network, option) != getattr(ExperimentConfig().network, option)
    assert JExperimentConfig.from_dict(json.loads(json.dumps(got.to_dict()))).to_dict() \
        == ref.to_dict()
    t_checkpoint.save_checkpoint(tmp_path / "c", {"params": {"w": np.zeros(2, np.float32)}},
                                 ref.to_dict(), epoch=0)
    assert t_checkpoint.load_checkpoint(tmp_path / "c")[1] == got
    small = ["network.model_channels=16", "network.num_res_blocks=[1,1]",
             "network.channel_mult=[1,2]", "network.attention_resolutions=[-1]"]
    if option == "one_skip_per_reso":
        small.append("network.new_upsample_method=true")
    jb = j_build_model(j_load_config("lidc128", "unet16", "softmax", "none",
                                     overrides=[override] + small))
    tb = build_model(load_config("lidc128", "unet16", "softmax", "none",
                                 overrides=[override] + small), device="cpu")
    x = np.random.default_rng(9).standard_normal((2, 16, 16, 3)).astype(np.float32)
    logits, ref_logits = forward_pair(jb.module, tb.module, x)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-5, rtol=1e-4)


def full_state(cfg, seed: int = 0):
    """A JAX trainer's full state: params, EMA, a SWAG state (moments of 5
    snapshots, a deviation ring of 4 slots), the step and an optimizer
    state."""
    params = random_variables(cfg, seed)
    rng = np.random.default_rng(seed + 1)

    def noise(a, scale=0.01, lead=()):
        return (scale * rng.standard_normal(lead + a.shape)).astype(np.float32)

    mean = jax.tree.map(lambda a: a + noise(a), params)
    return {"params": params, "ema_params": random_variables(cfg, seed + 2),
            "swag_state": {"n_models": np.asarray(5, np.int32), "mean": mean,
                           # variances of at least 1e-4: far above the float32
                           # rounding of sq_mean - mean^2, which XLA may fuse
                           "sq_mean": jax.tree.map(
                               lambda m: m * m + (0.01 + np.abs(noise(m))) ** 2, mean),
                           "dev": jax.tree.map(lambda a: noise(a, lead=(4,)), params)},
            "step": jnp.asarray(17, jnp.int32),
            "opt_state": {"mu": jax.tree.map(np.zeros_like, params),
                          "count": np.asarray(3, np.int32)}}


def test_export_gives_the_jax_arrays_exactly(toy_dir, tmp_path, capsys):
    cfg = j_config(toy_dir, eu="swag")
    src = tmp_path / "jax" / "last"
    j_save_checkpoint(src, full_state(cfg), cfg, epoch=7, kind="full")
    dst = tmp_path / "port" / "last"
    export_torch_checkpoint.main([str(src), str(dst)])
    assert "left out opt_state" in capsys.readouterr().out
    assert t_checkpoint.is_checkpoint_dir(dst) and not t_checkpoint.is_checkpoint_dir(src)
    ref_state, ref_cfg, ref_meta = j_load_checkpoint(src)
    state, got_cfg, meta = t_checkpoint.load_checkpoint(dst)
    assert meta == ref_meta == {"epoch": 7, "kind": "full"}
    assert got_cfg.to_dict() == ref_cfg.to_dict() == cfg.to_dict()
    assert (dst / "config.json").read_text() == (src / "config.json").read_text()
    ref_flat = t_checkpoint.flatten_state({k: v for k, v in ref_state.items()
                                           if k != "opt_state"})
    flat = t_checkpoint.flatten_state(state)
    assert list(flat) == list(ref_flat) and len(flat) > 100
    assert set(state) == {"params", "ema_params", "swag_state", "step"}
    for k, ref in ref_flat.items():
        assert flat[k].dtype == ref.dtype and flat[k].shape == ref.shape, k
        np.testing.assert_array_equal(flat[k], ref, err_msg=k)
    assert flat["swag_state/n_models"].dtype == np.int32 and int(flat["swag_state/n_models"]) == 5
    assert state["swag_state"]["dev"]["params"]["out_conv"]["kernel"].shape[0] == 4
    # the port's own save/load is exact too, and replaces what was there
    again = t_checkpoint.save_checkpoint(tmp_path / "port" / "last", state, got_cfg, epoch=8)
    state2, cfg2, meta2 = t_checkpoint.load_checkpoint(again)
    assert meta2["epoch"] == 8 and cfg2 == got_cfg
    for k, v in t_checkpoint.flatten_state(state2).items():
        np.testing.assert_array_equal(v, flat[k])
    with pytest.raises(FileNotFoundError, match="export_torch_checkpoint"):
        t_checkpoint.load_checkpoint(src)
    assert t_checkpoint.checkpoint_epoch_tag(8, True) == "e8_ema"


def swag_normals(state: dict, cfg, seed: int, n_members: int, order: list) -> list:
    """The normals JAX ``swag.sample_members(state, key(seed), n)`` draws
    (diag only: eps per leaf), member after member, in the port's key order."""
    leaves, treedef = jax.tree.flatten(state["mean"])

    @jax.jit
    def member_eps(key):
        k_diag, _ = jax.random.split(key)
        return [jax.random.normal(k, leaf.shape, jnp.float32)
                for k, leaf in zip(jax.random.split(k_diag, len(leaves)), leaves)]

    out = []
    for key in jax.random.split(jax.random.key(seed), n_members):
        eps = [np.asarray(e) for e in member_eps(key)]
        by_key = flax_to_torch(jax.tree.unflatten(treedef, eps))
        out.extend(by_key[k] for k in order)
    return out


def test_c_swag_diag_members_from_jax_normals(toy_dir, tmp_path, monkeypatch, inject_draws):
    cfg = j_config(toy_dir, eu="swag_diag", extra=["eu_method.swag.max_snapshots=4"])
    state = full_state(cfg, seed=3)
    state["swag_state"].pop("dev")
    src, dst = checkpoint_pair(tmp_path / "ckpt", "v0", cfg, state)
    kw = dict(n_pred=2, n_models=3, tta=True, seed=21)
    j_dir = run_jax([src], tmp_path / "jax", **kw)
    port_state = t_checkpoint.load_checkpoint(dst)[0]["swag_state"]
    order = list(flax_to_torch(port_state["mean"]))
    queue = swag_normals(port_state, cfg, 21, 3, order)

    def draw(shape, generator, dtype):
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape)
        return out

    monkeypatch.setattr(t_swag, "draw_normal", draw)
    t_dir, inf = run_port([dst], tmp_path / "port", **kw)
    assert not queue
    assert inf.spec.member_mode == "params_stack" and inf.meta == (3, 2, (False,) * 3)
    assert_same_tree(j_dir, t_dir)


def test_d_two_checkpoints_stack_into_a_deep_ensemble(toy_dir, tmp_path):
    cfg = j_config(toy_dir, eu="ensemble")
    pairs = [checkpoint_pair(tmp_path / "ckpt", f"s{i}", cfg,
                             {"params": random_variables(cfg, 10 + i)}) for i in range(2)]
    kw = dict(n_pred=1, seed=4)
    j_dir = run_jax([p[0] for p in pairs], tmp_path / "jax", **kw)
    t_dir, inf = run_port([p[1] for p in pairs], tmp_path / "port", **kw)
    assert len(inf.sources) == 1 and inf.spec.member_mode == "params_stack"
    assert inf.meta == (2, 1, (False, False))
    assert_same_tree(j_dir, t_dir)


@pytest.mark.parametrize("mix", ["dropout+plain", "softmax_tta+ssn"])
def test_e_a_heterogeneous_mix_runs_one_sampler_per_checkpoint(toy_dir, tmp_path, monkeypatch,
                                                               inject_draws, mix):
    if mix == "dropout+plain":  # singleton groups: 3 dropout members and one plain
        cfgs = [j_config(toy_dir, eu="dropout"), j_config(toy_dir, eu="none")]
        kw = dict(n_pred=1, n_models=3, seed=8)
        meta = (4, 1, (False,) * 4)
    else:  # every member draws n_pred samples: each keeps its group
        cfgs = [j_config(toy_dir, eu="none"), j_config(toy_dir, model="ssn", eu="none")]
        kw = dict(n_pred=2, tta=True, seed=8)
        meta = (2, 2, (False, True))
        key = jax.random.key(31)
        orig = j_ssn.sample_n
        monkeypatch.setattr(j_ssn, "sample_n", lambda dist, rng, s: orig(dist, key, s))
        rank = cfgs[1].model.ssn_rank
        eps_r, eps_n = jax_ssn_eps(key, 2, BATCH, rank, HW * HW * 2)
        monkeypatch.setattr(t_ssn, "draw_normal", lambda shape, gen, dtype: torch.from_numpy(
            eps_r if shape[-1] == rank else eps_n))
    pairs = [checkpoint_pair(tmp_path / "ckpt", f"m{i}", c, {"params": random_variables(c, i)})
             for i, c in enumerate(cfgs)]
    j_dir = run_jax([p[0] for p in pairs], tmp_path / "jax", intercept=True, **kw)
    t_dir, inf = run_port([p[1] for p in pairs], tmp_path / "port", **kw)
    assert len(inf.sources) == 2 and inf.meta == meta
    assert_same_tree(j_dir, t_dir)
    if mix != "dropout+plain":
        likelihood = json.loads((t_dir / "likelihood.json").read_text())
        assert all("gen_NLL" in r for r in likelihood.values())
