"""Port parity of every DiffUnet option, the unet4/64/256 configs, the
bilinear upsample, ``eaurc`` and the combined split schema, against the JAX
package on the same numpy inputs and weights.

Each option builds a narrow DiffUnet (8 channels, 2 levels, attention at
the bottom) on both sides; the port loads the JAX variables (random, with
noise on every leaf: the flax init's zero output convs would hide most of
the network) through ``flax_to_torch`` with ``strict=True``, so the module
tree must be the JAX one, and the logits are held to atol 1e-5 with rtol
1e-4 (the repo's float32 model tolerance). Dropout masks are injected on
both sides where a case has dropout live. The unet4/64/256 configs are
composed by ``load_config`` on both sides and built at reduced depth (one
ResBlock a level) at their full widths.
"""

import dataclasses
import pickle

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.core.specs import DropoutSpec as JDropoutSpec
from diffuncertainty_tpu.data.dataset import MultiRaterDataset as JDataset
from diffuncertainty_tpu.data.loader import BatchLoader as JBatchLoader
from diffuncertainty_tpu.metrics.aurc import eaurc as j_eaurc
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.models.unet import ResBlock as JResBlock
from diffuncertainty_tpu.ops.resample import upsample2x as j_upsample2x
from diffuncertainty_tpu_torch.core.config import ExperimentConfig, load_config
from diffuncertainty_tpu_torch.core.params import flax_to_torch, flax_to_torch_stacked
from diffuncertainty_tpu_torch.core.specs import DropoutSpec
from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset
from diffuncertainty_tpu_torch.data.loader import BatchLoader
from diffuncertainty_tpu_torch.metrics.aurc import eaurc
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.unet import ChannelDropout, DiffUnet, MLPBlock, ResBlock
from diffuncertainty_tpu_torch.ops.resample import upsample2x
from test_torch_port_model import _as_plain, jax_mask_interceptor, torch_draw_mask
from torch_threads import one_torch_thread  # noqa: F401

HW, B = 16, 2
LOGITS_TOL = dict(atol=1e-5, rtol=1e-4)
NARROW = dict(in_channels=3, out_channels=2, model_channels=8, num_res_blocks=(1, 1),
              num_middle_res_blocks=2, attention_resolutions=(-1,), channel_mult=(1, 2),
              num_heads=2)
SKIP_DROPOUT = dict(enabled=True, probability_values=(0.2,), skip_connections=True)
OPTIONS = {  # case -> DiffUnet arguments over NARROW (dropout_spec as a dict)
    "new_upsample_method": dict(new_upsample_method=True),
    "new_upsample_method_3_levels_avgpool": dict(
        new_upsample_method=True, channel_mult=(1, 2, 3), num_res_blocks=(1, 2, 1),
        conv_resample=False),
    "one_skip_per_reso": dict(new_upsample_method=True, one_skip_per_reso=True,
                              channel_mult=(1, 2, 3), num_res_blocks=(2, 1, 1)),
    "one_skip_per_reso_skip_dropout": dict(new_upsample_method=True, one_skip_per_reso=True,
                                           dropout_spec=SKIP_DROPOUT),
    "mlp_attn": dict(mlp_attn=True),
    "mlp_attn_diffusion": dict(mlp_attn=True, diffusion=True, in_channels=5),
    "mlp_attn_diffusion_scale_shift": dict(mlp_attn=True, diffusion=True, in_channels=5,
                                           use_scale_shift_norm=True),
    "act_relu": dict(act="relu"),
    "act_gelu": dict(act="gelu"),
    "act_gelu_diffusion": dict(act="gelu", diffusion=True, in_channels=5),
    "final_act_tanh": dict(final_act="tanh"),
    "final_act_sigmoid": dict(final_act="sigmoid"),
    "num_heads_upsample": dict(num_heads_upsample=1),
    "every_option_at_once": dict(new_upsample_method=True, one_skip_per_reso=True,
                                 mlp_attn=True, act="relu", final_act="tanh",
                                 num_heads_upsample=4, diffusion=True, in_channels=5,
                                 dropout_spec=SKIP_DROPOUT),
}


def random_variables(module, *inputs, seed: int = 0) -> dict:
    """Random flax variables on the shapes of ``module.init``: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(module.init, {"params": jax.random.key(0),
                                          "dropout": jax.random.key(1)}, *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return (1.0 if name == "scale" else 0.0) + np.float32(0.1) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def forward_pair(jm, tm, x, t=None):
    """JAX logits (dropout masks intercepted) and the port's on the same
    variables."""
    args = (jnp.asarray(x),) + (() if t is None else (jnp.asarray(t),))
    variables = random_variables(jm, *args)

    @jax.jit
    def apply(v, *a):
        with nn.intercept_methods(jax_mask_interceptor):
            return jm.apply(v, *a, rngs={"dropout": jax.random.key(2)}).logits

    ref = np.asarray(apply(variables, *args))
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    kw = {} if t is None else {"timesteps": torch.from_numpy(t)}
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.Generator().manual_seed(0), **kw).logits
    return got.numpy(), ref


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_diffunet_option_matches_jax(monkeypatch, case):
    kw = dict(NARROW, **OPTIONS[case])
    spec = kw.pop("dropout_spec", None)
    jm = JDiffUnet(**kw, **({"dropout_spec": JDropoutSpec(**spec)} if spec else {}))
    tm = DiffUnet(**kw, **({"dropout_spec": DropoutSpec(**spec)} if spec else {}))
    monkeypatch.setattr(ChannelDropout, "draw_mask", torch_draw_mask)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, HW, HW, kw["in_channels"])).astype(np.float32)
    t = rng.random(B).astype(np.float32) if kw.get("diffusion") else None
    got, ref = forward_pair(jm, tm, x, t)
    np.testing.assert_allclose(got, ref, **LOGITS_TOL)
    if case.startswith("final_act"):
        assert got.min() >= (-1.0 if case.endswith("tanh") else 0.0) and got.max() <= 1.0
    if "mlp_attn" in case:
        assert any(isinstance(m, MLPBlock) for m in tm.modules())
    if spec:  # the skip dropout exists only where a skip is kept
        assert sum(name.endswith("_skip_dropout") for name, _ in tm.named_modules()) == 1


def test_one_skip_per_reso_needs_new_upsample_method_on_both_sides():
    kw = dict(NARROW, one_skip_per_reso=True)
    with pytest.raises(ValueError, match="requires new_upsample_method"):
        DiffUnet(**kw)
    with pytest.raises(AssertionError, match="requires new_upsample_method"):
        jax.eval_shape(JDiffUnet(**kw).init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    with pytest.raises(ValueError, match="Unsupported activation"):
        DiffUnet(**dict(NARROW, act="tanh"))
    with pytest.raises(ValueError, match="Unsupported final activation"):
        DiffUnet(**dict(NARROW, final_act="relu"))


@pytest.mark.parametrize("members", [0, 2])
def test_resblock_use_conv_skip_matches_jax(members):
    """``ResBlock.use_conv_skip``: a 3x3 skip conv where the width changes
    (the DiffUnet never sets it, as in JAX); also member-folded."""
    rng = np.random.default_rng(2)
    rows = B * max(members, 1)
    x = rng.standard_normal((rows, 8, 8, 8)).astype(np.float32)
    emb = rng.standard_normal((rows, 32)).astype(np.float32)
    jm = JResBlock(16, use_conv_skip=True, act="gelu", members=members)
    variables = random_variables(jm, jnp.asarray(x), jnp.asarray(emb), seed=3)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(emb)))
    tm = ResBlock(8, 16, dropout=0.0, per_block=True, residual_dropout=0.0, emb_channels=32,
                  act="gelu", use_conv_skip=True, members=members)
    tm.load_state_dict((flax_to_torch_stacked if members else flax_to_torch)(variables),
                       strict=True)
    assert tm.skip_conv.weight.shape[-2:] == (3, 3)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.float32, None, torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), ref, **LOGITS_TOL)


CONFIGS = ("unet4", "unet64", "unet256")


@pytest.mark.parametrize("network", CONFIGS)
def test_unet_configs_compose_and_build_as_jax(network):
    """``load_config(network=...)`` equals the JAX composition of
    ``configs/network/<network>.yaml`` on every network field; the network
    built at reduced depth (one ResBlock a level, full widths) gives JAX's
    logits on JAX's variables."""
    ref = j_load_config(network=network, model="softmax", eu_method="none")
    got = load_config(network=network, model="softmax", eu_method="none")
    for f in dataclasses.fields(got.network):
        assert _as_plain(getattr(got.network, f.name)) == _as_plain(getattr(ref.network, f.name)), \
            f.name
    levels = len(got.network.channel_mult)
    depth = [f"network.num_res_blocks={[1] * levels}", "network.num_middle_res_blocks=2"]
    jb = j_build_model(j_load_config(network=network, model="softmax", eu_method="none",
                                     overrides=depth))
    tb = build_model(load_config(network=network, model="softmax", eu_method="none",
                                 overrides=depth), device="cpu")
    x = np.random.default_rng(4).standard_normal((1, HW, HW, 3)).astype(np.float32)
    got_logits, ref_logits = forward_pair(jb.module, tb.module, x)
    np.testing.assert_allclose(got_logits, ref_logits, **LOGITS_TOL)
    widths = {m.weight.shape[-1] for m in tb.module.modules()
              if type(m).__name__ == "GroupNorm32"}
    assert max(widths) == 2 * got.network.model_channels * got.network.channel_mult[-1]


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 1, 4), (3, 8, 8, 16)])
def test_bilinear_upsample_matches_jax(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ref = np.asarray(j_upsample2x(jnp.asarray(x), method="bilinear"))
    got = upsample2x(torch.from_numpy(x), "bilinear")
    assert got.shape == ref.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_array_equal(upsample2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_upsample2x(jnp.asarray(x))))


@pytest.mark.parametrize("ties", [False, True])
def test_eaurc_matches_jax(ties):
    rng = np.random.default_rng(6)
    risks = rng.random(200)
    confids = rng.integers(0, 20, 200).astype(float) if ties else rng.random(200)
    assert eaurc(risks, confids) == pytest.approx(j_eaurc(risks, confids), abs=1e-12)


def test_combined_split_matches_jax(tmp_path):
    """A split of the combined schema over two datasets with 2 and 3 raters:
    the same samples, label paths, rater counts, dataset labels and loads as
    the JAX dataset, and a padded batch of mixed rater counts."""
    rng = np.random.default_rng(7)
    subjects = []
    for name, n_r in (("dsA", 2), ("dsB", 3)):
        proc = tmp_path / name / "preprocessed"
        (proc / "images").mkdir(parents=True)
        (proc / "labels").mkdir()
        for i in range(2):
            np.save(proc / "images" / f"{name}_{i}.npy", rng.random((8, 8)).astype(np.float32))
            for r in range(n_r):
                np.save(proc / "labels" / f"{name}_{i}_{r:02d}_mask.npy",
                        (rng.random((8, 8)) < 0.5).astype(np.uint8))
            subjects.append(f"{name}/images/{name}_{i}.npy")
    fold = {"id": subjects, "_meta": {"schema": "combined", "dataset_name": "mix",
                                      "dataset_configs": {"dsA": {"num_raters": 2},
                                                          "dsB": {"num_raters": 3}}}}
    splits = tmp_path / "mix" / "splits.pkl"
    splits.parent.mkdir()
    splits.write_bytes(pickle.dumps([fold]))
    ref = JDataset(splits, tmp_path / "mix", split="id")
    got = MultiRaterDataset(splits, tmp_path / "mix", split="id")
    assert len(got) == len(ref) == 4 and got.num_raters == ref.num_raters == 3
    assert got.image_ids == ref.image_ids and got.label_paths == ref.label_paths
    assert got.image_paths == ref.image_paths and got.dataset_label == ref.dataset_label
    for i in range(4):
        a, b = got.load(i), ref.load(i)
        assert a["dataset"] == b["dataset"] and a["image_id"] == b["image_id"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["seg"], b["seg"])
    assert got.stable_rater_index("x", 3) == ref.stable_rater_index("x", 3)
    batch = next(iter(BatchLoader(got, 4, drop_last=False)))
    j_batch = next(iter(JBatchLoader(ref, 4, use_native=False)))
    np.testing.assert_array_equal(batch["num_raters"], [2, 2, 3, 3])
    for k in ("image", "seg", "num_raters"):
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(j_batch[k]), err_msg=k)
    assert batch["dataset"] == ["dsA", "dsA", "dsB", "dsB"]
    with pytest.raises(ValueError, match="dataset_configs"):
        bad = tmp_path / "bad.pkl"
        bad.write_bytes(pickle.dumps([{"id": subjects, "_meta": {"schema": "combined"}}]))
        MultiRaterDataset(bad, tmp_path / "mix", split="id")


def test_every_network_option_is_read_by_the_factory():
    """Each option of ``NetworkConfig`` reaches the DiffUnet the factory
    builds (a config that selected one and built another would run other
    weights under the same name)."""
    ov = ["network.new_upsample_method=true", "network.one_skip_per_reso=true",
          "network.mlp_attn=true", "network.act=gelu", "network.final_act=sigmoid",
          "network.num_heads_upsample=2"]
    cfg = load_config(eu_method="none", overrides=ov)
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg
    config = build_model(cfg, device="cpu").module.config
    assert (config["new_upsample_method"], config["one_skip_per_reso"], config["mlp_attn"],
            config["act"], config["final_act"], config["num_heads_upsample"]) == (
        True, True, True, "gelu", "sigmoid", 2)
