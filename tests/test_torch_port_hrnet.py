"""Port parity of the HRNet backbone: the forward (random weights and
BatchNorm statistics at width 8, and the trained hrnet-s asset), the SSN
heads, the factory, the batch_stats bridge, the reference-checkpoint
importer and the sampler's MC-dropout + TTA fold on the HRNet.

BatchNorm statistics are randomized in the small tests: with zero means and
unit variances a swapped or missing running_mean/running_var mapping would
not show. fp32 logits are held to atol 1e-5 / rtol 1e-4 (the JAX package's
own tolerance against the torch reference, tests/test_hrnet_parity.py);
bf16 to the bf16 noise of the JAX package itself: both sides round every conv
and BatchNorm output to bf16 (one rounding each, BatchNorm math in float32,
test_flax_batchnorm_normalizes_bf16_in_float32_like_the_port), but sum in
other orders, and through the network that noise grows to a few bf16 steps
of the logits, the size of JAX's own bf16-vs-fp32 distance (``BF16_NOISE``).

The final dropout is injected on both sides: in JAX by replacing
``jax.random.bernoulli`` (which the HRNet calls inline, one draw per branch)
with a function of the draw's shape, in the port by replacing
``HRNet.draw_keep`` with the same masks (NHWC, one per branch).
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.core.hrnet_torch_import import build_hrnet_mapping as j_mapping
from diffuncertainty_tpu.core.hrnet_torch_import import import_hrnet_state_dict as j_import
from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.models.hrnet import HRNet as JHRNet
from diffuncertainty_tpu.models.hrnet import HRNetSpec as JSpec
from diffuncertainty_tpu.models.unet import DropoutSpec as JDropoutSpec
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.ops.warp import separable_margins
from diffuncertainty_tpu.sampling import tta as j_tta
from diffuncertainty_tpu.tools.bench_weights import load_params_npz as j_load_npz
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core.config import load_config
from diffuncertainty_tpu_torch.core.hrnet_torch_import import import_hrnet_state_dict
from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_params_npz
from diffuncertainty_tpu_torch.core.specs import DropoutSpec
from diffuncertainty_tpu_torch.models.factory import BuiltModel, build_model
from diffuncertainty_tpu_torch.models.hrnet import BatchNorm, HRNet, HRNetSpec, upsample_to
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from diffuncertainty_tpu_torch.sampling import tta as t_tta
from test_torch_port_warp_tta import inverse, tta_matrices
from torch_threads import one_torch_thread  # noqa: F401

ASSET = "assets/bench_hrnet_s_toy128.npz"
SMALL = dict(width=8, stage1_channels=8, num_modules=(1, 1, 1), num_blocks=1)
# bf16: the port's logits may sit from JAX's bf16 logits at most this many
# times as far as JAX's bf16 logits sit from its fp32 ones (max and mean)
BF16_NOISE = 1.5


def small_pair(final_dropout: float = 0.0, ssn: bool = False, seed: int = 0,
               dtype: str = "fp32", hw: int = 32):
    """The same random weights and BatchNorm statistics in a JAX and a port
    HRNet (width 8, one module per stage, one block per branch)."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JHRNet(num_classes=2, spec=JSpec(**SMALL, final_dropout=final_dropout), ssn=ssn,
                ssn_rank=3, dtype=jdt)
    variables = random_variables(jm, seed, hw)
    tm = HRNet(2, HRNetSpec(**SMALL, final_dropout=final_dropout), ssn=ssn, ssn_rank=3, dtype=tdt)
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    return jm, tm.eval().requires_grad_(False), variables


def random_variables(jm, seed: int, hw: int = 32) -> dict:
    """Random params (scaled like a lecun-normal init) and BatchNorm
    statistics for ``jm``, from the shapes of its init (not compiled)."""
    shapes = jax.eval_shape(jm.init, {"params": jax.random.key(0), "dropout": jax.random.key(1)},
                            jnp.zeros((1, hw, hw, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":  # HWIO
            v = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "mean":
            v = 0.1 * rng.standard_normal(a.shape)
        elif name in ("var", "scale"):
            v = 1.0 + 0.2 * rng.random(a.shape)
        else:  # bias
            v = 0.05 * rng.standard_normal(a.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def masks_by_shape(seed: int = 3, rate: float = 0.2):
    """A keep-mask function of the draw's (NHWC) shape, the same on both sides."""
    cache = {}

    def mask(shape):
        key = tuple(int(s) for s in shape)
        if key not in cache:
            cache[key] = np.random.default_rng(seed + zlib.crc32(str(key).encode())).random(
                key) >= rate
        return cache[key]

    return mask


def inject_final_dropout(monkeypatch, mask):
    def bernoulli(key, p, shape):
        return jnp.asarray(mask(shape))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(HRNet, "draw_keep",
                        lambda self, branch, shape, generator, device:
                        torch.from_numpy(mask(shape)).to(device))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_hrnet_forward_matches_jax_with_random_batch_stats(monkeypatch, dtype):
    jm, tm, variables = small_pair(final_dropout=0.2, dtype=dtype)
    inject_final_dropout(monkeypatch, masks_by_shape())
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x), rngs={"dropout": jax.random.key(0)})
    got = tm(torch.from_numpy(x), torch.Generator())
    assert got.logits.dtype == torch.float32 and got.features.dtype == torch.float32
    assert got.logits.shape == (2, 32, 32, 2) and got.features.shape == (2, 8, 8, 120)
    ref_logits = np.asarray(ref.logits, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got.logits.numpy(), ref_logits, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features),
                                   atol=1e-5, rtol=1e-4)
    else:
        # the same weights in fp32 give the JAX package's own bf16 noise
        jm32 = JHRNet(num_classes=2, spec=jm.spec, dtype=jnp.float32)
        ref32 = np.asarray(jax.jit(jm32.apply)(variables, jnp.asarray(x),
                                               rngs={"dropout": jax.random.key(0)}).logits)
        own = np.abs(ref_logits - ref32)
        diff = np.abs(got.logits.numpy() - ref_logits)
        assert diff.max() <= BF16_NOISE * own.max() and diff.mean() <= BF16_NOISE * own.mean(), (
            diff.max(), own.max(), diff.mean(), own.mean())
        assert (got.logits.argmax(-1).numpy() == ref_logits.argmax(-1)).mean() >= 0.99
    # the statistics act: the forward with default statistics differs
    plain = HRNet(2, HRNetSpec(**SMALL, final_dropout=0.2)).requires_grad_(False)
    plain.load_state_dict({k: v for k, v in tm.state_dict().items() if "running" not in k},
                          strict=False)
    assert (plain(torch.from_numpy(x), torch.Generator()).logits - got.logits).abs().max() > 1e-2


def test_flax_batchnorm_normalizes_bf16_in_float32_like_the_port():
    """flax's BatchNorm(dtype=bf16) computes (x - mean) * rsqrt(var + eps) *
    scale + bias in float32 (the float32 statistics promote it) and rounds
    once to bf16; the port's BatchNorm does the same."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 4, 4, 16))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    bn = nn.BatchNorm(use_running_average=True, epsilon=1e-5, dtype=jnp.bfloat16)
    v = bn.init(jax.random.key(0), xb)
    v = {"params": {"scale": rng.standard_normal(16).astype(np.float32),
                    "bias": rng.standard_normal(16).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(16).astype(np.float32),
                         "var": (1.0 + rng.random(16)).astype(np.float32)}}
    ref = bn.apply(v, xb)
    assert ref.dtype == jnp.bfloat16
    f32 = ((np.asarray(xb, np.float32) - v["batch_stats"]["mean"])
           * (1.0 / np.sqrt(v["batch_stats"]["var"] + 1e-5)) * v["params"]["scale"]
           + v["params"]["bias"])
    np.testing.assert_allclose(np.asarray(ref, np.float32), f32, rtol=2.0 ** -8, atol=1e-6)
    tbn = BatchNorm(16)
    state = flax_to_torch({k: {"bn": d} for k, d in v.items()})
    tbn.load_state_dict({k.removeprefix("bn."): t for k, t in state.items()}, strict=True)
    got = tbn(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2),
              torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.detach().permute(0, 2, 3, 1).float().numpy() - np.asarray(ref, np.float32))
    # at most one bf16 step apart (the two round the same f32 value up to its last bits)
    assert (diff <= 2.0 ** -7 * np.abs(np.asarray(ref, np.float32)) + 1e-6).all()


@pytest.mark.parametrize("size", [(4, 4), (4, 6), (3, 5)])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_matches_jax_image_resize_edges_included(size, factor):
    x = np.random.default_rng(factor).standard_normal((2,) + size + (3,)).astype(np.float32)
    h, w = size[0] * factor, size[1] * factor
    ref = jax.image.resize(jnp.asarray(x), (2, h, w, 3), method="bilinear")
    got = upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # the edge rows and columns copy the edge pixels' blend
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref)[:, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, :, -1].numpy(), np.asarray(ref)[:, :, -1], atol=1e-6)


def test_strided_1x1_conv_subsamples_like_member_conv():
    """The Bottleneck's and BasicBlock's strided 1x1 ``down_conv`` is a
    subsample plus a matmul in JAX (MemberConv), not a padded conv."""
    from diffuncertainty_tpu.models.unet import MemberConv
    from diffuncertainty_tpu_torch.models.hrnet import Conv

    x = np.random.default_rng(0).standard_normal((2, 9, 9, 5)).astype(np.float32)
    jc = MemberConv(7, (1, 1), strides=2, use_bias=False)
    p = jc.init(jax.random.key(0), jnp.asarray(x))
    ref = jc.apply(p, jnp.asarray(x))
    tc = Conv(5, 7, 1, stride=2)
    tc.load_state_dict({"weight": flax_to_torch(p)["weight"]})
    got = tc(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 5, 5, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_hrnet_ssn_heads_match_jax():
    jm, tm, variables = small_pair(ssn=True, seed=2)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    for k in ("logits", "ssn_mean", "ssn_cov_diag", "ssn_cov_factor"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    assert got.ssn_cov_factor.shape == (2, 32 * 32 * 2, 3)
    # mean_only: the same mean and diagonal, a zero factor (as in JAX)
    mean_only = tm(torch.from_numpy(x), mean_only=True)
    torch.testing.assert_close(mean_only.ssn_cov_diag, got.ssn_cov_diag, atol=0, rtol=0)
    assert torch.equal(mean_only.ssn_cov_factor, torch.zeros_like(got.ssn_cov_factor))


@pytest.mark.parametrize("network,data,model,eu", [
    ("hrnet-s", "lidc128", "softmax", "dropout"), ("hrnet-m", "lidc128", "ssn", "none"),
    ("hrnet-s", "gta_toy", "softmax", "dropout"), ("unet16", "gta_toy", "softmax", "dropout")])
def test_config_groups_and_factory_match_jax(network, data, model, eu):
    ref_cfg = j_load_config(data=data, network=network, model=model, eu_method=eu)
    cfg = load_config(data=data, network=network, model=model, eu_method=eu)
    for group in ("network", "data"):
        for f in dataclasses.fields(getattr(cfg, group)):
            if f.name == "augmentations":
                continue
            ours, theirs = getattr(getattr(cfg, group), f.name), getattr(getattr(ref_cfg, group),
                                                                          f.name)
            assert (tuple(theirs) if isinstance(theirs, list) else theirs) == ours, f.name
    assert cfg.data.augmentations.mean == tuple(ref_cfg.data.augmentations.mean)
    assert cfg.data.augmentations.std == tuple(ref_cfg.data.augmentations.std)
    built, ref = build_model(cfg, device="cpu"), j_build_model(ref_cfg)
    for k in ("au_type", "eu_type", "is_generative", "num_classes", "backbone",
              "has_batch_stats"):
        assert getattr(built, k) == getattr(ref, k), k
    if ref.backbone == "hrnet":
        assert dataclasses.asdict(built.module.spec) == dataclasses.asdict(ref.module.spec)
        assert built.module.ssn == ref.module.ssn


def test_hrnet_factory_guard_and_device():
    for model in ("diffusion", "prob_unet"):
        with pytest.raises(ValueError, match="HRNet does not support"):
            build_model(load_config(network="hrnet-s", model=model, eu_method="none"),
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(load_config(network="hrnet-s"))
    with pytest.raises(NotImplementedError):
        load_config(network="hrnet-l")


def test_trained_asset_bridge_maps_every_leaf_and_matches_jax():
    flat = np.load(ASSET).files
    assert len(flat) == 1533
    state = flax_to_torch(load_params_npz(ASSET))
    built = build_model(load_config(network="hrnet-s", eu_method="none"), device="cpu")
    module = built.module.requires_grad_(False)
    assert len(state) == len(flat) == len(module.state_dict())
    module.load_state_dict(state, strict=True)
    tree = j_load_npz(ASSET)
    # no buffer at its default: every running statistic is the asset's
    for name, mod in module.named_modules():
        if isinstance(mod, BatchNorm):
            path = name.split(".")
            node = tree["batch_stats"]
            for p in path:
                node = node[p]
            np.testing.assert_array_equal(mod.running_mean.numpy(), node["mean"])
            np.testing.assert_array_equal(mod.running_var.numpy(), node["var"])
            assert not torch.equal(mod.running_var, torch.ones_like(mod.running_var))
    np.testing.assert_array_equal(
        state["layer1_block0.conv2.weight"].numpy(),
        np.asarray(tree["params"]["layer1_block0"]["conv2"]["kernel"]).transpose(3, 2, 0, 1))

    jref = j_build_model(j_load_config(data="lidc128", network="hrnet-s", model="softmax",
                                       eu_method="none"))
    x = np.random.default_rng(5).random((2, 128, 128, 3)).astype(np.float32)
    ref = jax.jit(jref.module.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(ref.logits),
                               atol=1e-5, rtol=1e-4)


def reference_state_dict(jm, variables, seed=0):
    """A reference-layout (``HighResolutionNet``) state dict for ``jm``'s
    spec: every mapped key with a random value of its torch shape, plus the
    BatchNorms' ``num_batches_tracked``."""
    rng = np.random.default_rng(seed)
    out = {}
    for torch_key, path, transform in j_mapping(jm):
        node = variables
        for k in path:
            node = node[k]
        shape = np.asarray(node).shape
        if transform is not None:  # conv: flax HWIO <- torch OIHW
            shape = (shape[3], shape[2], shape[0], shape[1])
        if path[-1] == "var":
            out[torch_key] = (1.0 + rng.random(shape)).astype(np.float32)
        else:
            out[torch_key] = rng.standard_normal(shape).astype(np.float32)
        if torch_key.endswith("running_var"):
            out[torch_key.replace("running_var", "num_batches_tracked")] = np.asarray(7)
    return out


@pytest.mark.parametrize("ssn", [False, True])
def test_reference_checkpoint_import_matches_jax_import_then_bridge(ssn):
    jm, tm, variables = small_pair(ssn=ssn, seed=6)
    ref_sd = reference_state_dict(jm, variables)
    ref = flax_to_torch(j_import(jm, variables, ref_sd))
    got = import_hrnet_state_dict(tm, ref_sd)
    assert set(got) == set(ref) == set(tm.state_dict())
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    tm.load_state_dict(got, strict=True)
    # strict: an unmapped key or a missing one raises on both sides
    extra = dict(ref_sd, **{"stray.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        j_import(jm, variables, extra)
    with pytest.raises(KeyError):
        import_hrnet_state_dict(tm, extra)


def test_tolerant_import_skips_mismatched_heads_like_jax():
    """strict=False keeps the task head when the checkpoint's head has
    another class count (an ImageNet-pretrained or 5-class checkpoint)."""
    jm5 = JHRNet(num_classes=5, spec=JSpec(**SMALL))
    v5 = random_variables(jm5, seed=0)
    ref_sd = reference_state_dict(jm5, v5, seed=8)
    jm, tm, variables = small_pair(seed=9)
    ref = flax_to_torch(j_import(jm, variables, ref_sd, strict=False))
    got = import_hrnet_state_dict(tm, ref_sd, strict=False)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got["last_conv2.weight"].numpy(),
                                  tm.state_dict()["last_conv2.weight"].numpy())
    with pytest.raises(ValueError, match="Shape mismatch"):
        import_hrnet_state_dict(tm, ref_sd)


def test_hrnet_dropout_tta_slice_matches_jax(monkeypatch):
    """The sampler's flat_softmax on the HRNet: members x TTA folded into
    rows, BatchNorm on its running statistics, one final-dropout draw per
    branch over all rows; masks and TTA matrices injected."""
    members, b, hw = 3, 2, 32
    jm, tm, variables = small_pair(final_dropout=0.2, seed=11)
    rng = np.random.default_rng(12)
    images = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    fwd = tta_matrices(rng, members * b, hw, hw)
    inv = inverse(fwd)
    mx, my = separable_margins(22.5, 0.8, 1.2, True, hw, hw)
    monkeypatch.setattr(j_sampler_mod, "sample_tta_params",
                        lambda cfg, key, batch, h, w:
                        j_tta.TTAParams(jnp.asarray(fwd), jnp.asarray(inv), True, mx, my))
    monkeypatch.setattr(t_sampler_mod, "sample_tta_params",
                        lambda cfg, gen, batch, h, w:
                        t_tta.TTAParams(torch.from_numpy(fwd), torch.from_numpy(inv), True,
                                        mx, my))
    mask = masks_by_shape(seed=13)
    inject_final_dropout(monkeypatch, mask)
    drawn = []
    draw = HRNet.draw_keep
    monkeypatch.setattr(HRNet, "draw_keep", lambda self, *a: drawn.append(a[1]) or draw(self, *a))

    dspec = DropoutSpec(enabled=True, probability_values=(0.2,))
    jb = JBuilt(module=jm, au_type="softmax", eu_type="dropout", is_generative=False,
                num_classes=2, backbone="hrnet",
                dropout_spec=JDropoutSpec(enabled=True, probability_values=(0.2,)))
    tb = BuiltModel(module=tm, au_type="softmax", eu_type="dropout", is_generative=False,
                    num_classes=2, backbone="hrnet", dropout_spec=dspec)
    tta = dict(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2))
    j_fn = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(
        n_pred=1, n_members=members, member_mode="dropout", tta=True,
        tta_config=j_tta.TTAConfig(**tta)))
    ref = jax.jit(j_fn)(variables, jnp.asarray(images), jax.random.key(0))
    t_fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
        n_pred=1, n_members=members, member_mode="dropout", tta=True,
        tta_config=t_tta.TTAConfig(**tta)))
    got = t_fn(torch.from_numpy(images), torch.Generator())
    # one draw per branch, each over all members x images rows
    assert drawn == [(members * b, hw // 4 // 2 ** i, hw // 4 // 2 ** i, 8 * 2 ** i)
                     for i in range(4)]
    assert tuple(t_fn.meta) == tuple(j_fn.meta)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)
    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5,
                                   err_msg=k)
    assert float(maps["EU"].mean()) > 1e-4  # dropout and TTA acted


def test_hrnet_sampler_draws_fresh_final_dropout_per_call():
    _, tm, _ = small_pair(final_dropout=0.2, seed=14)
    tb = BuiltModel(module=tm, au_type="softmax", eu_type="dropout", is_generative=False,
                    num_classes=2, backbone="hrnet")
    fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(
        n_pred=1, n_members=4, member_mode="dropout"))
    x = torch.randn(2, 32, 32, 3)
    a = fn(x, torch.Generator().manual_seed(0))
    b = fn(x, torch.Generator().manual_seed(0))
    c = fn(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.groups, b.groups, atol=0, rtol=0)
    assert not torch.equal(a.groups, c.groups)
    assert (a.groups[0] - a.groups[1]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="Generator"):
        tm(x)
