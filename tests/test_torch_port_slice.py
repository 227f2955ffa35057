"""Port parity of the whole slice: sampler -> stack -> heatmaps -> batch
metrics, the toy-128 quality eval, and the import boundary.

The slice runs a narrow DiffUnet (2 levels, attention at the bottom) at
32x32 with random weights (noise on every leaf, so no head is zero) through
the JAX sampler and the port's, with the same dropout masks (injected as in
test_torch_port_model) and the same TTA matrices (injected in place of
``sample_tta_params``). Float32; stacks and heatmaps are held to 1e-5,
per-image Dice/GED (ratios of integer counts on argmax maps) to 1e-6.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.infer.batch_metrics import make_batch_metrics as j_make_bm
from diffuncertainty_tpu.models.factory import BuiltModel as JBuilt
from diffuncertainty_tpu.models.unet import DiffUnet as JDiffUnet
from diffuncertainty_tpu.models.unet import DropoutSpec as JDropoutSpec
from diffuncertainty_tpu.ops.entropy import uncertainty_heatmaps as j_maps
from diffuncertainty_tpu.ops.warp import separable_margins
from diffuncertainty_tpu.sampling import tta as j_tta
from diffuncertainty_tpu.tools.quality import toy128_quality_eval as j_quality
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.core.config import load_config
from diffuncertainty_tpu_torch.core.params import flax_to_torch
from diffuncertainty_tpu_torch.core.specs import DropoutSpec
from diffuncertainty_tpu_torch.infer.batch_metrics import make_batch_metrics
from diffuncertainty_tpu_torch.models.factory import BuiltModel
from diffuncertainty_tpu_torch.models.unet import ChannelDropout, DiffUnet
from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
from diffuncertainty_tpu_torch.sampling import tta as t_tta
from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval
from test_torch_port_model import jax_mask_interceptor, torch_draw_mask
from test_torch_port_warp_tta import inverse, tta_matrices

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(in_channels=3, out_channels=2, model_channels=32, num_res_blocks=(1, 1),
             num_middle_res_blocks=2, attention_resolutions=(-1,), channel_mult=(1, 2),
             num_heads=4)
TTA = dict(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2))


def small_pair(rate: float, seed: int = 0):
    """The same random weights in a JAX and a port DiffUnet."""
    j_spec = JDropoutSpec(enabled=rate > 0, probability_values=(rate,))
    jm = JDiffUnet(**SMALL, dropout_spec=j_spec)
    params = jm.init({"params": jax.random.key(seed)}, jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    t_spec = DropoutSpec(**dataclasses.asdict(j_spec))
    tm = DiffUnet(**SMALL, dropout_spec=t_spec)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    jb = JBuilt(module=jm, au_type="softmax", eu_type="dropout" if rate else "none",
                is_generative=False, num_classes=2, dropout_spec=j_spec)
    tb = BuiltModel(module=tm.eval(), au_type="softmax", eu_type="dropout" if rate else "none",
                    is_generative=False, num_classes=2, dropout_spec=t_spec)
    return jb, tb, params


def test_slice_matches_jax_with_injected_masks_and_tta(monkeypatch):
    members, b, hw = 3, 2, 32
    jb, tb, params = small_pair(rate=0.2)
    rng = np.random.default_rng(7)
    images = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    gt = (rng.random((b, 4, hw, hw)) < 0.3).astype(np.int32)
    fwd = tta_matrices(rng, members * b, hw, hw)
    inv = inverse(fwd)
    mx, my = separable_margins(22.5, 0.8, 1.2, True, hw, hw)

    def j_params(cfg, key, batch, h, w):
        assert (batch, h, w) == (members * b, hw, hw)
        return j_tta.TTAParams(jnp.asarray(fwd), jnp.asarray(inv), True, mx, my)

    def t_params(cfg, generator, batch, h, w):
        assert (batch, h, w) == (members * b, hw, hw)
        return t_tta.TTAParams(torch.from_numpy(fwd), torch.from_numpy(inv), True, mx, my)

    monkeypatch.setattr(j_sampler_mod, "sample_tta_params", j_params)
    monkeypatch.setattr(t_sampler_mod, "sample_tta_params", t_params)
    monkeypatch.setattr(ChannelDropout, "draw_mask", torch_draw_mask)

    j_spec = j_sampler_mod.SamplerSpec(n_pred=1, n_members=members, member_mode="dropout",
                                       tta=True, tta_config=j_tta.TTAConfig(**TTA))
    j_fn = j_sampler_mod.make_sampler(jb, j_spec)

    @jax.jit
    def j_run(p, x, key):
        with nn.intercept_methods(jax_mask_interceptor):
            return j_fn(p, x, key)

    ref = j_run(params, jnp.asarray(images), jax.random.key(0))
    t_spec = t_sampler_mod.SamplerSpec(n_pred=1, n_members=members, member_mode="dropout",
                                       tta=True, tta_config=t_tta.TTAConfig(**TTA))
    t_fn = t_sampler_mod.make_sampler(tb, t_spec)
    got = t_fn(torch.from_numpy(images), torch.Generator())
    assert tuple(t_fn.meta) == tuple(j_fn.meta)
    assert got.groups.shape == (members, 1, b, hw, hw, 2)
    for k in ("groups", "group_means", "mean"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=1e-5, err_msg=k)

    maps_ref = j_maps(ref.group_means, sample_axis=0, class_axis=-1)
    maps = uncertainty_heatmaps(got.group_means, sample_axis=0, class_axis=-1)
    for k in ("TU", "AU", "EU"):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(maps_ref[k]), atol=1e-5, err_msg=k)
    assert float(maps["EU"].mean()) > 1e-4  # members differ: dropout and TTA acted

    bm_ref = j_make_bm(num_classes=2, ignore_index=-1, meta=j_fn.meta,
                       compute_likelihood=False)(ref, jnp.asarray(gt))
    bm = make_batch_metrics(num_classes=2, ignore_index=-1)(got, torch.from_numpy(gt))
    for k in ("dice", "ged_bma", "ged", "max_dice_pred", "max_dice_gt", "major_dice"):
        np.testing.assert_allclose(bm[k].numpy(), np.asarray(bm_ref[k]), atol=1e-6, err_msg=k)


def test_sampler_draws_fresh_masks_and_tta_per_row():
    _, tb, _ = small_pair(rate=0.2)
    spec = t_sampler_mod.SamplerSpec(n_pred=1, n_members=4, member_mode="dropout", tta=True,
                                     tta_config=t_tta.TTAConfig(**TTA))
    fn = t_sampler_mod.make_sampler(tb, spec)
    x = torch.randn(2, 32, 32, 3)
    a = fn(x, torch.Generator().manual_seed(0))
    b = fn(x, torch.Generator().manual_seed(0))
    c = fn(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.groups, b.groups, atol=0, rtol=0)
    assert not torch.equal(a.groups, c.groups)
    assert (a.groups[0] - a.groups[1]).abs().max() > 1e-3  # members differ
    torch.testing.assert_close(a.groups.sum(-1), torch.ones(4, 1, 2, 32, 32))


def test_quality_eval_matches_jax_with_a_deterministic_sampler():
    """No dropout, no TTA: both packages see the same predictions on the same
    toy split, so every quality metric must agree (JAX rounds dice/GED to 4
    and AURC/ECE to 5 decimals)."""
    jb, tb, params = small_pair(rate=0.0, seed=3)
    j_fn = j_sampler_mod.make_sampler(jb, j_sampler_mod.SamplerSpec(n_pred=1, n_members=1))
    t_fn = t_sampler_mod.make_sampler(tb, t_sampler_mod.SamplerSpec(n_pred=1, n_members=1))
    jcfg = j_load_config(data="lidc128", network="unet16", model="softmax", eu_method="dropout")
    ref = j_quality(jb, j_fn, params, jcfg.data, batch=16, hw=32)
    got = toy128_quality_eval(tb, t_fn, load_config().data, batch=16, hw=32, device="cpu")
    for k, decimals in (("dice", 4), ("ged_bma", 4), ("aurc", 5), ("ece", 5)):
        assert abs(got[k] - ref[k]) <= 0.5 * 10.0 ** -decimals + 1e-6, (k, got[k], ref[k])


def test_port_imports_without_jax_yaml_or_the_jax_package():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'yaml', 'cv2', 'diffuncertainty_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import diffuncertainty_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_no_forbidden_imports_or_library_kernels_in_the_port():
    bad_import = re.compile(r"^\s*(import|from)\s+(jax|yaml|diffuncertainty_tpu\b)")
    files = sorted((REPO / "diffuncertainty_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not bad_import.match(line), f"{path}:{n}: {line}"
    for path in sorted((REPO / "diffuncertainty_tpu_torch").rglob("*.py")):
        text = path.read_text()
        for word in ("cpp_extension", "scaled_dot_product_attention", "torch.compile"):
            assert word not in text, f"{path} uses {word}"


def test_chip_smoke_paths_argument(monkeypatch, tmp_path):
    import chip_smoke

    assert chip_smoke.parse_paths([]) == chip_smoke.PATHS == (
        "softmax", "diffusion", "ssn", "prob_unet", "ensemble", "hrnet", "multiclass")
    assert chip_smoke.parse_paths(["--paths", "multiclass,hrnet"]) == ("hrnet", "multiclass")
    for bad in ("hrnet,resnet", ","):
        with pytest.raises(SystemExit):
            chip_smoke.parse_paths(["--paths", bad])
    monkeypatch.setitem(chip_smoke.PATH_ASSETS, "hrnet", tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        chip_smoke.parse_paths(["--paths", "softmax,hrnet"])


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even on a machine with one
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:  # a directory that holds the script and nothing else
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script), "--paths", "hrnet"], cwd=cwd,
                             capture_output=True, text=True, timeout=300, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
