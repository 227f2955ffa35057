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
from torch_threads import one_torch_thread  # noqa: F401

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
    """Every module of the port, ``chip_smoke``, the job's, the trainer's,
    the evaluation matrix's, the study's, the report's, the dataset
    dataset modules', the reference importer's and the diffusion seed
    spread's ``--help`` with JAX, optax, flax,
    YAML, tensorboardX, PIL, orbax, tensorstore, scikit-learn, pandas,
    matplotlib, h5py, pylidc and the JAX package blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'tensorboardX', 'cv2',\n"
        "             'diffuncertainty_tpu', 'PIL', 'orbax', 'tensorstore', 'sklearn',\n"
        "             'pandas', 'matplotlib', 'h5py', 'pylidc'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, runpy\n"
        "import diffuncertainty_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')\n"
        "        if not m.name.endswith('.__main__')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
        "for entry in ('infer', 'train', 'evaln.experiments', 'tools.values_study',\n"
        "              'tools.report', 'data.lidc_import', 'data.lidc_raw', 'data.toy3d',\n"
        "              'data.npc', 'tools.import_reference_checkpoint', 'data.retina',\n"
        "              'tools.diffusion_seed_spread'):\n"
        "    sys.argv = [entry, '--help']\n"
        "    try:\n"
        "        runpy.run_module('diffuncertainty_tpu_torch.' + entry, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, *usage = out.stdout.splitlines()
    assert int(count) >= 30
    usage = "\n".join(usage)
    assert "--checkpoint_paths" in usage and "--device" in usage
    assert "python -m diffuncertainty_tpu_torch.train" in usage and "device=cpu" in usage
    assert "--preflight-only" in usage and "--report" in usage
    assert "--quick" in usage and "--no-seed-grouping" in usage
    assert "--pickle-path" in usage and "--save_path" in usage and "--save-root" in usage
    assert "{process,splits,ood}" in usage and "--ckpt" in usage
    assert "{chaksu,chaksu-splits,clean-riga,riga,refuge,retina-splits}" in usage
    assert "--seed-bases" in usage


def test_no_forbidden_imports_or_library_kernels_in_the_port():
    bad_import = re.compile(
        r"^\s*(import|from)\s+(jax|yaml|PIL|orbax|tensorstore|optax|flax|tensorboardX"
        r"|sklearn|pandas|matplotlib|diffuncertainty_tpu\b)")
    # h5py and pylidc only inside the functions that read raw archives
    top_level_reader = re.compile(r"^(import|from)\s+(h5py|pylidc)\b")
    files = sorted((REPO / "diffuncertainty_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    port = REPO / "diffuncertainty_tpu_torch"
    assert {port / "train" / "losses.py", port / "train" / "loop.py",
            port / "models" / "diffusion.py", port / "models" / "prob_unet.py",
            port / "core" / "specs.py", port / "tools" / "train_recipe.py",
            port / "ops" / "member_fold.py", port / "evaln" / "experiments.py",
            port / "evaln" / "tasks.py", port / "evaln" / "dataloader.py",
            port / "evaln" / "visualization.py", port / "tools" / "values_study.py",
            port / "tools" / "report.py", port / "tools" / "checks.py",
            port / "data" / "jpeg.py", port / "data" / "resize.py", port / "data" / "ood.py",
            port / "data" / "preprocess.py", port / "data" / "lidc_raw.py",
            port / "data" / "lidc_import.py", port / "data" / "toy3d.py",
            port / "data" / "npc.py", port / "data" / "native_loader.py",
            port / "core" / "torch_import.py", port / "tools" / "import_reference_checkpoint.py",
            port / "tools" / "bench_weights.py", port / "utils" / "profiling.py",
            port / "data" / "retina.py", port / "data" / "jpeg_decode.py",
            port / "infer" / "image_io.py", port / "parallel" / "__init__.py",
            port / "parallel" / "mesh.py", port / "parallel" / "distributed.py"} <= set(files)
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not bad_import.match(line), f"{path}:{n}: {line}"
            assert not top_level_reader.match(line), f"{path}:{n}: {line}"
    for path in sorted((REPO / "diffuncertainty_tpu_torch").rglob("*.py")):
        text = path.read_text()
        for word in ("cpp_extension", "scaled_dot_product_attention", "torch.compile"):
            assert word not in text, f"{path} uses {word}"


def test_chip_smoke_paths_argument(monkeypatch, tmp_path):
    import chip_smoke

    assert chip_smoke.parse_paths([]) == chip_smoke.PATHS == (
        "softmax", "diffusion", "ssn", "prob_unet", "ensemble", "ensemble_folded", "unet256",
        "hrnet", "multiclass", "infer", "eval", "lidc_import", "multidevice", "retina",
        "study", "train",
        "train_diffusion", "train_ssn", "train_prob_unet", "train_hrnet", "train_subensemble",
        "train_multiclass", "train_swag", "train_ensemble")
    assert chip_smoke.parse_paths(["--paths", "multiclass,hrnet"]) == ("hrnet", "multiclass")
    assert chip_smoke.parse_paths(["--paths", "infer,softmax"]) == ("softmax", "infer")
    assert chip_smoke.parse_paths(["--paths", "train,hrnet"]) == ("hrnet", "train")
    assert chip_smoke.PATH_ASSETS["infer"] == chip_smoke.PATH_ASSETS["softmax"]
    # the evaluation runs on the job's tree of the softmax asset: it rides with infer
    assert chip_smoke.PATH_ASSETS["eval"] == chip_smoke.PATH_ASSETS["softmax"]
    assert chip_smoke.parse_paths(["--paths", "eval,infer"]) == ("infer", "eval")
    # the LIDC import serves the softmax asset as a reference checkpoint: it rides with infer
    assert chip_smoke.PATH_ASSETS["lidc_import"] == chip_smoke.PATH_ASSETS["softmax"]
    assert chip_smoke.parse_paths(["--paths", "lidc_import,eval,infer"]) == (
        "infer", "eval", "lidc_import")
    # two ranks run the softmax asset's job and step: it rides with infer; the
    # retina pipelines read the committed JPEG fixtures and no asset
    assert chip_smoke.PATH_ASSETS["multidevice"] == chip_smoke.PATH_ASSETS["softmax"]
    assert chip_smoke.PATH_ASSETS["retina"] is None
    assert chip_smoke.parse_paths(["--paths", "retina,multidevice,infer"]) == (
        "infer", "multidevice", "retina")
    # the study trains its own nets on generated data: it rides either group
    assert chip_smoke.PATH_ASSETS["study"] is None
    assert chip_smoke.parse_paths(["--paths", "train,study,hrnet"]) == ("hrnet", "study", "train")
    # the train path trains from scratch: its one file is the JAX members' quality record
    assert chip_smoke.PATH_ASSETS["train"].name == "ensemble16_quality.json"
    # the families' training paths read no file: they ride either group
    assert chip_smoke.parse_paths(["--paths", "train_prob_unet,hrnet,train_diffusion"]) == (
        "hrnet", "train_diffusion", "train_prob_unet")
    # the folded ensemble reads the SWAG asset; unet256 seeds its weights and reads none
    assert chip_smoke.PATH_ASSETS["ensemble_folded"] == chip_smoke.PATH_ASSETS["ensemble"]
    assert chip_smoke.PATH_ASSETS["unet256"] is None
    assert chip_smoke.parse_paths(["--paths", "unet256,ensemble_folded,softmax"]) == (
        "softmax", "ensemble_folded", "unet256")
    for model in ("diffusion", "ssn", "prob_unet", "multiclass", "swag", "ensemble"):
        assert chip_smoke.PATH_ASSETS[f"train_{model}"] is None
        assert set(chip_smoke.TRAIN_FAMILIES) == {"diffusion", "ssn", "prob_unet"}
    # the mask trainer learns masks over the softmax asset, and the HRNet's
    # gradients are checked at the trained HRNet: each rides with its asset
    assert chip_smoke.PATH_ASSETS["train_subensemble"] == chip_smoke.PATH_ASSETS["softmax"]
    assert chip_smoke.PATH_ASSETS["train_hrnet"] == chip_smoke.PATH_ASSETS["hrnet"]
    assert set(chip_smoke.NEW_TRAIN_RUNS) == {"train_hrnet", "train_multiclass", "train_swag",
                                              "train_ensemble"}
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


def test_device_time_is_the_union_of_kernel_intervals():
    """``profile_main_path.device_ms``: kernels overlapping on two streams
    count once in ``busy`` and in full in ``sum``; user annotations and
    host events are left out."""
    import types

    from diffuncertainty_tpu_torch.tools.profile_main_path import device_ms

    def event(start, end, stream, annotation=False, device=torch.autograd.DeviceType.CUDA):
        return types.SimpleNamespace(time_range=types.SimpleNamespace(start=start, end=end),
                                     device_resource_id=stream, device_type=device,
                                     is_user_annotation=annotation)

    trace = [event(0, 1000, 7), event(500, 1500, 14), event(2000, 2500, 7),
             event(0, 3000, 7, annotation=True),
             event(0, 9000, 0, device=torch.autograd.DeviceType.CPU)]
    prof = types.SimpleNamespace(events=lambda: trace)
    assert device_ms(prof, 2) == {"busy": 1.0, "sum": 1.25, "streams": 2}
