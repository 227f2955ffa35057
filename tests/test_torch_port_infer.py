"""Port parity of the uncertainty-inference job: ``python -m
diffuncertainty_tpu_torch.infer`` against ``python -m
diffuncertainty_tpu.infer`` on the same checkpoint and split.

No training: the checkpoints hold random weights of a narrow DiffUnet (16
channels, 2 levels, attention at the bottom) drawn with numpy on the shapes
of ``jax.eval_shape(init)``, saved by the JAX ``save_checkpoint`` (orbax)
and exported by ``export_torch_checkpoint.py``. The split is the JAX
``generate_toy_dataset``'s ``id`` split (6 images of 32 px, 4 raters), run at
batch 4, so the second batch is padded. Both jobs run in float32 on the CPU;
the JAX job on one device (``mesh_shape=(1, 1)``).

Random draws are injected on both sides: the dropout masks (a numpy mask per
site and row shape, ``test_torch_port_model``) and the TTA matrices (4 fixed
matrices, tiled over the rounds of a batch: the JAX sampler draws per round
of 4 rows where the port draws for all rounds at once). Tolerances, per
image: every ``metrics.json`` and ``likelihood.json`` value to atol 1e-5,
every TIFF to atol 1e-5, every PNG decoded to the same array, and the same
set of files.
"""

import ast
import functools
import json
import pickle
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import diffuncertainty_tpu.infer.runner as j_runner_mod
import diffuncertainty_tpu.sampling.sampler as j_sampler_mod
import export_torch_checkpoint
from diffuncertainty_tpu.core.checkpoint import save_checkpoint as j_save_checkpoint
from diffuncertainty_tpu.core.config import load_config as j_load_config
from diffuncertainty_tpu.data.toy import generate_toy_dataset
from diffuncertainty_tpu.infer import cli as j_cli
from diffuncertainty_tpu.infer.batch_metrics import make_batch_metrics as j_make_bm
from diffuncertainty_tpu.infer.results import ResultsWriter as JResultsWriter
from diffuncertainty_tpu.infer.runner import InferenceConfig as JInferenceConfig
from diffuncertainty_tpu.infer.runner import UncertaintyInference as JUncertaintyInference
from diffuncertainty_tpu.models.factory import build_model as j_build_model
from diffuncertainty_tpu.ops.warp import separable_margins
from diffuncertainty_tpu.sampling import tta as j_tta
from diffuncertainty_tpu.sampling.sampler import PredictionStack as JStack
from diffuncertainty_tpu.sampling.sampler import SamplerMeta as JMeta
import diffuncertainty_tpu_torch.infer.results as t_results_mod
import diffuncertainty_tpu_torch.sampling.sampler as t_sampler_mod
from diffuncertainty_tpu_torch.infer import cli as t_cli
from diffuncertainty_tpu_torch.infer.batch_metrics import make_batch_metrics
from diffuncertainty_tpu_torch.infer.image_io import read_png, read_tiff, write_png, write_tiff
from diffuncertainty_tpu_torch.infer.results import ResultsWriter
from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
from diffuncertainty_tpu_torch.models.unet import ChannelDropout
from diffuncertainty_tpu_torch.sampling import tta as t_tta
from diffuncertainty_tpu_torch.sampling.sampler import PredictionStack, SamplerMeta
from test_torch_port_model import jax_mask_interceptor, torch_draw_mask
from test_torch_port_warp_tta import inverse, tta_matrices
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
HW, BATCH, N_TEST = 32, 4, 6
SMALL = ["network.model_channels=16", "network.num_res_blocks=[1,1]",
         "network.channel_mult=[1,2]", "network.attention_resolutions=[-1]"]
ATOL = 1e-5  # metrics, NLL and heatmaps, float32
# raw probabilities of a single-image call: the repo's float32 full-model
# tolerance (tests/test_torch_parity.py:146; unet16 in float32 is 1.4e-5 from
# float64)
MODEL_TOL = dict(atol=1e-5, rtol=1e-4)
# a full palette: PIL writes a palette image at the bit depth its palette
# needs, and with no palette set (as the JAX job writes its multiclass masks)
# at 1 bit, which loses every class above 1; with this one it keeps 8 bits
GRAY = [v for i in range(256) for v in (i, i, i)]


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    return generate_toy_dataset(tmp_path_factory.mktemp("toy"), num_train=2, num_val=1,
                                num_test=N_TEST, num_ood=1, size=HW, seed=0)


def j_config(data_dir, model="softmax", eu="none", extra=()):
    return j_load_config(data="lidc128", network="unet16", model=model, eu_method=eu,
                         overrides=SMALL + [f"data.data_input_dir={data_dir}",
                                            "data.split_name=default", *extra])


def random_variables(cfg, seed: int) -> dict:
    """Random flax variables of ``cfg``'s network: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    module = j_build_model(cfg).module
    shapes = jax.eval_shape(module.init, {"params": jax.random.key(0),
                                          "dropout": jax.random.key(1)},
                            jnp.zeros((1, HW, HW, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return (1.0 if name == "scale" else 0.0) + np.float32(0.1) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def checkpoint_pair(root: Path, name: str, cfg, state: dict, epoch: int = 3):
    """A JAX checkpoint ``root/jax/<name>/checkpoints/last`` and its export
    ``root/port/<name>/checkpoints/last``."""
    src = root / "jax" / name / "checkpoints" / "last"
    dst = root / "port" / name / "checkpoints" / "last"
    j_save_checkpoint(src, state, cfg, epoch=epoch)
    export_torch_checkpoint.export(src, dst)
    return src, dst


def jax_job(paths, out: Path, **kw) -> JUncertaintyInference:
    return JUncertaintyInference(paths, JInferenceConfig(batch_size=BATCH, mesh_shape=(1, 1),
                                                         save_dir=str(out), **kw))


def run_jax(paths, out: Path, intercept: bool = False, **kw) -> Path:
    inf = jax_job(paths, out, **kw)
    if intercept:  # the dropout masks of jax_mask_interceptor in every sampler
        for src in inf.sources:
            def masked(p, x, key, _fn=src["sampler"]):
                with nn.intercept_methods(jax_mask_interceptor):
                    return _fn(p, x, key)
            src["jit_sampler"] = jax.jit(masked)
        inf._jit_sampler = inf.sources[0]["jit_sampler"]
    assert inf.run_split("id")["n_images"] == N_TEST
    return inf.split_dir("id")


def run_port(paths, out: Path, **kw) -> tuple[Path, UncertaintyInference]:
    inf = UncertaintyInference(paths, InferenceConfig(batch_size=BATCH, save_dir=str(out),
                                                      device="cpu", **kw))
    summary = inf.run_split("id")
    assert summary["n_images"] == N_TEST and summary["images_per_sec"] > 0
    return inf.split_dir("id"), inf


def assert_same_tree(j_dir: Path, t_dir: Path) -> None:
    """Same files; JSON values and TIFFs to ATOL; PNGs decoded equal."""
    files = {p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file()}
    assert files == {p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file()}
    for name in ("metrics.json", "likelihood.json"):
        if Path(name) not in files:
            continue
        ref, got = (json.loads((d / name).read_text()) for d in (j_dir, t_dir))
        assert list(got) == list(ref) and len(ref) == N_TEST
        for image_id, rec in ref.items():
            assert got[image_id]["dataset"] == rec["dataset"]
            flat = (rec["metrics"] if name == "metrics.json"
                    else {k: v for k, v in rec.items() if k != "dataset"})
            flat_got = (got[image_id]["metrics"] if name == "metrics.json"
                        else {k: v for k, v in got[image_id].items() if k != "dataset"})
            assert set(flat_got) == set(flat), (name, image_id)
            for k, v in flat.items():
                np.testing.assert_allclose(np.asarray(flat_got[k]), np.asarray(v), atol=ATOL,
                                           err_msg=f"{name} {image_id} {k}")
    for rel in sorted(files):
        if rel.suffix == ".tif":
            ref = np.asarray(Image.open(j_dir / rel))
            got = read_tiff(t_dir / rel)
            assert got.dtype == np.float32 and got.shape == ref.shape == (HW, HW)
            np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=str(rel))
        elif rel.suffix == ".png":
            ref = np.asarray(Image.open(j_dir / rel))
            np.testing.assert_array_equal(read_png(t_dir / rel), ref, err_msg=str(rel))
            np.testing.assert_array_equal(np.asarray(Image.open(t_dir / rel)), ref)


def assert_json_close(got, ref, where: str) -> None:
    """Same keys in the same order, numbers to ATOL."""
    if isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            assert_json_close(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_json_close(g, r, f"{where}[{i}]")
    elif isinstance(ref, float):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=where)
    else:
        assert got == ref, where


@pytest.fixture
def inject_draws(monkeypatch):
    """The same dropout masks and TTA matrices on both sides."""
    fwd = tta_matrices(np.random.default_rng(7), BATCH, HW, HW)
    inv = inverse(fwd)
    mx, my = separable_margins(22.5, 0.8, 1.2, True, HW, HW)

    def tiled(batch):
        assert batch % BATCH == 0
        return np.tile(fwd, (batch // BATCH, 1, 1)), np.tile(inv, (batch // BATCH, 1, 1))

    def j_params(cfg, key, batch, h, w):
        f, i = tiled(batch)
        return j_tta.TTAParams(jnp.asarray(f), jnp.asarray(i), True, mx, my)

    def t_params(cfg, generator, batch, h, w):
        f, i = tiled(batch)
        return t_tta.TTAParams(torch.from_numpy(f), torch.from_numpy(i), True, mx, my)

    monkeypatch.setattr(j_sampler_mod, "sample_tta_params", j_params)
    monkeypatch.setattr(t_sampler_mod, "sample_tta_params", t_params)
    monkeypatch.setattr(ChannelDropout, "draw_mask", torch_draw_mask)


@pytest.fixture(scope="module")
def softmax_pair(toy_dir, tmp_path_factory):
    """(a) and (h): a softmax checkpoint without EU, with EMA weights beside
    its weights, and an EMA-only snapshot of it."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = j_config(toy_dir)
    state = {"params": random_variables(cfg, 0), "ema_params": random_variables(cfg, 1)}
    full = checkpoint_pair(root, "v0", cfg, state)
    ema_only = checkpoint_pair(root, "v1", cfg, {"ema_params": state["ema_params"]}, epoch=5)
    return full, ema_only


def test_a_softmax_without_eu_writes_the_jax_tree(softmax_pair, tmp_path):
    (src, dst), _ = softmax_pair
    j_dir = run_jax([src], tmp_path / "jax", n_pred=1, n_models=1)
    t_dir, inf = run_port([dst], tmp_path / "port", n_pred=1, n_models=1)
    assert t_dir.relative_to(tmp_path / "port") == j_dir.relative_to(tmp_path / "jax")
    assert inf.meta == (1, 1, (False,))
    assert (t_dir / "pred_entropy").is_dir() and not (t_dir / "TU").exists()
    assert_same_tree(j_dir, t_dir)
    # the raw stacks of a sampled subset: the same images, the same stacks
    ref = jax_job([src], tmp_path / "jax", n_pred=1, n_models=1).collect_raw_predictions(
        "id", num_images=2)
    got = inf.collect_raw_predictions("id", num_images=2)
    assert [r["image_id"] for r in got["records"]] == [r["image_id"] for r in ref["records"]]
    assert got["group_is_generative"] == ref["group_is_generative"]
    for r_got, r_ref in zip(got["records"], ref["records"]):
        assert r_got["groups"].shape == r_ref["groups"].shape == (1, 1, HW, HW, 2)
        for k in ("image", "gt"):
            np.testing.assert_array_equal(r_got[k], np.asarray(r_ref[k]), err_msg=k)
        for k in ("groups", "mean"):  # one image a call: the full-model fp32 tolerance
            np.testing.assert_allclose(r_got[k], np.asarray(r_ref[k]), **MODEL_TOL, err_msg=k)


def test_b_dropout_and_tta_with_injected_draws(toy_dir, tmp_path, inject_draws):
    cfg = j_config(toy_dir, eu="dropout")
    src, dst = checkpoint_pair(tmp_path / "ckpt", "v0", cfg,
                               {"params": random_variables(cfg, 2)})
    kw = dict(n_pred=2, n_models=3, tta=True, seed=5)
    j_dir = run_jax([src], tmp_path / "jax", intercept=True, **kw)
    t_dir, inf = run_port([dst], tmp_path / "port", **kw)
    assert inf.spec.member_mode == "dropout" and inf.meta == (3, 2, (False,) * 3)
    assert_same_tree(j_dir, t_dir)
    eu = read_tiff(next((t_dir / "EU").glob("*.tif")))
    assert eu.mean() > 1e-4  # the members differ


def three_class_dir(root: Path) -> Path:
    """6 test images of 32 px, 3 raters, labels 0..2 and some pixels of the
    ignore label -1 in the first rater's masks."""
    rng = np.random.default_rng(11)
    (root / "preprocessed" / "images").mkdir(parents=True)
    (root / "preprocessed" / "labels").mkdir()
    ids = [f"tri_{i:02d}" for i in range(N_TEST)]
    yy, xx = np.mgrid[:HW, :HW]
    for i, image_id in enumerate(ids):
        np.save(root / "preprocessed" / "images" / f"{image_id}.npy",
                rng.random((HW, HW, 3)).astype(np.float32))
        for r in range(3):
            c = 8 + 4 * r + i
            mask = ((xx - c) ** 2 + (yy - 16) ** 2 < 60).astype(np.int32)
            mask[(yy > 20) & (xx > c)] = 2
            if r == 0:
                mask[:2, :5 + i] = -1
            np.save(root / "preprocessed" / "labels" / f"{image_id}_{r:02d}_mask.npy", mask)
    splits = root / "splits" / "default" / "firstCycle" / "splits.pkl"
    splits.parent.mkdir(parents=True)
    fold = {"id": [f"images/{i}.npy" for i in ids],
            "_meta": {"num_raters": 3, "dataset_name": "tri"}}
    splits.write_bytes(pickle.dumps([fold]))
    return root


def test_f_three_classes_with_multiclass_metrics(tmp_path, monkeypatch, inject_draws):
    data = three_class_dir(tmp_path / "tri")
    cfg = j_config(data, eu="dropout", extra=["data.num_classes=3"])
    src, dst = checkpoint_pair(tmp_path / "ckpt", "v0", cfg,
                               {"params": random_variables(cfg, 4)})
    monkeypatch.setattr(j_runner_mod, "ResultsWriter",
                        functools.partial(JResultsWriter, palette=GRAY))
    kw = dict(n_pred=1, n_models=2, tta=True, seed=6)
    j_dir = run_jax([src], tmp_path / "jax", intercept=True, **kw)
    t_dir, inf = run_port([dst], tmp_path / "port", **kw)
    assert inf.built.num_classes == 3
    assert_same_tree(j_dir, t_dir)
    preds = np.stack([read_png(p) for p in (t_dir / "pred_seg").glob("*.png")])
    assert set(np.unique(preds)) <= {0, 1, 2} and len(np.unique(preds)) > 1
    assert read_png(next((t_dir / "pred_seg").glob("*_mean.png")), with_palette=True)[1] == GRAY
    likelihood = json.loads((t_dir / "likelihood.json").read_text())
    assert all(len(r["gt_model_NLL"]) == 3 for r in likelihood.values())


def test_dataset_and_the_padded_loader_equal_jax(toy_dir):
    """The ``id`` split through both datasets and both unshuffled loaders
    that keep the tail: the same arrays, ids, labels, rater counts and
    ``valid`` mask in every batch; one rater drawn from the same numpy
    generator; a fold past the last raises."""
    from diffuncertainty_tpu.data.dataset import MultiRaterDataset as JDataset
    from diffuncertainty_tpu.data.loader import BatchLoader as JLoader
    from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset
    from diffuncertainty_tpu_torch.data.loader import BatchLoader

    splits = toy_dir / "splits" / "default" / "firstCycle" / "splits.pkl"
    ref, got = JDataset(splits, toy_dir, split="id"), MultiRaterDataset(splits, toy_dir, split="id")
    assert (got.image_ids, got.num_raters, got.dataset_label) == (
        ref.image_ids, ref.num_raters, ref.dataset_label)
    batches = list(BatchLoader(got, BATCH, drop_last=False))
    ref_batches = list(JLoader(ref, BATCH, shuffle=False, drop_last=False))
    assert len(batches) == len(ref_batches) == 2
    for b, r in zip(batches, ref_batches):
        assert set(b) == set(r)
        for k in b:
            if isinstance(b[k], list):
                assert b[k] == r[k], k
            else:
                assert b[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(b[k], r[k], err_msg=k)
    assert batches[1]["valid"].tolist() == [True, True, False, False]
    assert len(list(BatchLoader(got, BATCH))) == 1  # drop_last keeps full batches only
    one = MultiRaterDataset(splits, toy_dir, split="id", return_all_raters=False)
    ref_one = JDataset(splits, toy_dir, split="id", return_all_raters=False)
    for i in range(N_TEST):
        np.testing.assert_array_equal(one.load(i, np.random.default_rng(i))["seg"],
                                      ref_one.load(i, np.random.default_rng(i))["seg"])
    with pytest.raises(ValueError, match="fold 1"):
        MultiRaterDataset(splits, toy_dir, split="id", data_fold_id=1)


@pytest.mark.parametrize("binary", [True, False])
def test_g_padded_raters_leave_every_metric_as_the_real_ones(binary):
    """Raters padded past ``num_raters`` (all-zero masks) change none of the
    batch metrics, and the port's equal JAX's on both, to 1e-5."""
    rng = np.random.default_rng(0)
    c, g, s, b = (2, 2, 3, 2) if binary else (3, 2, 3, 2)
    groups = rng.random((g, s, b, 8, 8, c)).astype(np.float32)
    groups /= groups.sum(-1, keepdims=True)
    # image 1 predicts class 0 everywhere: against an all-zero padded rater
    # its Dice would be 1 (both empty), against its real raters it is not
    groups[:, :, 1] = [0.8, 0.2] if binary else [0.6, 0.2, 0.2]
    gm, mean = groups.mean(1), groups.mean((0, 1))
    gt_real = rng.integers(0, c, (b, 3, 8, 8)).astype(np.int32)
    gt_real[0, 0, :2] = -1  # ignored pixels in one rater
    num_raters = np.array([3, 2], np.int32)  # image 1 has two raters: its third is padding
    gt_real[1, 2] = 0
    gt_padded = np.concatenate([gt_real, np.zeros((b, 2, 8, 8), np.int32)], axis=1)
    meta = (g, s, (True, False))
    j_fn = j_make_bm(num_classes=c, ignore_index=-1, meta=JMeta(*meta))
    t_fn = make_batch_metrics(num_classes=c, ignore_index=-1, meta=SamplerMeta(*meta))
    j_stack = JStack(jnp.asarray(groups), jnp.asarray(gm), jnp.asarray(mean))
    t_stack = PredictionStack(torch.from_numpy(groups), torch.from_numpy(gm),
                              torch.from_numpy(mean))
    keys = ("dice", "ged", "ged_bma", "max_dice_pred", "max_dice_gt", "major_dice",
            "gt_NLL", "mean_NLL", "gen_NLL", "gt_model_NLL")
    results = {}
    for name, gt in (("real", gt_real), ("padded", gt_padded)):
        ref = j_fn(j_stack, jnp.asarray(gt), jnp.asarray(num_raters))
        got = t_fn(t_stack, torch.from_numpy(gt), torch.from_numpy(num_raters))
        for k in keys:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL,
                                       err_msg=f"{name} {k}")
        results[name] = got
    for k in keys:
        a, p = results["real"][k].numpy(), results["padded"][k].numpy()
        if k in ("gt_NLL", "gt_model_NLL"):
            p = p[:, :3]
        np.testing.assert_allclose(p, a, atol=1e-6, err_msg=k)


def test_h_use_ema_ema_only_skip_existing_and_metrics_only(softmax_pair, tmp_path):
    (src, dst), (src_ema, dst_ema) = softmax_pair
    kw = dict(n_pred=1, n_models=1, seed=9)
    j_dir = run_jax([src], tmp_path / "jax", use_ema=True, **kw)
    t_dir, _ = run_port([dst], tmp_path / "port", use_ema=True, **kw)
    assert t_dir.parent.name == "e3_ema"
    assert_same_tree(j_dir, t_dir)
    # an EMA-only snapshot runs its EMA weights without use_ema
    j_dir = run_jax([src_ema], tmp_path / "jax_ema_only", **kw)
    t_dir, _ = run_port([dst_ema], tmp_path / "port_ema_only", **kw)
    assert t_dir.parent.name == "e5"
    assert_same_tree(j_dir, t_dir)
    inf = UncertaintyInference([dst_ema], InferenceConfig(device="cpu"))
    inf.icfg.use_ema = True
    with pytest.raises(ValueError, match="no ema_params"):
        inf.pick_params({"params": {}})
    # metrics only: no PNG or TIFF, the same records
    j_dir = run_jax([src], tmp_path / "jax_m", save_outputs=False, **kw)
    t_dir, _ = run_port([dst], tmp_path / "port_m", save_outputs=False, **kw)
    assert sorted(p.name for p in t_dir.rglob("*") if p.is_file()) == [
        "likelihood.json", "metrics.json"]
    assert_same_tree(j_dir, t_dir)
    # skip_existing: the second run finds metrics.json and writes nothing
    inf = UncertaintyInference([dst], InferenceConfig(batch_size=BATCH, device="cpu",
                                                      save_dir=str(tmp_path / "port_m"),
                                                      skip_existing=True, **kw))
    assert inf.run_split("id") == {"skipped": True, "split": "id"}


def test_h_cli_jobs_and_the_cli_run_equal_jax(softmax_pair, tmp_path, monkeypatch):
    (src, dst), _ = softmax_pair
    monkeypatch.setenv("DU_COMPILE_CACHE", "")  # the JAX CLI keeps the suite's cache
    saves = tmp_path / "saves"
    for v in ("aug0_s1", "aug0_s2"):
        (saves / v / "checkpoints" / "last").mkdir(parents=True)
    pattern = str(saves / "*" / "checkpoints" / "last")
    for extra in ([], ["--ensemble_mode"], ["--ema_mode", "both"], ["--version", "v9"],
                  ["--ensemble_mode", "--ema_mode", "true", "--test_split", "id", "ood"]):
        argv = ["--checkpoint_paths", pattern, *extra]
        assert (t_cli.prepare_jobs(t_cli.build_parser().parse_args(argv))
                == j_cli.prepare_jobs(j_cli.build_parser().parse_args(argv)))
    with pytest.raises(FileNotFoundError):
        t_cli.expand_checkpoints([str(saves / "nothing*")])
    argv = ["--checkpoint_paths", None, "--n_pred", "1", "--n_models", "1", "--test_batch_size",
            str(BATCH), "--seed", "3"]
    argv[1] = str(src)
    j_cli.main(argv + ["--save_dir", str(tmp_path / "jax"), "--mesh_shape", "1", "1",
                       "--include_eval"])
    argv[1] = str(dst)
    (summary,) = t_cli.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu",
                                    "--include_eval"])
    assert summary["n_images"] == N_TEST and summary["version"] == "v0"
    rel = Path(summary["out_dir"]).relative_to(tmp_path / "port")
    assert_same_tree(tmp_path / "jax" / rel, tmp_path / "port" / rel)
    # --include_eval: the default chain's files, in the split and (the
    # thresholds) in the version directory, equal to the heatmaps' tolerance
    version = rel.parent
    evaluated = sorted(p.relative_to(tmp_path / "jax" / version)
                       for p in (tmp_path / "jax" / version).rglob("*.json")
                       if p.name not in ("metrics.json", "likelihood.json"))
    assert [p.as_posix() for p in evaluated] == [
        "id/aggregated_pred_entropy.json", "id/ambiguity_modeling.json", "id/area.json",
        "id/failure_detection.json", "quantile_analysis.json", "threshold_analysis.json"]
    assert sorted(p.relative_to(tmp_path / "port" / version)
                  for p in (tmp_path / "port" / version).rglob("*.json")
                  if p.name not in ("metrics.json", "likelihood.json")) == evaluated
    for name in evaluated:
        assert_json_close(*(json.loads((tmp_path / side / version / name).read_text())
                            for side in ("port", "jax")), str(name))
    # a (data, member) mesh must cover the process group's ranks: one here
    with pytest.raises(ValueError, match="covers every rank"):
        t_cli.main(argv + ["--mesh_shape", "2", "1", "--device", "cpu"])


def test_the_job_runs_on_the_card_by_default_and_never_falls_back(softmax_pair, monkeypatch):
    (_, dst), _ = softmax_pair
    assert InferenceConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        UncertaintyInference([dst], InferenceConfig())
    # member_chunk is ported: an int runs, a bad one raises; a mesh larger
    # than the process group (one rank here) raises
    assert UncertaintyInference([dst], InferenceConfig(member_chunk=1, device="cpu")
                                ).spec.member_chunk == 1
    with pytest.raises(ValueError, match="member_chunk"):
        UncertaintyInference([dst], InferenceConfig(member_chunk=0, device="cpu"))
    with pytest.raises(ValueError, match="covers every rank"):
        UncertaintyInference([dst], InferenceConfig(mesh_shape=(2, 1), device="cpu"))


@pytest.mark.parametrize("binary", [True, False])
def test_results_writer_async_output_equals_inline_byte_for_byte(tmp_path, binary):
    rng = np.random.default_rng(0)
    group_idx = rng.integers(0, 2 if binary else 5, (3, 16, 16)).astype(np.int64)
    mean_idx = group_idx[0]
    heatmaps = {k: rng.random((16, 16)).astype(np.float32) for k in ("TU", "AU", "EU")}
    outs = {}
    for tag, async_writes in (("inline", False), ("pooled", True)):
        w = ResultsWriter(tmp_path / tag, binary=binary, async_writes=async_writes)
        for j in range(4):
            w.save_prediction(f"img{j}", group_idx, mean_idx, group_idx[1] == 1)
            w.save_uncertainty(f"img{j}", heatmaps)
            w.add_metrics(f"img{j}", "toy", {"dice": 0.5 + j})
        w.flush()
        outs[tag] = {p.relative_to(tmp_path / tag): p.read_bytes()
                     for p in sorted((tmp_path / tag).rglob("*")) if p.is_file()}
    assert set(outs["inline"]) == set(outs["pooled"]) and len(outs["inline"]) == 4 * 7 + 1
    for rel, blob in outs["inline"].items():
        assert outs["pooled"][rel] == blob, f"{rel} differs"
    got = read_png(tmp_path / "inline" / "pred_seg" / "img0_02.png")
    want = np.where(group_idx[1] == 1, 0, group_idx[1])  # ignored pixels zeroed
    np.testing.assert_array_equal(got, (want > 0) * 255 if binary else want)


def test_results_writer_propagates_a_queued_write_failure(tmp_path, monkeypatch):
    w = ResultsWriter(tmp_path / "out", binary=True, async_writes=True)
    w._max_pending = 3  # a small queue, so the drain runs
    calls = {"n": 0}
    real_write = ResultsWriter._write_tif

    def flaky_write(unc_dir, image_id, arr):
        calls["n"] += 1
        if calls["n"] == 2:  # a failure that is not the oldest pending write
            raise OSError("disk full")
        real_write(unc_dir, image_id, arr)

    monkeypatch.setattr(t_results_mod.ResultsWriter, "_write_tif", staticmethod(flaky_write))
    with pytest.raises(OSError, match="disk full"):
        with w:
            for j in range(32):
                w.save_uncertainty(f"img{j:02d}", {"TU": np.zeros((4, 4), np.float32)})
    assert w._pool is None  # the error path shut the pool down
    assert not (tmp_path / "out" / "metrics.json").exists()


@pytest.mark.parametrize("shape", [(16, 16), (37, 41), (1, 300)])
def test_image_io_against_pil_both_ways(tmp_path, shape):
    """The port's files read by PIL, and PIL's read by the port, to the same
    arrays: grayscale and palette PNGs (PIL filters its grayscale rows and
    writes a short palette at 1, 2 or 4 bits), float32 TIFFs (PIL writes
    several strips past 64 KiB)."""
    rng = np.random.default_rng(sum(shape))
    smooth = (np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256).astype(np.uint8)
    for image in (smooth, (rng.random(shape) * 256).astype(np.uint8),
                  (rng.random(shape) > 0.5).astype(np.uint8) * 255):
        Image.fromarray(image, mode="L").save(tmp_path / "pil.png", compress_level=1)
        np.testing.assert_array_equal(read_png(tmp_path / "pil.png"), image)
        write_png(tmp_path / "port.png", image)
        with Image.open(tmp_path / "port.png") as im:
            assert im.mode == "L"
            np.testing.assert_array_equal(np.asarray(im), image)
        palette = [int(v) for v in rng.integers(0, 256, 768)]
        write_png(tmp_path / "port_p.png", image, palette, mode="P")
        with Image.open(tmp_path / "port_p.png") as im:
            assert im.mode == "P" and im.getpalette() == palette
            np.testing.assert_array_equal(np.asarray(im), image)
        for n in (2, 3, 5, 17, 256):
            labels = image if n == 256 else image % np.uint8(n)
            im = Image.fromarray(labels, mode="P")
            im.putpalette([int(v) for v in rng.integers(0, 256, 3 * n)])
            im.save(tmp_path / "pil_p.png", compress_level=1)
            got, pal = read_png(tmp_path / "pil_p.png", with_palette=True)
            np.testing.assert_array_equal(got, labels, err_msg=str(n))
            assert pal[:3 * n] == im.getpalette()[:3 * n]
    heat = rng.standard_normal((shape[0] * 8, shape[1] * 8)).astype(np.float32)
    Image.fromarray(heat, mode="F").save(tmp_path / "pil.tif")
    np.testing.assert_array_equal(read_tiff(tmp_path / "pil.tif"), heat)
    write_tiff(tmp_path / "port.tif", heat)
    with Image.open(tmp_path / "port.tif") as im:
        assert im.mode == "F"
        np.testing.assert_array_equal(np.asarray(im), heat)


def test_the_job_entry_point_runs_as_a_module_on_the_cpu(softmax_pair, tmp_path):
    """``python -m diffuncertainty_tpu_torch.infer --device cpu``: exit 0,
    one summary line, the tree of the in-process job."""
    (_, dst), _ = softmax_pair
    argv = ["--checkpoint_paths", str(dst), "--n_pred", "1", "--n_models", "1",
            "--test_batch_size", str(BATCH), "--device", "cpu", "--seed", "4"]
    out = subprocess.run([sys.executable, "-m", "diffuncertainty_tpu_torch.infer", *argv,
                          "--save_dir", str(tmp_path / "cli")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("{'split'")]
    t_cli.main(argv + ["--save_dir", str(tmp_path / "inproc")])
    rel = Path(ast.literal_eval(line)["out_dir"]).relative_to(tmp_path / "cli")
    for p in (tmp_path / "inproc" / rel).rglob("*"):
        if p.is_file():
            assert (tmp_path / "cli" / rel / p.relative_to(tmp_path / "inproc" / rel)
                    ).read_bytes() == p.read_bytes()
