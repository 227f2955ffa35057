"""Multi-class full-frame quality (port of
``diffuncertainty_tpu/tools/multiclass_quality.py``).

The loop of the reference's GTA/Cityscapes evaluation
(``evaluation/utils/gta.py:15-45``, multiclass GED ``test_2D.py:901-918``) on
the synthetic street-scene toy (``data/gta_toy.py``):

- MC-dropout members through sliding-window full-frame inference
  (``infer/sliding_window.py``); members run one after another, each on the
  whole tile stack with its own dropout draws;
- macro Dice of the member-mean argmax against switched reference raters;
- multiclass GED of the members' argmax maps against those references;
- NCC of the TU and AU heatmaps against the analytic label-switch variance
  map (``cityscapes_labels.gt_switch_uncertainty_map``);
- the palette-PNG path of the results tree: the first frame's mean
  prediction written with the label palette by ``infer/results.py`` and read
  back losslessly (``palette_png_roundtrip``).

``bench.py``'s ``full_frame_multiclass`` family runs it with the trained
asset ``assets/bench_unet16_gtatoy_multiclass.npz``.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..data import cityscapes_labels as cs
from ..data.augment import normalize_batch
from ..data.augment_extra import stochastic_label_switches
from ..data.dataset import MultiRaterDataset
from ..data.gta_toy import generate_gta_toy
from ..evaln.tasks import compute_ncc
from ..infer.image_io import read_png
from ..infer.results import ResultsWriter
from ..infer.sliding_window import sliding_window_predict
from ..metrics.dice import dice_multiclass_macro
from ..metrics.ged import ged_multiclass


def member_sliding_window_fn(module, *, window: int, stride: int, members: int):
    """``fn(images (B,H,W,3), generator) -> (M, B, H, W, C)`` stitched softmax.

    Each member is one forward of the whole tile stack with fresh dropout
    draws from ``generator``; members run one after another, as the JAX
    ``lax.map(..., batch_size=1)`` does (a vmap over members would multiply
    the stitch's workspace by M)."""

    def apply_fn(tiles, generator):
        return torch.softmax(module(tiles, generator).logits, dim=-1)

    @torch.no_grad()
    def fn(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return torch.stack([
            sliding_window_predict(lambda t: apply_fn(t, generator), images, window=window,
                                   stride=stride)
            for _ in range(members)])

    return fn


def default_data_dir() -> Path:
    return Path(tempfile.gettempdir()) / "diffuncertainty_torch_gtatoy"


def gta_toy_frames(frames: int, frame_size: tuple[int, int], window: int, seed: int,
                   data_dir: str | Path | None = None):
    """(images (F,H,W,3) float32, masks (F,H,W) uint8) of the gta-toy test
    split, generated under ``data_dir`` (default: the temp directory)."""
    data_dir = Path(data_dir or default_data_dir())
    toy = generate_gta_toy(data_dir, num_train=48, num_val=8, num_test=frames,
                           train_size=(window, window), test_size=frame_size, seed=seed)
    ds = MultiRaterDataset(toy / "splits" / "default" / "firstCycle" / "splits.pkl", toy,
                           split="id")
    images = np.stack([ds.load(i)["image"] for i in range(len(ds))])
    masks = np.stack([np.load(ds.label_paths[i][0]) for i in range(len(ds))])
    return images, masks


def gta_toy_quality_eval(
    built,
    data_cfg,
    *,
    frames: int = 8,
    frame_size: tuple[int, int] = (256, 512),
    window: int = 128,
    stride: int = 64,
    members: int = 8,
    n_references: int = 4,
    data_dir: str | Path | None = None,
    seed: int = 1234,
    timing_reps: int = 3,
    device: str | torch.device = "cuda",
    log=None,
) -> dict:
    """Quality and throughput of multi-class sliding-window inference with
    ``built`` (a softmax model with MC-dropout) on ``device``.

    The stack is drawn from a generator seeded ``seed``, the timed calls
    from seeds ``0..timing_reps-1``; the references from
    ``np.random.default_rng(seed)``, frame after frame."""
    device = torch.device(device)
    images, masks = gta_toy_frames(frames, frame_size, window, seed, data_dir)
    n_classes = built.num_classes
    aug = data_cfg.augmentations
    fn = member_sliding_window_fn(built.module, window=window, stride=stride, members=members)
    x = normalize_batch(torch.from_numpy(images).to(device), aug.mean, aug.std)

    stack = fn(x, torch.Generator(device).manual_seed(seed)).float()  # (M,B,H,W,C)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(timing_reps):
        fn(x, torch.Generator(device).manual_seed(i))
    if device.type == "cuda":
        torch.cuda.synchronize()
    frames_per_sec = frames * timing_reps / (time.perf_counter() - t0)

    eps = 1e-12
    mean_probs = stack.mean(dim=0)
    pred_idx = mean_probs.argmax(dim=-1)
    tu = (-(mean_probs * torch.log(mean_probs + eps)).sum(-1)).cpu().numpy()
    au = (-(stack * torch.log(stack + eps)).sum(-1).mean(0)).cpu().numpy()

    dices, geds, ncc_tu, ncc_au = [], [], [], []
    rng = np.random.default_rng(seed)
    for b in range(frames):
        refs = stochastic_label_switches(masks[b], rng, n_references, cs.GT_SWITCH_PROBS)
        refs = torch.from_numpy(refs.astype(np.int64)).to(device)
        dices.append(float(dice_multiclass_macro(pred_idx[b].expand_as(refs), refs, n_classes,
                                                 include_background=True).mean()))
        probs_m = F.one_hot(stack[:, b].argmax(dim=-1), n_classes).float()
        geds.append(float(ged_multiclass(probs_m, refs, n_classes, ignore_index=None)["ged"]))
        analytic = cs.gt_switch_uncertainty_map(masks[b])
        ncc_tu.append(compute_ncc(analytic, tu[b]))
        ncc_au.append(compute_ncc(analytic, au[b]))

    # palette-PNG path: write the mean prediction, read it back losslessly
    out_dir = Path(data_dir or default_data_dir()) / "palette_check"
    frame0 = pred_idx[0].cpu().numpy()
    with ResultsWriter(out_dir, binary=False, palette=cs.palette()) as writer:
        writer.save_prediction("frame0", frame0[None], frame0)
    readback, palette = read_png(out_dir / "pred_seg" / "frame0_01.png", with_palette=True)
    palette_roundtrip = bool(np.array_equal(readback, frame0.astype(np.uint8))
                             and palette == list(cs.palette()))

    result = {
        "dice_macro": float(np.mean(dices)),
        "ged_multiclass": float(np.mean(geds)),
        "ncc_tu_vs_analytic": float(np.mean(ncc_tu)),
        "ncc_au_vs_analytic": float(np.mean(ncc_au)),
        "palette_png_roundtrip": palette_roundtrip,
        "frames_per_sec": frames_per_sec,
        "frame_size": list(frame_size),
        "window": window,
        "stride": stride,
        "members": members,
        "n_references": n_references,
    }
    if log:
        log(f"multiclass: {result}")
    return result
