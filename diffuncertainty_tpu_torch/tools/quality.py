"""Uncertainty quality on the deterministic toy-128 split (port of
``diffuncertainty_tpu/tools/quality.py``).

Runs a sampler over the toy ``id`` test split (256 images, generated on the
host from seed 1234 into the temp directory) and reports Dice / BMA-GED /
AURC / ECE: Dice of the mean prediction against the raters, GED over the
group means, AURC of risk = 1 - Dice against confidence = -mean TU, and the
pixel ECE of the mean prediction against the rater majority.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from ..data.augment import normalize_batch
from ..data.dataset import MultiRaterDataset
from ..data.loader import BatchLoader
from ..data.toy import generate_toy_dataset
from ..evaln.tasks import calc_ece
from ..infer.batch_metrics import make_batch_metrics
from ..metrics.aurc import aurc
from ..ops.entropy import uncertainty_heatmaps


def toy128_dataset(hw: int = 128) -> MultiRaterDataset:
    """The toy ``id`` split the quality numbers are measured on."""
    toy = generate_toy_dataset(
        Path(tempfile.gettempdir()) / f"diffuncertainty_torch_toy{hw}",
        num_train=128, num_val=16, num_test=256, num_ood=16, num_raters=4, size=hw, seed=1234,
    )
    splits = toy / "splits" / "default" / "firstCycle" / "splits.pkl"
    return MultiRaterDataset(splits, toy, split="id", num_raters=4)


def toy128_quality_eval(built, sampler, data_cfg, *, batch: int = 16, hw: int = 128,
                        device: str | torch.device = "cuda",
                        num_images: int | None = None, seed_base: int = 777) -> dict:
    """Dice/GED/AURC/ECE of ``sampler`` on the toy-128 id split.

    ``data_cfg``: the model's data config; its augmentation mean/std
    normalize the inputs. ``num_images``: score only the first images of the
    split. The test cases are drawn in order after the train and val cases,
    so the first 32 are the whole 32-image split the JAX package measured
    its round-2 and round-3 numbers on (256 images since round 4).
    Batch ``bi`` draws from a generator seeded ``seed_base + bi``.
    """
    device = torch.device(device)
    loader = BatchLoader(toy128_dataset(hw), batch)
    bm = make_batch_metrics(num_classes=built.num_classes, ignore_index=None, compute_ged=False,
                            compute_likelihood=False)
    aug = data_cfg.augmentations
    dices, geds, tu_means, eces = [], [], [], []
    for bi, b in enumerate(loader):
        if num_images is not None and bi * batch >= num_images:
            break
        images = normalize_batch(torch.from_numpy(b["image"]).to(device), aug.mean, aug.std)
        gt = torch.from_numpy(b["seg"]).to(device)
        gen = torch.Generator(device).manual_seed(seed_base + bi)
        stack = sampler(images, gen)
        out = bm(stack, gt)
        dices.extend(out["dice"].tolist())
        geds.extend(out["ged_bma"].tolist())
        maps = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)
        tu_means.extend(maps["TU"].mean(dim=(1, 2)).tolist())
        mean = stack.mean.float().cpu().numpy()
        majority = (b["seg"].mean(axis=1) >= 0.5).astype(np.int64)
        correct = (mean.argmax(-1) == majority).reshape(-1)
        eces.append(calc_ece(correct, mean.max(-1).reshape(-1)))
    risks = 1.0 - np.asarray(dices)
    return {
        "dice": float(np.mean(dices)),
        "ged_bma": float(np.mean(geds)),
        "aurc": float(aurc(risks, -np.asarray(tu_means))),
        "ece": float(np.mean(eces)),
    }
