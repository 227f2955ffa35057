"""Training losses (port of ``diffuncertainty_tpu/train/losses.py``), the
softmax family: masked cross entropy when ``ignore_index != 0``, else the
soft Dice of the softmax plus cross entropy (``lightning_experiment.py:646-661``
of the reference). A multi-rater target (B, R, H, W) trains on one rater per
element, drawn by :func:`draw_rater`.

The SSN, diffusion and prob-U-Net losses and the HRNet's ``batch_stats``
updates are not ported: ``make_loss_fn`` raises for them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..metrics.dice import soft_dice_loss
from ..models.factory import BuiltModel

# the ROADMAP Queue 1 item 5 entry that takes each unported loss
UNPORTED = {
    "diffusion": "the diffusion losses and schedules (ROADMAP Queue 1 item 5, first)",
    "ssn": "the SSN loss (ROADMAP Queue 1 item 5, second)",
    "prob_unet": "the prob-U-Net elbo_loss (ROADMAP Queue 1 item 5, third)",
}


def masked_ce(logits: torch.Tensor, target: torch.Tensor, ignore_index: int | None) -> torch.Tensor:
    """Cross entropy of NHWC logits against (B, H, W) targets, the mean over
    the pixels whose target is not ``ignore_index``."""
    c = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, target.long().clamp(0, c - 1)[..., None])[..., 0]
    if ignore_index is None:
        return -picked.mean()
    valid = (target != ignore_index).to(logits.dtype)
    return -(picked * valid).sum() / valid.sum().clamp(min=1.0)


def draw_rater(batch: int, raters: int, generator: torch.Generator) -> torch.Tensor:
    """(B,) rater indices, uniform in [0, raters), on the generator's device."""
    return torch.randint(0, raters, (batch,), generator=generator, device=generator.device)


def select_random_rater(seg: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B, R, H, W) -> (B, H, W): one random rater per element; (B, H, W)
    passes through."""
    if seg.ndim == 3:
        return seg
    idx = draw_rater(seg.shape[0], seg.shape[1], generator).to(seg.device)
    return seg[torch.arange(seg.shape[0], device=seg.device), idx]


def make_loss_fn(built: BuiltModel, *, ignore_index: int = -1) -> Callable:
    """``loss_fn(module, batch, generator) -> (loss, aux)``: ``batch`` holds
    ``image`` (B, H, W, C) preprocessed inputs and ``seg`` (B, H, W) or
    (B, R, H, W) labels; ``module`` is ``built.module`` or a module of its
    architecture; dropout masks and the rater come from ``generator``."""
    if built.au_type in UNPORTED:
        raise NotImplementedError(f"training au_type={built.au_type!r}: "
                                  f"{UNPORTED[built.au_type]} is not ported")
    if built.au_type != "softmax":
        raise ValueError(built.au_type)
    if built.backbone == "hrnet":
        raise NotImplementedError("training the HRNet (its batch_stats updates) is not ported "
                                  "(ROADMAP Queue 1 item 5, fourth)")
    # the reference's convention: ignore_index 0 means "no ignore" and adds Dice
    use_ignore = ignore_index != 0

    def loss_fn(module, batch: dict, generator: torch.Generator):
        logits = module(batch["image"], generator).logits
        target = select_random_rater(batch["seg"], generator)
        if use_ignore:
            loss = masked_ce(logits, target, ignore_index)
        else:
            loss = (soft_dice_loss(torch.softmax(logits, dim=-1), target)
                    + masked_ce(logits, target, None))
        return loss, {"loss": loss}

    return loss_fn
