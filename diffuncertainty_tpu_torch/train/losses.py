"""Training losses (port of ``diffuncertainty_tpu/train/losses.py``), one per
AU type. A multi-rater target (B, R, H, W) trains on one rater per element,
drawn by :func:`draw_rater`.

- softmax: masked cross entropy when ``ignore_index != 0``, else the soft
  Dice of the softmax plus cross entropy (``lightning_experiment.py:646-661``
  of the reference);
- ssn: the Monte-Carlo log-likelihood: ``n_aleatoric_samples``
  reparameterized draws of the low-rank normal over the logits
  (``models/ssn.py::sample_n``), each draw's summed log-probability of the
  target, logsumexp over the draws minus log S, the mean over the batch;
  ``ssn_mean_only`` (the pretraining epochs) runs without the factor head;
- diffusion: the one-hot target with the ignored pixels zeroed and a
  ``loss_mask`` over the valid ones, through ``train_loss_step``;
- prob_unet: the posterior latent of the image and its one-hot target,
  decoded, the negative ELBO with the schedule's beta, plus
  ``regularizer_coeff`` times the squared L2 norm of the ``prior``,
  ``posterior`` and ``fcomb`` parameters.

The HRNet (softmax and SSN; the factory refuses the other families) runs
its forward in train mode: every BatchNorm normalizes by the batch's
statistics, and ``aux["model_state"]`` holds the running statistics after
the batch (``models/hrnet.py``), which the trainer commits after the step,
as the JAX losses return flax's updated ``batch_stats``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..metrics.dice import soft_dice_loss
from ..models import ssn as ssn_lib
from ..models.factory import BuiltModel
from ..models.prob_unet import elbo_loss, kl_diag_gaussians, sample_latent
from ..parallel.mesh import all_reduce_sum, draw_rows


def global_count(count: torch.Tensor, group) -> torch.Tensor:
    """A count of this rank's rows as the rank's share of the data-parallel
    global batch's: the global count over the group's size (``count`` itself
    without a group), so that the mean of the ranks' ``sum / share`` is the
    global batch's mean."""
    if group is None:
        return count
    return all_reduce_sum(count.detach(), group) / dist.get_world_size(group)


def masked_ce(logits: torch.Tensor, target: torch.Tensor, ignore_index: int | None,
              group=None) -> torch.Tensor:
    """Cross entropy of NHWC logits against (B, H, W) targets, the mean over
    the pixels whose target is not ``ignore_index`` (over the data-parallel
    ``group``'s global batch: :func:`global_count`)."""
    c = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, target.long().clamp(0, c - 1)[..., None])[..., 0]
    if ignore_index is None:
        return -picked.mean()
    valid = (target != ignore_index).to(logits.dtype)
    return -(picked * valid).sum() / global_count(valid.sum(), group).clamp(min=1.0)


def draw_rater(batch: int, raters: int, generator: torch.Generator) -> torch.Tensor:
    """(B,) rater indices, uniform in [0, raters), on the generator's device
    (per row: ``draw_rows``)."""
    return draw_rows(lambda n, g: torch.randint(0, raters, (n,), generator=g, device=g.device),
                     batch, generator)


def select_random_rater(seg: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B, R, H, W) -> (B, H, W): one random rater per element; (B, H, W)
    passes through."""
    if seg.ndim == 3:
        return seg
    idx = draw_rater(seg.shape[0], seg.shape[1], generator).to(seg.device)
    return seg[torch.arange(seg.shape[0], device=seg.device), idx]


def make_loss_fn(built: BuiltModel, *, ignore_index: int = -1, n_aleatoric_samples: int = 10,
                 ssn_mean_only: bool = False, data_group=None) -> Callable:
    """``loss_fn(module, batch, generator, sched=None) -> (loss, aux)``:
    ``batch`` holds ``image`` (B, H, W, C) preprocessed inputs and ``seg``
    (B, H, W) or (B, R, H, W) labels; ``module`` is ``built.module`` or a
    module of its architecture; every draw (dropout masks, the rater, the
    family's own) comes from ``generator``. ``sched`` holds the epoch's
    ``beta`` (prob-U-Net; the spec's ``beta`` when absent).

    ``data_group``: the process group a data-parallel step averages its
    gradients over; a loss normalized by a count of valid pixels then
    divides by the rank's share of the global batch's count, so that the
    mean of the ranks' losses is the loss of the global batch."""
    au = built.au_type
    num_classes = built.num_classes
    # the reference's convention: ignore_index 0 means "no ignore" (and the
    # softmax family adds Dice)
    use_ignore = ignore_index != 0
    ce_ignore = ignore_index if use_ignore else None
    # the HRNet trains on batch statistics (flax's train=True)
    train_kw = {"train": True} if built.backbone == "hrnet" else {}

    def with_stats(aux: dict, out) -> dict:
        if out.batch_stats is not None:
            aux["model_state"] = out.batch_stats
        return aux

    if au == "softmax":

        def loss_fn(module, batch: dict, generator: torch.Generator, sched=None):
            out = module(batch["image"], generator, **train_kw)
            logits = out.logits
            target = select_random_rater(batch["seg"], generator)
            if use_ignore:
                loss = masked_ce(logits, target, ignore_index, data_group)
            else:
                loss = (soft_dice_loss(torch.softmax(logits, dim=-1), target)
                        + masked_ce(logits, target, None))
            return loss, with_stats({"loss": loss}, out)

    elif au == "ssn":
        s = n_aleatoric_samples

        def loss_fn(module, batch: dict, generator: torch.Generator, sched=None):
            target = select_random_rater(batch["seg"], generator)
            out = module(batch["image"], generator, mean_only=ssn_mean_only, **train_kw)
            dist = ssn_lib.build_distribution(out.ssn_mean, out.ssn_cov_diag, out.ssn_cov_factor)
            b, h, w, c = out.logits.shape
            logp = F.log_softmax(ssn_lib.sample_n(dist, generator, s).reshape(s, b, h, w, c),
                                 dim=-1)
            index = target.long().clamp(0, c - 1)[None, ..., None].expand(s, b, h, w, 1)
            picked = logp.gather(-1, index)[..., 0]
            if use_ignore:
                picked = picked * (target != ce_ignore).to(picked.dtype)[None]
            per_sample_logprob = picked.sum(dim=(2, 3))  # (S, B)
            loss = -(torch.logsumexp(per_sample_logprob, dim=0) - math.log(s)).mean()
            return loss, with_stats({"loss": loss, "cov_failed": dist.cov_failed.float().mean()},
                                    out)

    elif au == "diffusion":

        def loss_fn(module, batch: dict, generator: torch.Generator, sched=None):
            images = batch["image"]
            target = select_random_rater(batch["seg"], generator)
            ignore_mask = (target == ce_ignore) if use_ignore else torch.zeros_like(
                target, dtype=torch.bool)
            safe_target = torch.where(ignore_mask, torch.zeros_like(target), target)
            one_hot = F.one_hot(safe_target.long(), num_classes).to(images.dtype)
            loss_mask = (~ignore_mask).to(one_hot.dtype)[..., None].expand(one_hot.shape)
            one_hot = one_hot * loss_mask

            def model_fn(x_with_im, t):
                return module(x_with_im, generator, timesteps=t).logits

            loss, _ = built.diffusion.train_loss_step(
                model_fn, one_hot, images, generator,
                loss_mask=loss_mask if use_ignore else None)
            return loss, {"loss": loss}

    elif au == "prob_unet":
        spec = built.prob_unet_spec

        def loss_fn(module, batch: dict, generator: torch.Generator, sched=None):
            images = batch["image"]
            target = select_random_rater(batch["seg"], generator)
            safe_target = target
            if use_ignore:
                safe_target = torch.where(target == ce_ignore, torch.zeros_like(target), target)
            segm = F.one_hot(safe_target.long(), num_classes).to(images.dtype)
            if use_ignore:
                segm = segm * (target != ce_ignore).to(segm.dtype)[..., None]
            out = module(images, segm, generator=generator)
            logits = module.decode(out.features, sample_latent(out.posterior, generator))
            kl = kl_diag_gaussians(out.posterior, out.prior)
            beta = (sched or {}).get("beta", spec.beta)
            neg_elbo, recon, mean_kl = elbo_loss(logits, target, kl, beta, ignore_index=ce_ignore,
                                                 count=lambda c: global_count(c, data_group))
            # the L2 regularizer of the reference over the latent nets and the fcomb
            reg = sum((p ** 2).sum() for name, p in module.named_parameters()
                      if name.split(".", 1)[0] in ("prior", "posterior", "fcomb"))
            loss = neg_elbo + spec.regularizer_coeff * reg
            return loss, {"loss": loss, "recon": recon, "kl": mean_kl}

    else:
        raise ValueError(au)

    return loss_fn
