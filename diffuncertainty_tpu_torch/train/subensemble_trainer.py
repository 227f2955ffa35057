"""Sub-ensemble mask trainer (port of
``diffuncertainty_tpu/train/subensemble_trainer.py``; the reference's
``extract_sub_ensemble.py:487-800``).

Over a trained network whose weights stay frozen, learn ``num_masks``
binary channel masks (``models/subensemble.py``): each step draws every
member's Gumbel-relaxed masks at the step's temperature (annealed
geometrically from ``temp_start`` to ``temp_end`` over the steps), runs the
member's forward with its soft-masked weights (``torch.func.functional_call``,
so the gradient reaches the mask logits through both hand-written kernels'
autograd Functions), and minimizes the mean over members of the task cross
entropy plus ``diversity_coeff`` times the soft mean pairwise IoU and
``size_coeff`` times the size penalty, by Adam with optax's math (b1 0.9,
b2 0.999, eps 1e-8, no clip, no decay). Members run one after another, as
the JAX loop does; each member's backward runs before the next member's
forward, so only one member's activations are held at a time.

Draws come from one generator seeded ``seed`` on the weights' device: per
step and member, the Gumbel noise of every layer (in the state's order, the
in side then the out side), then, for multi-rater targets, the rater.
Batches are used as given (no normalization or augmentation), cycled over
the steps. ``materialize_for_inference`` gives the hard members as the (M,
...) stack the sampler's ``params_stack`` mode takes
(``make_sampler(built, spec, members=stack)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from ..models import subensemble as se
from ..models.factory import BuiltModel
from .loop import adam_
from .losses import masked_ce, select_random_rater

State = dict[str, torch.Tensor]


@dataclasses.dataclass
class SubensembleConfig:
    num_masks: int = 10
    steps: int = 200
    learning_rate: float = 1e-2
    temp_start: float = 2.0
    temp_end: float = 0.3
    diversity_coeff: float = 1.0
    size_coeff: float = 1.0
    target_fraction: float = 0.5
    rows_only: bool = False
    normalize: bool = True
    ignore_index: int = -1
    seed: int = 0


def temperature(cfg: SubensembleConfig, step: int) -> float:
    """The Gumbel temperature of ``step`` (float32, as the JAX loop hands it
    to its step)."""
    frac = step / max(cfg.steps - 1, 1)
    return float(np.float32(cfg.temp_start * (cfg.temp_end / cfg.temp_start) ** frac))


def train_subensemble_masks(built: BuiltModel, params: State, batches: list[dict],
                            cfg: SubensembleConfig, *, history: list | None = None) -> dict:
    """Mask logits ``{layer: {"in": (M, C_in), "out": (M, C_out)}}`` learned
    over the frozen state dict ``params`` of ``built.module`` (softmax
    family); ``batches``: {'image', 'seg'} dicts (numpy or tensors) cycled
    over ``cfg.steps`` steps. ``history``, if given, receives each step's
    ``{"loss", "task", "iou", "size", "temp"}`` (floats)."""
    if built.au_type != "softmax":
        raise NotImplementedError("sub-ensemble mask training supports softmax models")
    module = built.module
    device = next(iter(params.values())).device
    base = {k: v.detach() for k, v in params.items()}
    masks = {layer: {side: v.to(device).requires_grad_(True) for side, v in sides.items()}
             for layer, sides in se.init_mask_logits(base, cfg.num_masks).items()}
    leaves = [masks[layer][side] for layer in masks for side in ("in", "out")]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    ce_ignore = cfg.ignore_index if cfg.ignore_index != 0 else None
    generator = torch.Generator(device).manual_seed(cfg.seed)
    for i in range(cfg.steps):
        temp = temperature(cfg, i)
        batch = batches[i % len(batches)]
        images = torch.as_tensor(batch["image"]).to(device)
        seg = torch.as_tensor(batch["seg"]).to(device)
        grads = [torch.zeros_like(p) for p in leaves]
        task = 0.0
        for m in range(cfg.num_masks):
            soft = se.masked_params(base, masks, m, hard=False, generator=generator, temp=temp,
                                    rows_only=cfg.rows_only, normalize=cfg.normalize)
            logits = functional_call(module, soft, (images, generator)).logits
            target = select_random_rater(seg, generator)
            loss_m = masked_ce(logits, target, ce_ignore) / cfg.num_masks
            g = torch.autograd.grad(loss_m, leaves, allow_unused=True)
            torch._foreach_add_(grads, [torch.zeros_like(p) if gi is None else gi
                                        for p, gi in zip(leaves, g)])
            task += loss_m.item()
        div = se.mean_pairwise_iou(masks, hard=False, rows_only=cfg.rows_only)
        size = se.submodel_size_penalty(masks, cfg.target_fraction, rows_only=cfg.rows_only)
        reg = cfg.diversity_coeff * div + cfg.size_coeff * size
        torch._foreach_add_(grads, torch.autograd.grad(reg, leaves))
        adam_(leaves, grads, mu, nu, i + 1, cfg.learning_rate)
        if history is not None:
            history.append({"loss": task + reg.item(), "task": task, "iou": div.item(),
                            "size": size.item(), "temp": temp})
    return {layer: {side: v.detach() for side, v in sides.items()}
            for layer, sides in masks.items()}


def materialize_for_inference(params: State, masks: dict, num_masks: int,
                              rows_only: bool = False, normalize: bool = True) -> State:
    """The (M, ...) member stack of the hard masks, for the ``params_stack``
    sampler."""
    return se.materialize_members(params, masks, num_masks, rows_only=rows_only,
                                  normalize=normalize)
