"""Masked sub-ensembles at inference: M binary channel masks over one trained
network (the hard half of ``diffuncertainty_tpu/models/subensemble.py``).

Masks are mask logits beside the state dict, one ``{"in": (M, C_in), "out":
(M, C_out)}`` pair per maskable layer, keyed by the layer's module path
(``a.b``; ``jax_mask_keys`` maps the JAX package's ``a/b`` keys). A layer is
maskable when its weight has rank 2 (dense, (O, I)) or 4 (conv, OIHW), which
leaves GroupNorm out. A hard mask keeps the channels whose logit is >= 0: the
in-channel mask scales axis 1 of the weight, the out-channel mask axis 0 and
the bias; with ``normalize`` each mask also rescales by
``1 / max(mean(mask), 1e-6)``. ``rows_only`` keeps every in-channel.
``materialize_members`` stacks the M masked copies into the (M, ...) state
dict of the sampler's ``params_stack`` mode. The Gumbel relaxation and the
mask-training objectives belong to training and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

State = dict[str, torch.Tensor]


def _maskable_layers(state: State) -> dict[str, torch.Tensor]:
    """{layer path: weight} for every dense or conv weight."""
    return {k[: -len(".weight")]: v for k, v in state.items()
            if k.endswith(".weight") and v.ndim in (2, 4)}


def jax_mask_keys(mask_logits: dict) -> dict:
    """JAX mask logits (layer keys ``a/b``) -> the port's (``a.b``)."""
    return {k.replace("/", "."): v for k, v in mask_logits.items()}


def init_mask_logits(state: State, num_masks: int) -> dict:
    """Zero mask logits (the reference's ``use_zero_init``) for every
    maskable layer."""
    return {layer: {"in": torch.zeros((num_masks, w.shape[1]), dtype=torch.float32),
                    "out": torch.zeros((num_masks, w.shape[0]), dtype=torch.float32)}
            for layer, w in _maskable_layers(state).items()}


def _rescale(mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return 1.0 / torch.clamp(mask.float().mean(), min=eps)


def masked_params(state: State, mask_logits: dict, member: int, *, hard: bool = True,
                  rows_only: bool = False, normalize: bool = True) -> State:
    """``state`` with member ``member``'s hard masks applied to every layer
    that has mask logits."""
    if not hard:
        raise NotImplementedError("the Gumbel-softmax (soft) masks are not ported")
    out = dict(state)
    for layer, weight in _maskable_layers(state).items():
        if layer not in mask_logits:
            continue
        in_l = torch.as_tensor(mask_logits[layer]["in"][member], device=weight.device)
        out_l = torch.as_tensor(mask_logits[layer]["out"][member], device=weight.device)
        in_m = torch.ones_like(in_l) if rows_only else (in_l >= 0.0).to(in_l.dtype)
        out_m = (out_l >= 0.0).to(out_l.dtype)
        tail = (1,) * (weight.ndim - 2)
        masked = weight * in_m.reshape((1, -1) + tail) * out_m.reshape((-1, 1) + tail)
        if normalize:
            masked = masked * (_rescale(in_m) * _rescale(out_m))
        out[f"{layer}.weight"] = masked.to(weight.dtype)
        bias = state.get(f"{layer}.bias")
        if bias is not None:
            bias = bias * out_m
            if normalize:
                bias = bias * _rescale(out_m)
            out[f"{layer}.bias"] = bias.to(state[f"{layer}.bias"].dtype)
    return out


def materialize_members(state: State, mask_logits: dict, num_masks: int, *,
                        rows_only: bool = False, normalize: bool = True) -> State:
    """(M, ...) stacked member state dict for the ``params_stack`` sampler."""
    members = [masked_params(state, mask_logits, m, rows_only=rows_only, normalize=normalize)
               for m in range(num_masks)]
    return {k: torch.stack([m[k] for m in members]) for k in state}


def _hard_binary_weights(mask_logits: dict, layer: str, rows_only: bool) -> np.ndarray:
    in_l, out_l = (torch.as_tensor(mask_logits[layer][side]).float().cpu().numpy()
                   for side in ("in", "out"))
    in_m = np.ones_like(in_l) if rows_only else (in_l >= 0).astype(np.float32)
    out_m = (out_l >= 0).astype(np.float32)
    return (out_m[:, :, None] * in_m[:, None, :]).reshape(in_l.shape[0], -1)


def compute_mask_stats(mask_logits: dict, *, rows_only: bool = False) -> dict:
    """Per-member fill fraction, mean fill and the pairwise hard-IoU matrix
    of the masks (the JAX ``compute_mask_stats``)."""
    total_active = None
    total_weights = 0
    inter_acc = union_acc = None
    for layer in mask_logits:
        w = _hard_binary_weights(mask_logits, layer, rows_only)
        active = w.sum(axis=1)
        total_active = active if total_active is None else total_active + active
        total_weights += w.shape[1]
        inter = w @ w.T
        sums = w.sum(axis=1, keepdims=True)
        union = sums + sums.T - inter
        inter_acc = inter if inter_acc is None else inter_acc + inter
        union_acc = union if union_acc is None else union_acc + union
    if total_active is None:
        return {"num_masks": 0}
    m = len(total_active)
    iou = inter_acc / np.maximum(union_acc, 1e-8)
    iu, ju = np.triu_indices(m, k=1)
    return {
        "num_masks": m,
        "fill_fraction_per_member": (total_active / total_weights).tolist(),
        "mean_fill_fraction": float(np.mean(total_active / total_weights)),
        "mean_pairwise_iou": float(iou[iu, ju].mean()) if m > 1 else 1.0,
        "pairwise_iou_matrix": iou.tolist(),
    }
