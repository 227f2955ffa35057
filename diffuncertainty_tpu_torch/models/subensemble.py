"""Masked sub-ensembles: M binary channel masks over one trained network
(port of ``diffuncertainty_tpu/models/subensemble.py``).

Masks are mask logits beside the state dict, one ``{"in": (M, C_in), "out":
(M, C_out)}`` pair per maskable layer, keyed by the layer's module path
(``a.b``; ``jax_mask_keys`` maps the JAX package's ``a/b`` keys). A layer is
maskable when its weight has rank 2 (dense, (O, I)) or 4 (conv, OIHW), which
leaves GroupNorm out. A hard mask keeps the channels whose logit is >= 0: the
in-channel mask scales axis 1 of the weight, the out-channel mask axis 0 and
the bias; with ``normalize`` each mask also rescales by
``1 / max(mean(mask), 1e-6)``. ``rows_only`` keeps every in-channel.
``materialize_members`` stacks the M masked copies into the (M, ...) state
dict of the sampler's ``params_stack`` mode.

Training (``train/subensemble_trainer.py``) takes the Gumbel-softmax
relaxation: ``masked_params(hard=False)`` draws, per layer and side, (2, C)
standard Gumbel noise ``g`` (:func:`draw_gumbel`, from an explicit
generator) and keeps ``softmax(([l, -l] + g) / temp)[0]`` of each channel
(the reference's ``masked_subensemble.py:38-47``). The objectives:
``mean_pairwise_iou`` (soft: ``sigmoid(2 l)`` channel weights, the outer
product of the out- and in-channel weights per layer, intersections and
unions summed over layers, the mean over member pairs) and
``submodel_size_penalty`` (per layer the mean over members of
``relu(expected fill - target)``, the mean over layers).
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


def draw_gumbel(layer: str, side: str, shape: tuple, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` for ``layer``'s ``side`` ("in" or
    "out") mask: ``-log(-log(u))``, u uniform in [tiny, 1) as
    ``jax.random.gumbel`` takes it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def _gumbel_binary(logits: torch.Tensor, noise: torch.Tensor, temp: float) -> torch.Tensor:
    z = torch.stack([logits, -logits]) + noise
    return torch.softmax(z / temp, dim=0)[0]


def masked_params(state: State, mask_logits: dict, member: int, *, hard: bool = True,
                  generator: torch.Generator | None = None, temp: float = 1.0,
                  rows_only: bool = False, normalize: bool = True) -> State:
    """``state`` with member ``member``'s masks applied to every layer that
    has mask logits: hard (logit >= 0), or with ``hard=False`` the Gumbel
    relaxation at ``temp`` (its noise from ``generator``, per layer the in
    side, then the out side), differentiable in the mask logits."""
    if not hard and generator is None:
        raise ValueError("soft masks draw Gumbel noise: pass a generator")
    out = dict(state)
    for layer, weight in _maskable_layers(state).items():
        if layer not in mask_logits:
            continue
        in_l = torch.as_tensor(mask_logits[layer]["in"][member], device=weight.device)
        out_l = torch.as_tensor(mask_logits[layer]["out"][member], device=weight.device)
        if hard:
            in_m = torch.ones_like(in_l) if rows_only else (in_l >= 0.0).to(in_l.dtype)
            out_m = (out_l >= 0.0).to(out_l.dtype)
        else:
            in_m = torch.ones_like(in_l) if rows_only else _gumbel_binary(
                in_l, draw_gumbel(layer, "in", (2,) + tuple(in_l.shape), generator,
                                  weight.device), temp)
            out_m = _gumbel_binary(out_l, draw_gumbel(layer, "out", (2,) + tuple(out_l.shape),
                                                      generator, weight.device), temp)
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


def _soft_binary_weights(mask_logits: dict, layer: str, rows_only: bool) -> torch.Tensor:
    """(M, C_out * C_in): ``sigmoid(2 l)`` of the out-channel logits times
    that of the in-channel ones (ones with ``rows_only``)."""
    in_l, out_l = mask_logits[layer]["in"], mask_logits[layer]["out"]
    in_p = torch.ones_like(in_l) if rows_only else torch.sigmoid(in_l * 2.0)
    out_p = torch.sigmoid(out_l * 2.0)
    return (out_p[:, :, None] * in_p[:, None, :]).reshape(in_l.shape[0], -1)


def mean_pairwise_iou(mask_logits: dict, *, hard: bool = False,
                      rows_only: bool = False) -> torch.Tensor:
    """The mean over member pairs of the IoU of their weight masks, the
    intersections and unions summed over layers (soft weights by default;
    ``hard`` the binary ones); 0 for fewer than two members."""
    inter_acc = union_acc = None
    for layer in mask_logits:
        if hard:
            w = torch.from_numpy(_hard_binary_weights(mask_logits, layer, rows_only))
        else:
            w = _soft_binary_weights(mask_logits, layer, rows_only)
        if w.shape[0] <= 1:
            continue
        inter = w @ w.T
        sums = w.sum(dim=1, keepdim=True)
        union = sums + sums.T - inter
        inter_acc = inter if inter_acc is None else inter_acc + inter
        union_acc = union if union_acc is None else union_acc + union
    if inter_acc is None:
        return torch.zeros(())
    iu, ju = torch.triu_indices(inter_acc.shape[0], inter_acc.shape[0], offset=1)
    return (inter_acc[iu, ju] / (union_acc[iu, ju] + 1e-8)).mean()


def submodel_size_penalty(mask_logits: dict, target_fraction: float, *,
                          rows_only: bool = False) -> torch.Tensor:
    """The mean over layers of the mean over members of
    ``relu(expected fill - target_fraction)``."""
    penalties = []
    for layer in mask_logits:
        w = _soft_binary_weights(mask_logits, layer, rows_only)
        penalties.append(torch.relu(w.sum(dim=1) / w.shape[1] - target_fraction).mean())
    if not penalties:
        return torch.zeros(())
    return torch.stack(penalties).mean()


def _hard_binary_weights(mask_logits: dict, layer: str, rows_only: bool) -> np.ndarray:
    in_l, out_l = (torch.as_tensor(mask_logits[layer][side]).detach().float().cpu().numpy()
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
