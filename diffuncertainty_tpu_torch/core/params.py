"""Weights: the flat ``.npz`` asset reader and the flax -> torch bridge.

``load_params_npz`` reads the format of
``diffuncertainty_tpu/tools/bench_weights.py`` ('/'-joined flax paths,
float16 leaves promoted to float32). ``flax_to_torch`` maps the flax tree to
the port's ``state_dict`` names: module path ``a/b/kernel`` becomes
``a.b.weight`` with conv kernels HWIO -> OIHW and dense kernels (I, O) ->
(O, I); GroupNorm ``scale`` becomes ``weight``; biases keep their layout.
Nested trees map the same way: the prob-U-Net's ``prior/encoder/enc0_res/...``
becomes ``prior.encoder.enc0_res...`` and ``fcomb/body_0/kernel``
``fcomb.body_0.weight``. A tree of the collections ``params`` and
``batch_stats`` (the HRNet's) maps both: BatchNorm ``scale`` becomes
``weight``, and ``batch_stats/.../mean`` and ``var`` the BatchNorm buffers
``running_mean`` and ``running_var``.

Member stacks (the sampler's ``params_stack``) are state dicts of (M, ...)
tensors: ``flax_to_torch_stacked`` maps a flax tree with a leading member
axis (kernels transposed past it), ``stack_states`` stacks the state dicts
of several checkpoints (a deep ensemble, ``load_member_stack``), and
``load_swag_npz`` reads the SWAG-diag moments asset
(``tools/train_bench_assets.py`` of the JAX package).
"""

from __future__ import annotations

from pathlib import Path

from typing import NamedTuple, Sequence

import numpy as np
import torch


def load_params_npz(path: str | Path) -> dict:
    """Nested-dict param tree from a flat npz; float16 leaves -> float32."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _convert(params: dict, lead: int) -> dict[str, torch.Tensor]:
    """Flax tree -> state_dict; the first ``lead`` axes of every leaf are
    batch axes (a member axis) that stay in front."""
    if set(params) in ({"params"}, {"params", "batch_stats"}):
        leaves = [(path, arr, _PARAM_LEAVES) for path, arr in _flatten(params["params"]).items()]
        leaves += [(path, arr, _STAT_LEAVES)
                   for path, arr in _flatten(params.get("batch_stats", {})).items()]
    else:
        leaves = [(path, arr, _PARAM_LEAVES) for path, arr in _flatten(params).items()]
    front = tuple(range(lead))
    state = {}
    for path, arr, names in leaves:
        *mod, leaf = path
        if leaf not in names:
            raise KeyError(f"unmapped leaf '{'/'.join(path)}'")
        if arr.ndim < lead:
            raise ValueError(f"'{'/'.join(path)}' has no leading member axis")
        if leaf == "kernel":
            if arr.ndim - lead == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(front + tuple(lead + a for a in (3, 2, 0, 1)))
            elif arr.ndim - lead == 2:  # dense (I, O) -> (O, I)
                arr = arr.transpose(front + (lead + 1, lead))
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim - lead} at {'/'.join(path)}")
        key = ".".join(mod + [names[leaf]])
        if key in state:
            raise KeyError(f"two flax params map to '{key}'")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    if lead and len({v.shape[:lead] for v in state.values()}) > 1:
        raise ValueError("the leaves of a member stack disagree on the member count")
    return state


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """Flax param tree (with or without the top 'params' level, or with
    'params' and 'batch_stats') -> state_dict."""
    return _convert(params, 0)


def flax_to_torch_stacked(params: dict) -> dict[str, torch.Tensor]:
    """Flax tree whose leaves have a leading member axis M -> state_dict of
    (M, ...) tensors: conv (M,H,W,I,O) -> (M,O,I,H,W), dense (M,I,O) -> (M,O,I)."""
    return _convert(params, 1)


def stack_states(states: Sequence[dict[str, torch.Tensor]],
                 module: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Stack per-member state dicts into (M, ...) tensors. Every member must
    have the same keys and shapes, and, given ``module``, exactly the
    module's keys and shapes."""
    if not states:
        raise ValueError("no member states to stack")
    ref = {k: tuple(v.shape) for k, v in
           (module.state_dict() if module is not None else states[0]).items()}
    for m, st in enumerate(states):
        got = {k: tuple(v.shape) for k, v in st.items()}
        if got != ref:
            diff = sorted(set(got.items()) ^ set(ref.items()))[:5]
            raise KeyError(f"member {m} does not map onto the reference keys/shapes: {diff}")
    return {k: torch.stack([st[k] for st in states]) for k in ref}


def load_member_stack(paths: Sequence[str | Path],
                      module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The (M, ...) member stack of several npz checkpoints of ``module``'s
    architecture (a deep ensemble); every key of each must map."""
    return stack_states([flax_to_torch(load_params_npz(p)) for p in paths], module)


class SwagMoments(NamedTuple):
    """The SWAG-diag asset: per-parameter mean and standard deviation (state
    dicts, float32) and how many snapshots made them."""

    mean: dict[str, torch.Tensor]
    std: dict[str, torch.Tensor]
    n_snapshots: int
    max_snapshots: int


def load_swag_npz(path: str | Path) -> SwagMoments:
    """Read ``mean/params/...`` (float32), ``std/params/...`` (float16, read
    as float32 exactly) and ``meta/{n_snapshots,max_snapshots}``."""
    tree = load_params_npz(path)
    if set(tree) != {"mean", "std", "meta"}:
        raise KeyError(f"a SWAG asset holds mean, std and meta, got {sorted(tree)}")
    meta = tree["meta"]
    mean, std = flax_to_torch(tree["mean"]), flax_to_torch(tree["std"])
    if {k: v.shape for k, v in mean.items()} != {k: v.shape for k, v in std.items()}:
        raise KeyError("the SWAG mean and std trees differ")
    return SwagMoments(mean, std, int(meta["n_snapshots"]), int(meta["max_snapshots"]))


def load_into(module: torch.nn.Module, path: str | Path) -> torch.nn.Module:
    """Load an npz asset into ``module``; every key must map, none be left."""
    module.load_state_dict(flax_to_torch(load_params_npz(path)), strict=True)
    return module
