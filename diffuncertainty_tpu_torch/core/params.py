"""Weights: the flat ``.npz`` asset reader and the flax -> torch bridge.

``load_params_npz`` reads the format of
``diffuncertainty_tpu/tools/bench_weights.py`` ('/'-joined flax paths,
float16 leaves promoted to float32). ``flax_to_torch`` maps the flax tree to
the port's ``state_dict`` names: module path ``a/b/kernel`` becomes
``a.b.weight`` with conv kernels HWIO -> OIHW and dense kernels (I, O) ->
(O, I); GroupNorm ``scale`` becomes ``weight``; biases keep their layout.
Nested trees map the same way: the prob-U-Net's ``prior/encoder/enc0_res/...``
becomes ``prior.encoder.enc0_res...`` and ``fcomb/body_0/kernel``
``fcomb.body_0.weight``.
"""

from __future__ import annotations

from pathlib import Path

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


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """Flax param tree (with or without the top 'params' level) -> state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        *mod, leaf = path
        if leaf == "kernel":
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense (I, O) -> (O, I)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unmapped param leaf '{'/'.join(path)}'")
        key = ".".join(mod + [name])
        if key in state:
            raise KeyError(f"two flax params map to '{key}'")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return state


def load_into(module: torch.nn.Module, path: str | Path) -> torch.nn.Module:
    """Load an npz asset into ``module``; every key must map, none be left."""
    module.load_state_dict(flax_to_torch(load_params_npz(path)), strict=True)
    return module
