"""Self-describing checkpoints in a framework-free format (the port's
counterpart of ``diffuncertainty_tpu/core/checkpoint.py``).

A checkpoint directory holds ``config.json`` (the full ExperimentConfig dict)
and ``meta.json`` (epoch, kind), as a JAX checkpoint does, and ``arrays.npz``
in place of the orbax tree: the state's leaves under their '/'-joined paths
(the scheme of ``diffuncertainty_tpu/tools/bench_weights.py``), each at the
dtype it had. The state keys are the JAX trainer's: ``params`` and
``ema_params`` (flax variable dicts, with ``batch_stats`` beside ``params``
for the HRNet), ``swag_state/{n_models, mean, sq_mean[, dev]}``,
``opt_state/{count, mu, nu}`` (the AdamW moments, with the names of optax's
``ScaleByAdamState``; ``mu`` and ``nu`` in the flax layout of ``params``)
and ``step``. The trainer writes them (``train/loop.py``);
``export_torch_checkpoint.py`` at the repo root writes one from a JAX
checkpoint. ``scheduled_epochs`` gives the epochs of the trainer's
weight snapshots.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import numpy as np

from .config import ExperimentConfig

ARRAYS = "arrays.npz"


def checkpoint_epoch_tag(epoch: int, ema: bool) -> str:
    """The result directory's ``e{epoch}[_ema]`` tag."""
    return f"e{epoch}_ema" if ema else f"e{epoch}"


def flatten_state(state: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': array}; None leaves are dropped."""
    flat = {}
    for key, value in state.items():
        if "/" in str(key):
            raise ValueError(f"state key {key!r} holds '/'")
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_state(value, path + "/"))
        elif isinstance(value, (list, tuple)):
            raise TypeError(f"'{path}' is a {type(value).__name__}; the state holds dicts "
                            f"and arrays only")
        elif value is not None:
            flat[path] = np.asarray(value)
    return flat


def unflatten_state(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_checkpoint(path: str | Path, state: dict[str, Any],
                    config: ExperimentConfig | dict, *, epoch: int,
                    kind: str = "full") -> Path:
    """Write ``state`` (a dict of array trees; None values dropped) with
    ``config`` (a config or its dict) and the epoch into ``path``."""
    path = Path(path).resolve()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    np.savez(path / ARRAYS, **flatten_state(state))
    cfg = config.to_dict() if isinstance(config, ExperimentConfig) else config
    (path / "config.json").write_text(json.dumps(cfg, indent=2))
    (path / "meta.json").write_text(json.dumps({"epoch": epoch, "kind": kind}))
    return path


def load_checkpoint(path: str | Path) -> tuple[dict[str, Any], ExperimentConfig, dict]:
    """(state with numpy leaves, config, meta) of a checkpoint directory."""
    path = Path(path)
    if not is_checkpoint_dir(path):
        raise FileNotFoundError(f"{path} is not a checkpoint of the port (config.json, "
                                f"meta.json and {ARRAYS}); export a JAX checkpoint with "
                                f"export_torch_checkpoint.py")
    with np.load(path / ARRAYS, allow_pickle=False) as data:
        state = unflatten_state({k: data[k] for k in data.files})
    config = ExperimentConfig.from_dict(json.loads((path / "config.json").read_text()))
    meta = json.loads((path / "meta.json").read_text())
    return state, config, meta


def is_checkpoint_dir(path: str | Path) -> bool:
    return all((Path(path) / name).is_file() for name in ("config.json", "meta.json", ARRAYS))


def scheduled_epochs(*, max_epochs: int, use_linear: bool, linear_freq: int,
                     use_exponential: bool, exponent_base: float,
                     exponential_start: int) -> list[int]:
    """The epochs of the scheduled weight snapshots (``callbacks.py:15-132``
    of the reference): every ``linear_freq`` and/or ``exponential_start *
    exponent_base**k``, below ``max_epochs``."""
    epochs: set[int] = set()
    if use_linear and linear_freq > 0:
        epochs.update(range(linear_freq, max_epochs, linear_freq))
    if use_exponential and exponential_start > 0 and exponent_base > 1:
        e = float(exponential_start)
        while e < max_epochs:
            epochs.add(int(round(e)))
            e *= exponent_base
    return sorted(epochs)
