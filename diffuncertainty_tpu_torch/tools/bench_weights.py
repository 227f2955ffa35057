"""Flat .npz (de)serialization of weight trees in the ``assets/`` format (port
of ``diffuncertainty_tpu/tools/bench_weights.py``).

Keys are the '/'-joined paths of the flax variable tree (``params/enc0_res/
in_conv/kernel``, kernels HWIO and (I, O)); ``core/params.py::torch_to_flax``
gives that tree from a state dict of the port. ``save_params_npz(...,
dtype="float16")`` stores float leaves as float16, as some assets are;
``load_params_npz`` (``core/params.py``'s reader) promotes them back to
float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.params import load_params_npz

__all__ = ["load_params_npz", "save_params_npz"]


def save_params_npz(params, path: str | Path, *, dtype: str | None = None) -> Path:
    """Save a nested-dict weight tree of arrays as one compressed .npz; ``dtype`` is the storage dtype of floating-point leaves
    (others are stored as they are)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        else:
            arr = np.asarray(node)
            if dtype is not None and np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(dtype)
            flat["/".join(prefix)] = arr

    walk(params, ())
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)
    return path
