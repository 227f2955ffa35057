"""Label-space augmentation (``stochastic_label_switches`` of
``diffuncertainty_tpu/data/augment_extra.py``): the reference's aleatoric
ground-truth ambiguity for street scenes (``augmentations.py:8-60``). Pure
numpy with an explicit ``np.random.Generator``."""

from __future__ import annotations

import numpy as np

from . import cityscapes_labels as cs


def stochastic_label_switches(
    mask: np.ndarray,
    rng: np.random.Generator,
    n_reference_samples: int = 1,
    switch_probs: dict | None = None,
) -> np.ndarray:
    """Per-class Bernoulli switches to the ``*_2`` alternate train ids.

    Returns (H, W) when n_reference_samples == 1 else (N, H, W).
    """
    probs = switch_probs or cs.LABEL_SWITCH_PROBS
    outs = []
    for _ in range(n_reference_samples):
        m = mask.copy()
        for name, p in probs.items():
            if rng.binomial(1, p):
                m[m == cs.name2trainId[name]] = cs.name2trainId[f"{name}_2"]
        outs.append(m)
    return outs[0] if len(outs) == 1 else np.stack(outs)
