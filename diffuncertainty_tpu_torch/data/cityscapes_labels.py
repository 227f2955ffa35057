"""Cityscapes label metadata: trainId / color / name mappings (copy of
``diffuncertainty_tpu/data/cityscapes_labels.py``).

Standard Cityscapes 19-class training IDs (public dataset metadata) plus the
reference's duplicated ``*_2`` classes used by StochasticLabelSwitches to
model aleatoric GT ambiguity (``data/cityscapes_labels.py:1-218``): the five
switchable classes get alternates with train ids 19..23.
"""

from __future__ import annotations

import numpy as np

# (name, trainId, color)
_BASE = [
    ("road", 0, (128, 64, 128)),
    ("sidewalk", 1, (244, 35, 232)),
    ("building", 2, (70, 70, 70)),
    ("wall", 3, (102, 102, 156)),
    ("fence", 4, (190, 153, 153)),
    ("pole", 5, (153, 153, 153)),
    ("traffic light", 6, (250, 170, 30)),
    ("traffic sign", 7, (220, 220, 0)),
    ("vegetation", 8, (107, 142, 35)),
    ("terrain", 9, (152, 251, 152)),
    ("sky", 10, (70, 130, 180)),
    ("person", 11, (220, 20, 60)),
    ("rider", 12, (255, 0, 0)),
    ("car", 13, (0, 0, 142)),
    ("truck", 14, (0, 0, 70)),
    ("bus", 15, (0, 60, 100)),
    ("train", 16, (0, 80, 100)),
    ("motorcycle", 17, (0, 0, 230)),
    ("bicycle", 18, (119, 11, 32)),
]

SWITCHABLE = ("sidewalk", "person", "car", "vegetation", "road")

_ALT = [
    (f"{name}_2", 19 + i, tuple(min(255, c + 40) for c in color))
    for i, (name, _, color) in enumerate(
        entry for entry in _BASE if entry[0] in SWITCHABLE
    )
]

LABELS = _BASE + _ALT + [("unlabeled", 255, (0, 0, 0))]

name2trainId = {name: tid for name, tid, _ in LABELS}
trainId2name = {tid: name for name, tid, _ in LABELS}
trainId2color = {tid: color for _, tid, color in LABELS}
color2trainId = {color: tid for _, tid, color in LABELS}

NUM_TRAIN_CLASSES = 19 + len(_ALT)  # 24 with alternates

# reference switch probabilities (augmentations.py:12-18)
LABEL_SWITCH_PROBS = {
    "sidewalk": 8.0 / 17.0,
    "person": 7.0 / 17.0,
    "car": 6.0 / 17.0,
    "vegetation": 5.0 / 17.0,
    "road": 4.0 / 17.0,
}

# the analytic GT-uncertainty switch probabilities (evaluation/utils/gta.py)
GT_SWITCH_PROBS = {name: 1.0 / 3.0 for name in SWITCHABLE}


def palette() -> list[int]:
    """PIL palette (768 ints) for saving colorized predictions."""
    pal = [0] * 768
    for tid, color in trainId2color.items():
        if 0 <= tid < 256:
            pal[3 * tid : 3 * tid + 3] = list(color)
    return pal


def gt_switch_uncertainty_map(label, probs: dict | None = None):
    """Per-pixel Bernoulli variance of the label-switch process
    (``evaluation/utils/gta.py:15-45``; note the reference's axis swap is a
    TIFF-loader artifact and not reproduced)."""
    probs = probs or GT_SWITCH_PROBS
    unc = np.zeros_like(label, dtype=np.float32)
    for name, p in probs.items():
        variance = (1 - p) * p**2 + p * (1 - p) ** 2
        unc[label == name2trainId[name]] = variance
    return unc
