"""GTA5 -> Cityscapes street-scene dataset (the dataset part of
``diffuncertainty_tpu/data/cityscapes.py``; the reference's
``cityscapes_dataset.py``).

npy images with ONE annotation mask each (``{base_id}_mask.npy``); the
aleatoric ambiguity of the ground truth is synthesized by
``data/augment_extra.py::stochastic_label_switches`` (per-class Bernoulli
switches to the ``*_2`` alternate train ids). With ``return_all_raters``
(evaluation) a sample carries ``n_reference_samples`` switched references
drawn from a generator seeded ``(seed, idx)``, the same every load; without
it (training) one mask switched afresh with the loader's generator.
"""

from __future__ import annotations

import numpy as np

from . import cityscapes_labels as cs
from .augment_extra import stochastic_label_switches
from .dataset import MultiRaterDataset


class CityscapesDataset(MultiRaterDataset):
    """Single-mask dataset with label-switch reference sampling."""

    def __init__(self, splits_path, base_dir, split: str = "train", data_fold_id: int = 0,
                 return_all_raters: bool = True, n_reference_samples: int = 4,
                 switch_probs: dict | None = None, seed: int = 13,
                 dataset_label: str = "cityscapes"):
        super().__init__(splits_path, base_dir, split=split, num_raters=1,
                         data_fold_id=data_fold_id, return_all_raters=False,
                         single_rater=False, rater_pattern="{base_id}_mask.npy",
                         dataset_label=dataset_label)
        self.return_switched_references = return_all_raters
        self.n_reference_samples = n_reference_samples
        self.switch_probs = switch_probs or cs.LABEL_SWITCH_PROBS
        self._seed = seed

    def load(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        sample = super().load(idx, rng)
        mask = sample["seg"]
        if self.return_switched_references:
            stable = np.random.default_rng((self._seed, idx))
            sample["seg"] = np.asarray(stochastic_label_switches(
                mask, stable, self.n_reference_samples, self.switch_probs), np.int32)
        else:
            sample["seg"] = np.asarray(stochastic_label_switches(
                mask, rng or np.random.default_rng(), 1, self.switch_probs), np.int32)
        return sample
