"""Sequential batch loader (the in-order, unshuffled, ``drop_last`` path of
``diffuncertainty_tpu/data/loader.py``): numpy dicts of stacked images and
rater masks, full batches only, in dataset order."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .dataset import MultiRaterDataset


class BatchLoader:
    def __init__(self, dataset: MultiRaterDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            samples = [self.dataset.load(i) for i in range(start, start + self.batch_size)]
            yield {
                "image": np.stack([s["image"] for s in samples]).astype(np.float32),
                "seg": np.stack([s["seg"] for s in samples]).astype(np.int32),
                "image_id": [s["image_id"] for s in samples],
            }
