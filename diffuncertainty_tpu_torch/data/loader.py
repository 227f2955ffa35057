"""Sequential batch loader (the in-order, unshuffled paths of
``diffuncertainty_tpu/data/loader.py``): numpy dicts of stacked images and
rater masks, in dataset order.

With ``drop_last`` (the default, which the quality tools use) only full
batches are yielded. Without it the last batch is padded to ``batch_size``
by repeating its first sample, and ``valid`` marks the real ones, so every
batch has one shape. Each batch carries ``num_raters``, the true rater count
of each sample, with the rater axis padded by all-zero masks to the batch's
largest count, and each sample's ``dataset`` label; ``image_id`` and
``dataset`` list the real samples only.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .dataset import MultiRaterDataset


class BatchLoader:
    def __init__(self, dataset: MultiRaterDataset, batch_size: int, *, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, samples: list[dict]) -> dict:
        bs, n = self.batch_size, len(samples)
        images = np.stack([s["image"] for s in samples])
        segs = [np.asarray(s["seg"]) for s in samples]
        if segs[0].ndim == 3:  # every rater: pad the rater axis
            max_r = max(s.shape[0] for s in segs)
            seg = np.stack([np.concatenate([s, np.zeros((max_r - s.shape[0],) + s.shape[1:],
                                                        s.dtype)]) for s in segs])
            num_raters = np.asarray([s.shape[0] for s in segs], np.int32)
        else:
            seg = np.stack(segs)
            num_raters = np.ones(n, np.int32)
        valid = np.arange(bs) < n
        if n < bs:  # pad to the static batch size with sample 0
            images = np.concatenate([images, np.repeat(images[:1], bs - n, axis=0)])
            seg = np.concatenate([seg, np.repeat(seg[:1], bs - n, axis=0)])
            num_raters = np.concatenate([num_raters, np.repeat(num_raters[:1], bs - n)])
        return {
            "image": images.astype(np.float32),
            "seg": seg.astype(np.int32),
            "num_raters": num_raters,
            "valid": valid,
            "image_id": [s["image_id"] for s in samples],
            "dataset": [s["dataset"] for s in samples],
        }

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            yield self._collate([self.dataset.load(i)
                                 for i in range(start, min(start + self.batch_size, n))])
