"""Batch loader (port of the python path of ``diffuncertainty_tpu/data/loader.py``):
numpy dicts of stacked images and rater masks, in dataset order or shuffled.

With ``shuffle`` the order of an epoch is ``np.random.default_rng((seed,
epoch))``'s permutation; a random-rater dataset draws each sample's rater
with a child generator seeded by ``default_rng((seed, epoch, 1))``, one per
sample in order, as the JAX loader's python path does (its native C++ path
draws raters its own way). Each iteration takes the epoch of ``set_epoch``
(0 at first) and moves it one on.

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
    def __init__(self, dataset: MultiRaterDataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 process_shard: tuple[int, int] | None = None):
        if process_shard is not None:
            raise NotImplementedError("process_shard: multi-process loading is not ported; it "
                                      "is ROADMAP Queue 1 item 6")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        return idx

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
        order = self._order()
        rng = np.random.default_rng((self.seed, self._epoch, 1))
        self._epoch += 1
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            idxs = order[start:start + self.batch_size]
            children = [np.random.default_rng(rng.integers(2**63)) for _ in idxs]
            yield self._collate([self.dataset.load(int(i), child)
                                 for i, child in zip(idxs, children)])
