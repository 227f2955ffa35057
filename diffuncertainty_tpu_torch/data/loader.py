"""Batch loader (port of ``diffuncertainty_tpu/data/loader.py``): numpy dicts
of stacked images and rater masks, in dataset order or shuffled.

With ``shuffle`` the order of an epoch is ``np.random.default_rng((seed,
epoch))``'s permutation; a random-rater dataset draws each sample's rater
with a child generator seeded by ``default_rng((seed, epoch, 1))``, one per
sample in order, as the JAX loader's python path does. Each iteration takes
the epoch of ``set_epoch`` (0 at first) and moves it one on.

With ``use_native`` (the default, as in JAX) a plain ``MultiRaterDataset``
whose files the native reader can take (``native_plan``: one image shape,
one mask shape, one rater count per sample, dtypes in
``native_loader.READS``, C order) reads each batch's bytes through
``data/native_loader.py``'s C++ thread pool; any other tree, a subclass or
``use_native=False`` loads sample by sample through ``dataset.load``. The
choice is made once from the dataset's npy headers. Both paths pick the same
rater paths from the same draws and give the same batch, bit for bit (the
JAX native path draws raters its own way). A failure of the native reader
raises: there is no fallback.

With ``drop_last`` (the default, which the quality tools use) only full
batches are yielded. Without it the last batch is padded to ``batch_size``
by repeating its first sample, and ``valid`` marks the real ones, so every
batch has one shape. Each batch carries ``num_raters``, the true rater count
of each sample, with the rater axis padded by all-zero masks to the batch's
largest count, and each sample's ``dataset`` label; ``image_id`` and
``dataset`` list the real samples only.

With ``process_shard=(index, count)`` (``parallel/distributed.py::
loader_shard``) each process takes the strided slice ``order[index::count]``
of the shared (seed, epoch) order, wrap-padded from the start of that order
to ceil(n / count) samples so that every process runs the same number of
steps; ``batch_size`` is then the process's own, as in the JAX loader.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from . import native_loader
from .dataset import MultiRaterDataset


def native_plan(dataset: MultiRaterDataset) -> dict | None:
    """The native reader's slot shapes for ``dataset`` ({"image": shape,
    "mask": shape}), or None when its files do not allow one read per batch:
    not exactly a ``MultiRaterDataset``, no sample, rater counts that differ,
    more than one image or mask shape, Fortran order or an unread dtype."""
    if type(dataset) is not MultiRaterDataset or not dataset.image_paths:
        return None
    if len({len(paths) for paths in dataset.label_paths}) != 1:
        return None
    plan = {}
    for key, files, slot in (("image", dataset.image_paths, "float32"),
                             ("mask", [p for ps in dataset.label_paths for p in ps], "int32")):
        heads = {native_loader.header(p) for p in files}
        shapes = {shape for shape, _, _ in heads}
        if (len(shapes) != 1 or any(fortran for _, _, fortran in heads)
                or not {descr for _, descr, _ in heads} <= native_loader.READS[slot]):
            return None
        plan[key] = shapes.pop()
    ndim_ok = len(plan["image"]) in (2, 3) and len(plan["mask"]) == 2
    return plan if ndim_ok else None


class BatchLoader:
    def __init__(self, dataset: MultiRaterDataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, use_native: bool = True,
                 process_shard: tuple[int, int] | None = None):
        if process_shard is not None and not 0 <= process_shard[0] < process_shard[1]:
            raise ValueError(f"process_shard index {process_shard[0]} not in "
                             f"[0, {process_shard[1]})")
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.use_native = use_native
        self._plan: dict | None | bool = False  # False: not decided yet
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _local_count(self) -> int:
        """The samples of this process's epoch: all, or with ``process_shard``
        the equal, wrap-padded share ceil(n / count)."""
        n = len(self.dataset)
        return n if self.process_shard is None else -(-n // self.process_shard[1])

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:  # (seed, epoch) only: every process permutes alike
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        if self.process_shard is not None:
            pidx, count = self.process_shard
            local = idx[pidx::count]
            want = self._local_count()
            if len(local) < want:  # wrap-pad from the global order
                local = np.concatenate([local, idx[:want - len(local)]])
            idx = local
        return idx

    def __len__(self) -> int:
        n = self._local_count()
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
            "image": images.astype(np.float32, copy=False),
            "seg": seg.astype(np.int32, copy=False),
            "num_raters": num_raters,
            "valid": valid,
            "image_id": [s["image_id"] for s in samples],
            "dataset": [s["dataset"] for s in samples],
        }

    @property
    def native(self) -> bool:
        """Whether batches go through the native reader (decided once)."""
        if self._plan is False:
            self._plan = native_plan(self.dataset) if self.use_native else None
        return self._plan is not None

    def _native_samples(self, idxs, children) -> list[dict]:
        """The samples of ``dataset.load`` for ``idxs``, their bytes read by
        the native reader: the same rater paths from the same draws."""
        ds, plan = self.dataset, self._plan
        images = native_loader.load_batch([ds.image_paths[i] for i in idxs], plan["image"])
        if images.ndim == 3:  # grayscale -> 3 channels
            images = np.repeat(images[..., None], 3, axis=3)
        if ds.return_all_raters:
            paths = [p for i in idxs for p in ds.label_paths[i]]
        elif ds.single_rater:
            paths = [ds.label_paths[i][ds.stable_rater_index(ds.image_ids[i],
                                                             len(ds.label_paths[i]))]
                     for i in idxs]
        else:
            paths = [ds.label_paths[i][int(child.integers(len(ds.label_paths[i])))]
                     for i, child in zip(idxs, children)]
        masks = native_loader.load_batch(paths, plan["mask"], dtype="int32")
        masks = masks.reshape(len(idxs), -1, *plan["mask"]) if ds.return_all_raters else masks
        return [{"image": images[j], "seg": masks[j], "image_id": ds.image_ids[i],
                 "dataset": ds.sample_datasets[i]} for j, i in enumerate(idxs)]

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        rng = np.random.default_rng((self.seed, self._epoch, 1))
        self._epoch += 1
        native = self.native
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            idxs = order[start:start + self.batch_size]
            children = [np.random.default_rng(rng.integers(2**63)) for _ in idxs]
            if native:
                yield self._collate(self._native_samples(idxs, children))
            else:
                yield self._collate([self.dataset.load(int(i), child)
                                     for i, child in zip(idxs, children)])
