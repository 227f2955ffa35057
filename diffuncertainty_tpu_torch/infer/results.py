"""The results tree on disk (port of ``diffuncertainty_tpu/infer/results.py``).

Layout:

    {save_dir}/{exp_name}/test_results{n_pred}/{version}/e{epoch}[_ema]/{split}/
        pred_seg/{image_id}_mean.png, {image_id}_01.png, ...
        TU/{image_id}.tif  AU/... EU/...   (float32 TIFF heatmaps)
        metrics.json       {id: {dataset, metrics: {dice, ged, ged_bma, ...}}}
        likelihood.json    {id: {dataset, gt_model_NLL, gt_NLL, mean_NLL, gen_NLL}}

PNGs: binary datasets store (mask > 0) * 255 as grayscale, others the class
index as a palette image (the given palette, else a grayscale ramp); ignored
pixels are zeroed. Heatmaps are float32 TIFFs. Both are written by
``infer/image_io.py``.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..core.checkpoint import checkpoint_epoch_tag
from .image_io import write_png, write_tiff


class ResultsWriter:
    """File writer with an optional pool of background encode/write threads.

    With ``async_writes`` (default) the PNG/TIFF encodes and writes run on
    worker threads while the next batch runs on the device; ``flush()`` joins
    them and re-raises the first failure, then writes ``metrics.json`` and
    ``likelihood.json``. The files are the same either way.
    """

    def __init__(self, split_dir: str | Path, *, binary: bool = True,
                 palette: list[int] | None = None, async_writes: bool = True):
        self.split_dir = Path(split_dir)
        self.pred_dir = self.split_dir / "pred_seg"
        self.pred_dir.mkdir(parents=True, exist_ok=True)
        self.binary = binary
        self.palette = palette
        self.metrics: dict[str, dict] = {}
        self.likelihood: dict[str, dict] = {}
        workers = max(2, min(8, (os.cpu_count() or 2) - 1))
        self._pool = ThreadPoolExecutor(max_workers=workers) if async_writes else None
        self._pending = []
        # backpressure: each pending write holds a copy of its array
        self._max_pending = 4 * workers

    def __enter__(self) -> "ResultsWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
        else:
            self.abort()

    def abort(self) -> None:
        """Stop the writer without writing metrics.json (error path)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._pending.clear()

    def _submit(self, fn, *args) -> None:
        if self._pool is None:
            fn(*args)
            return
        if len(self._pending) >= self._max_pending:
            self._pending[0].result()  # block on the oldest; re-raise its failure
            # join every finished write: a failure deeper in the queue must
            # surface here, not vanish
            still_running = []
            for f in self._pending[1:]:
                if f.done():
                    f.result()
                else:
                    still_running.append(f)
            self._pending = still_running
        self._pending.append(self._pool.submit(fn, *args))

    # ---- predictions -----------------------------------------------------

    def save_prediction(self, image_id: str, group_pred_idx: np.ndarray,
                        mean_pred_idx: np.ndarray, ignore_mask: np.ndarray | None = None) -> None:
        """``group_pred_idx`` (G, H, W) argmax per group, ``mean_pred_idx``
        (H, W): the mean and one PNG per group, or one PNG for one group."""
        entries = []
        if group_pred_idx.shape[0] > 1:
            entries.append((f"{image_id}_mean", mean_pred_idx))
            entries.extend((f"{image_id}_{i + 1:02d}", group_pred_idx[i])
                           for i in range(group_pred_idx.shape[0]))
        else:
            entries.append((f"{image_id}_01", group_pred_idx[0]))
        for name, mask in entries:
            mask = np.asarray(mask).copy()
            if ignore_mask is not None:
                mask[np.asarray(ignore_mask, bool)] = 0
            self._submit(self._write_png, name, mask)

    def _write_png(self, name: str, mask: np.ndarray) -> None:
        path = self.pred_dir / f"{name}.png"
        if self.binary:
            write_png(path, (mask > 0).astype(np.uint8) * 255)
        else:
            write_png(path, mask.astype(np.uint8), self.palette, mode="P")

    def save_uncertainty(self, image_id: str, heatmaps: dict[str, np.ndarray]) -> None:
        for unc_type, unc_map in heatmaps.items():
            unc_dir = self.split_dir / unc_type
            unc_dir.mkdir(parents=True, exist_ok=True)
            # copy: the caller may reuse the results buffer for the next batch
            self._submit(self._write_tif, unc_dir, image_id,
                         np.asarray(unc_map, np.float32).copy())

    @staticmethod
    def _write_tif(unc_dir: Path, image_id: str, arr: np.ndarray) -> None:
        write_tiff(unc_dir / f"{image_id}.tif", arr)

    # ---- scalar records --------------------------------------------------

    def add_metrics(self, image_id: str, dataset: str, metrics: dict) -> None:
        self.metrics[image_id] = {"dataset": dataset, "metrics": metrics}

    def add_likelihood(self, image_id: str, dataset: str, record: dict) -> None:
        self.likelihood[image_id] = {"dataset": dataset, **record}

    def flush(self) -> None:
        if self._pool is not None:
            try:
                for fut in self._pending:
                    fut.result()  # join; re-raise the first write failure
            finally:
                # on failure, stop the queued writes rather than leave them running
                self._pending.clear()
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None  # later writes (unusual) run inline
        with open(self.split_dir / "metrics.json", "w") as f:
            json.dump(self.metrics, f, indent=2)
        if self.likelihood:
            with open(self.split_dir / "likelihood.json", "w") as f:
                json.dump(self.likelihood, f, indent=2)


def result_split_dir(save_dir: str | Path, exp_name: str, n_pred: int, version: str,
                     epoch: int, ema: bool, split: str) -> Path:
    return (Path(save_dir) / exp_name / f"test_results{n_pred}" / version
            / checkpoint_epoch_tag(epoch, ema) / split)
