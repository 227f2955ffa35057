"""Training-metric logger (port of ``diffuncertainty_tpu/utils/loggers.py``).

The JSONL stream (``metrics.jsonl``) is the canonical, always-on record.
The ``tensorboard`` backend (``torch.utils.tensorboard``) and the ``wandb``
backend log a warning and are skipped when their package is missing.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Sequence

logger = logging.getLogger(__name__)


class MetricLogger:
    """``log(record)`` appends a flat dict to the backends; non-numeric
    values stay in the JSONL stream only. ``step`` defaults to the record's
    ``step`` (or ``epoch``) field."""

    def __init__(self, workdir: str | Path, backends: Sequence[str] = ("jsonl", "tensorboard")):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.backends = tuple(backends)
        self._jsonl_path = self.workdir / "metrics.jsonl"
        self._tb = self._wandb = None
        self._step = 0
        if "tensorboard" in self.backends:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.workdir / "tb"))
            except Exception as exc:  # noqa: BLE001 - the package may be missing
                logger.warning("tensorboard backend unavailable: %s", exc)
        if "wandb" in self.backends:
            try:
                import wandb

                self._wandb = wandb.init(dir=str(self.workdir))
            except Exception as exc:  # noqa: BLE001 - the package may be missing
                logger.warning("wandb backend unavailable: %s", exc)

    def log(self, record: dict[str, Any], step: int | None = None) -> None:
        if step is None:
            step = int(record.get("step", record.get("epoch", self._step)))
        self._step = max(self._step, step + 1)
        if "jsonl" in self.backends:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        scalars = {k: float(v) for k, v in record.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)
                   and k not in ("step", "epoch")}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        print("[train] " + ", ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                                         for k, v in record.items()), flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
