"""Tracing and phase timers (port of ``diffuncertainty_tpu/utils/profiling.py``).

``trace_to`` records the enclosed block with ``torch.profiler`` (CPU
activity, and CUDA activity when a card is present) and writes a Chrome
trace (``trace.json``, for Perfetto or ``chrome://tracing``) into a
directory; the JAX module writes a ``jax.profiler`` trace there.
``phase_timer`` accumulates wall time per named phase; with ``cuda`` (on by
default when a card is present) it synchronizes the card at each phase's
start and end, so a phase's time includes the kernels it queued, as the JAX
timers' ``block_until_ready`` boundaries do.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace_to(log_dir: str | Path):
    """Profile the enclosed block; on exit write ``log_dir/trace.json``.
    Yields the profiler."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class phase_timer:
    """Accumulating per-phase wall timers.

    >>> timers = phase_timer()
    >>> with timers("data"):
    ...     batch = next(it)
    >>> with timers("step"):
    ...     out = step(batch)
    >>> timers.summary()
    """

    def __init__(self, cuda: bool | None = None):
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(total, 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * total / self.counts[name], 3),
            }
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))
