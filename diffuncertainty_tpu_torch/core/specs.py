"""MC-dropout placement spec (``DropoutSpec`` of ``diffuncertainty_tpu/core/specs.py``,
without the config-dict parser: the port's config is Python constants)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DropoutSpec:
    """Structured MC-dropout configuration.

    ``probability_values[d]`` is the rate at depth ``d`` (clamped to the last
    entry for deeper stages).
    """

    enabled: bool = False
    probability_values: tuple[float, ...] = (0.0,)
    encoder: bool = True
    mid: bool = True
    decoder: bool = True
    skip_connections: bool = False
    residual_connections: bool = False
    per_block: bool = True

    def rate_at_depth(self, depth: int) -> float:
        if not self.probability_values:
            return 0.0
        idx = min(max(0, int(depth)), len(self.probability_values) - 1)
        return float(self.probability_values[idx])

    def stage_rate(self, stage: str, depth: int) -> float:
        on = {"encoder": self.encoder, "mid": self.mid, "decoder": self.decoder}[stage]
        return self.rate_at_depth(depth) if on else 0.0

    @property
    def max_rate(self) -> float:
        return max(self.probability_values) if self.probability_values else 0.0
