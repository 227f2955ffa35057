"""Model specs copied from ``diffuncertainty_tpu/core/specs.py``: the MC-dropout
placement (``DropoutSpec``, without the config-dict parser: the port's config
is Python constants) and the prob-U-Net block (``ProbUnetSpec``)."""

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


@dataclasses.dataclass(frozen=True)
class ProbUnetSpec:
    """The ``model.prob_unet`` block (``ProbUnetSpec`` of the JAX package,
    ``core/specs.py:85-101``), with the training's beta warm-up.

    The defaults are the JAX dataclass's, so configs of other families
    compare field by field; ``configs/model/prob_unet.yaml`` overrides most
    of them (``core/config.py`` holds its values)."""

    latent_dim: int = 6
    beta: float = 10.0
    beta_warmup_epochs: int = 0
    regularizer_coeff: float = 1e-5
    num_fcomb_convs: int = 4
    unet_channel_mult: float = 0.75
    prior_channel_mult: float = 0.5
    posterior_channel_mult: float = 0.5

    def beta_at_epoch(self, epoch: int) -> float:
        """The KL weight of ``epoch``: ``beta`` times ``(epoch + 1) /
        beta_warmup_epochs``, at most 1; ``beta`` without a warm-up."""
        if self.beta_warmup_epochs <= 0:
            return self.beta
        progress = min(1.0, max(0.0, float(epoch + 1) / self.beta_warmup_epochs))
        return self.beta * progress
