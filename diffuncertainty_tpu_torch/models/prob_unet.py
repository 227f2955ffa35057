"""Probabilistic U-Net on DiffUnet backbones (port of
``diffuncertainty_tpu/models/prob_unet.py:26-181``).

A full DiffUnet gives decoder features; two encoder-only DiffUnets give the
axis-aligned Gaussian prior and posterior over a small latent (dim 6) from
their globally pooled mid-block features; ``Fcomb`` fuses the features with
the latent, tiled over the pixels, through 1x1 convs. ``forward`` returns
the features and the latent parameters; ``decode`` turns (features, z) into
logits, so N latent draws reuse one backbone forward. The posterior serves
training only (``elbo_loss`` is not ported yet).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.specs import ProbUnetSpec
from .unet import Conv, DiffUnet


class LatentParams(NamedTuple):
    mu: torch.Tensor  # (B, L)
    log_sigma: torch.Tensor  # (B, L)

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(self.log_sigma)


class ProbUnetOutput(NamedTuple):
    features: torch.Tensor  # (B, H, W, F) decoder features of the base unet
    prior: LatentParams
    posterior: LatentParams | None
    logits: torch.Tensor | None  # decode(features, z) when z was passed


def sample_latent(params: LatentParams, generator: torch.Generator) -> torch.Tensor:
    """mu + sigma * eps, eps ~ N(0, 1) drawn on the generator's device."""
    eps = torch.randn(params.mu.shape, generator=generator, device=generator.device,
                      dtype=params.mu.dtype)
    return params.mu + params.sigma * eps


def kl_diag_gaussians(post: LatentParams, prior: LatentParams) -> torch.Tensor:
    """KL(post || prior) for diagonal Gaussians, summed over latent dims; (B,)."""
    var_ratio = torch.exp(2.0 * (post.log_sigma - prior.log_sigma))
    t1 = ((post.mu - prior.mu) / prior.sigma) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - 2.0 * (post.log_sigma - prior.log_sigma)).sum(dim=-1)


class LatentEncoder(nn.Module):
    """Encoder-only DiffUnet -> global mean pool -> 1x1 conv -> (mu, log_sigma)."""

    def __init__(self, encoder: DiffUnet, latent_dim: int, channels: int):
        super().__init__()
        self.encoder = encoder
        self.param_head = Conv(channels, 2 * latent_dim, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> LatentParams:
        feats = self.encoder(x, generator).features  # (B, h, w, C)
        pooled = feats.mean(dim=(1, 2))
        params = self.param_head(pooled, pooled.dtype)
        mu, log_sigma = params.chunk(2, dim=-1)
        return LatentParams(mu, log_sigma)


class Fcomb(nn.Module):
    """1x1-conv fusion of features and a tiled latent: ``num_layers - 1``
    ReLU layers of ``hidden_channels``, then the class head; in the
    features' dtype."""

    def __init__(self, in_channels: int, num_classes: int, hidden_channels: int,
                 num_layers: int = 4):
        super().__init__()
        self.num_body = max(0, num_layers - 1)
        cin = in_channels
        for i in range(self.num_body):
            self.add_module(f"body_{i}", Conv(cin, hidden_channels, 1))
            cin = hidden_channels
        self.head = Conv(cin, num_classes, 1)

    def forward(self, features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = features.shape
        latent = z.to(features.dtype)[:, None, None, :].expand(b, h, w, z.shape[-1])
        fused = torch.cat([features, latent], dim=-1)
        for i in range(self.num_body):
            fused = F.relu(getattr(self, f"body_{i}")(fused, fused.dtype))
        return self.head(fused, fused.dtype)


class ProbUnet(nn.Module):
    """The assembled probabilistic U-Net: ``forward`` runs the base
    features and the prior (and the posterior when ``segm`` is given);
    ``decode`` turns (features, z) into logits."""

    def __init__(self, base: DiffUnet, prior: LatentEncoder, posterior: LatentEncoder,
                 fcomb: Fcomb):
        super().__init__()
        self.base = base
        self.prior = prior
        self.posterior = posterior
        self.fcomb = fcomb

    def forward(self, patch: torch.Tensor, segm: torch.Tensor | None = None,
                z: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> ProbUnetOutput:
        features = self.base(patch, generator).features
        prior = self.prior(patch, generator)
        posterior = None
        if segm is not None:
            posterior = self.posterior(torch.cat([patch, segm.to(patch.dtype)], dim=-1),
                                       generator)
        logits = self.fcomb(features, z) if z is not None else None
        return ProbUnetOutput(features, prior, posterior, logits)

    def decode(self, features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.fcomb(features, z)


def _scale_channel_mult(channel_mult, scale: float | None) -> tuple[int, ...]:
    """Python's ``round`` (half to even: 1.5 -> 2, 2.5 -> 2), floored at 1;
    the first entry stays 1."""
    if scale is None or abs(scale - 1.0) < 1e-6:
        return tuple(channel_mult)
    if scale <= 0:
        raise ValueError("channel-mult scale must be > 0")
    return tuple(1 if i == 0 else max(1, int(round(v * scale)))
                 for i, v in enumerate(channel_mult))


def build_prob_unet(base_kwargs: dict[str, Any], spec: ProbUnetSpec) -> ProbUnet:
    """The three scaled DiffUnets and the fcomb. ``base_kwargs`` are
    :class:`DiffUnet` arguments."""
    if base_kwargs.get("diffusion", False):
        raise ValueError("Probabilistic UNet does not support diffusion training")
    channel_mult = tuple(base_kwargs["channel_mult"])
    in_ch = int(base_kwargs["in_channels"])
    out_ch = int(base_kwargs["out_channels"])
    mc = int(base_kwargs["model_channels"])

    def unet(scale, in_channels=in_ch, encoder_only=False):
        kw = dict(base_kwargs, channel_mult=_scale_channel_mult(channel_mult, scale),
                  in_channels=in_channels, diffusion=False, ssn=False,
                  encoder_only=encoder_only)
        return DiffUnet(**kw)

    def encoder(scale, in_channels):
        width = mc * _scale_channel_mult(channel_mult, scale)[-1]  # of the mid block
        return LatentEncoder(unet(scale, in_channels, encoder_only=True), spec.latent_dim, width)

    return ProbUnet(
        base=unet(spec.unet_channel_mult),
        prior=encoder(spec.prior_channel_mult, in_ch),
        posterior=encoder(spec.posterior_channel_mult, in_ch + out_ch),
        fcomb=Fcomb(mc + spec.latent_dim, out_ch, hidden_channels=mc,
                    num_layers=max(1, spec.num_fcomb_convs)),
    )
