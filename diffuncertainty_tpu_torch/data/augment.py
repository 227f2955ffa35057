"""Training augmentation and input normalization (port of
``diffuncertainty_tpu/data/augment.py``).

The train pipeline is one batched affine warp per batch (flip . rotate .
center-scale, constant-0 border), masks warped by nearest selection, then
Gaussian noise and the normalization. ``augment_mult`` scales the
magnitudes (flip probability, rotation limit, scale limit, noise variance);
``augment_mult: 0`` turns every draw into the identity. The warp is the
separable two-pass one (the JAX default; its composed single-resample
option is not ported). The draws come from one ``torch.Generator`` through
:func:`draw_augment`, in a fixed order.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Sequence

import torch

from ..ops.warp import (
    compose_affine,
    hflip_matrix,
    invert_affine,
    rotation_matrix,
    separable_margins,
    warp_affine_separable,
)
from ..parallel.mesh import draw_rows

# The geometric transforms the pipeline (and the TTA inversion built on it)
# samples itself; an Affine (shear, translate) is rejected, not narrowed.
SUPPORTED_GEOMETRIC_TRANSFORMS = frozenset({"HorizontalFlip", "Rotate", "RandomScale"})
# Intensity, crop and container entries: no sampled geometry to invert.
KNOWN_NONGEOMETRIC_TRANSFORMS = frozenset({
    "Normalize", "GaussNoise", "PadIfNeeded", "CenterCrop", "RandomCrop",
    "RandomBrightnessContrast", "ColorJitter", "RandomGamma", "GaussianBlur",
    "Blur", "MedianBlur", "MotionBlur", "Sharpen", "CLAHE", "Equalize",
    "Posterize", "Solarize", "ToFloat", "FromFloat", "ToTensorV2", "ToTensor",
    "OneOf", "Compose", "SomeOf", "Sequential", "Lambda", "NoOp",
})


def _looks_like_transform_name(key: str) -> bool:
    # albumentations class names are CamelCase; config sections ALL-CAPS and
    # parameter keys snake_case
    return bool(re.match(r"^[A-Z][a-z0-9][A-Za-z0-9]*$", key))


def check_geometric_transform_support(transforms, context: str = "augmentation config") -> None:
    """Reject an albumentations-style transform tree the pipeline cannot
    express: a name passes only if it is a supported geometric transform or a
    known non-geometric entry."""
    found: list[str] = []

    def walk(node) -> None:
        if isinstance(node, dict):
            for name, body in node.items():
                if (_looks_like_transform_name(name)
                        and name not in SUPPORTED_GEOMETRIC_TRANSFORMS
                        and name not in KNOWN_NONGEOMETRIC_TRANSFORMS):
                    found.append(name)
                walk(body)
        elif isinstance(node, (list, tuple)):
            for item in node:
                walk(item)

    walk(transforms)
    if found:
        raise ValueError(
            f"{context} contains transforms this pipeline cannot represent "
            f"or invert (or does not recognize): {sorted(set(found))}; "
            f"supported geometric transforms: "
            f"{sorted(SUPPORTED_GEOMETRIC_TRANSFORMS)}; known non-geometric "
            f"pass-through entries: {sorted(KNOWN_NONGEOMETRIC_TRANSFORMS)}")


@dataclasses.dataclass(frozen=True)
class TrainAugmentConfig:
    hflip_p: float = 0.5
    rotation_limit: float = 22.5
    scale_limit: tuple[float, float] = (-0.2, 0.2)
    gauss_noise_var_limit: tuple[float, float] = (0.2, 0.44)
    gauss_noise_p: float = 0.5
    mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    std: tuple[float, ...] = (0.229, 0.224, 0.225)
    augment_mult: float = 1.0

    @property
    def effective(self) -> "TrainAugmentConfig":
        """The magnitudes scaled by ``augment_mult`` (then 1)."""
        m = self.augment_mult
        if m == 1.0:
            return self
        return dataclasses.replace(
            self,
            hflip_p=min(1.0, self.hflip_p * m),
            rotation_limit=self.rotation_limit * m,
            scale_limit=(self.scale_limit[0] * m, self.scale_limit[1] * m),
            gauss_noise_var_limit=(self.gauss_noise_var_limit[0] * m,
                                   self.gauss_noise_var_limit[1] * m),
            augment_mult=1.0,
        )


def normalize_batch(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]
                    ) -> torch.Tensor:
    """(x - mean) / std over the channel axis, max_pixel_value 1 (albumentations Normalize)."""
    mean_t = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std_t = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean_t) / std_t


class AugmentDraws(NamedTuple):
    flip: torch.Tensor  # (B,) bool
    angle: torch.Tensor  # (B,) degrees
    scale: torch.Tensor  # (B,) 1 + U[lo, hi]
    noise_var: torch.Tensor  # (B,)
    apply_noise: torch.Tensor  # (B,) bool
    noise: torch.Tensor  # the images' shape, standard normal


def draw_augment(eff: TrainAugmentConfig, generator: torch.Generator,
                 images: torch.Tensor) -> AugmentDraws:
    """The per-image draws of one batch, from ``generator`` in this order."""
    b, dev = images.shape[0], images.device

    def rand(shape=()):  # per image: ``draw_rows``
        return draw_rows(lambda n, g: torch.rand((n,) + shape, generator=g, device=dev), b,
                         generator)

    def uniform(lo, hi):
        return lo + (hi - lo) * rand()

    flip = rand() < eff.hflip_p
    angle = uniform(-eff.rotation_limit, eff.rotation_limit)
    scale = 1.0 + uniform(*eff.scale_limit)
    noise_var = uniform(*eff.gauss_noise_var_limit)
    apply_noise = rand() < eff.gauss_noise_p
    noise = draw_rows(lambda n, g: torch.randn((n,) + tuple(images.shape[1:]), generator=g,
                                               device=dev, dtype=images.dtype), b, generator)
    return AugmentDraws(flip, angle, scale, noise_var, apply_noise, noise)


def augment_batch(cfg: TrainAugmentConfig, generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The train pipeline on (B, H, W, C) images and (B, H, W) integer masks;
    masks warp by nearest selection with a constant-0 border; the images
    come back normalized."""
    eff = cfg.effective
    b, h, w, _ = images.shape
    d = draw_augment(eff, generator, images)
    dev = images.device
    rot = rotation_matrix(d.angle, d.scale, ((w - 1) / 2.0, (h - 1) / 2.0))
    flip_m = hflip_matrix(w, dev).expand(b, 2, 3)
    ident = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], device=dev).expand(b, 2, 3)
    dst_to_src = invert_affine(compose_affine(rot, torch.where(d.flip[:, None, None], flip_m,
                                                               ident)))
    lo, hi = eff.scale_limit
    m_x, m_y = separable_margins(float(eff.rotation_limit), 1.0 + float(lo), 1.0 + float(hi),
                                 eff.hflip_p > 0.0, h, w)
    images = warp_affine_separable(images, dst_to_src, border_mode="constant",
                                   margin_x=m_x, margin_y=m_y)
    masks_w = warp_affine_separable(masks[..., None].float(), dst_to_src,
                                    interpolation="nearest", border_mode="constant",
                                    margin_x=m_x, margin_y=m_y)
    masks = masks_w[..., 0].to(masks.dtype)
    sigma = torch.sqrt(d.noise_var.clamp(min=0.0))
    scale_b = torch.where(d.apply_noise, sigma, torch.zeros_like(sigma))[:, None, None, None]
    return normalize_batch(images + d.noise * scale_b, eff.mean, eff.std), masks
