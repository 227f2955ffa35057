"""The fused (members x samples x batch) prediction stack (port of the
softmax and diffusion flat-row paths of ``diffuncertainty_tpu/sampling/sampler.py``).

MC-dropout members, TTA rounds and diffusion trajectories share the
parameters and differ only in random draws, so all ``n_members * n_pred``
rounds fold into the batch axis: rows are member-major (row ``r*B + i`` is
round r of image i), every row gets its own TTA draw, dropout masks and
diffusion start noise, and one forward (softmax) or one reverse trajectory of
forwards (diffusion) serves the whole stack.

Grouping as in the JAX sampler: each member contributes one group of
``n_pred`` samples when TTA is on (else 1); with a single member that is
generative-like (softmax+TTA counts), each sample becomes its own singleton
group. ``group_means`` is the reference's "softmax_pred"
P-axis that feeds the heatmaps and BMA-GED.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..models.factory import BuiltModel
from .tta import TTAConfig, apply_tta, invert_tta, sample_tta_params


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    n_pred: int = 10
    n_members: int = 1
    member_mode: str = "single"  # single | dropout
    tta: bool = False
    tta_config: TTAConfig = TTAConfig()
    diffusion_num_steps: int | None = None  # None -> the model's default
    diffusion_sampler: str | None = None  # ddim | ddpm; None -> the model's default


class PredictionStack(NamedTuple):
    groups: torch.Tensor  # (G, S, B, H, W, C) softmax samples
    group_means: torch.Tensor  # (G, B, H, W, C)
    mean: torch.Tensor  # (B, H, W, C)


class SamplerMeta(NamedTuple):
    n_groups: int
    samples_per_group: int
    group_is_generative: tuple


def initial_noise(shape: tuple, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """Diffusion start noise ``x_init ~ N(0, 1)`` of ``shape``, drawn on the
    generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)


def make_sampler(built: BuiltModel, spec: SamplerSpec) -> Callable:
    """Build ``fn(images, generator) -> PredictionStack``.

    ``images``: (B, H, W, C_in) normalized inputs on the model's device;
    ``generator``: a ``torch.Generator`` on that device, consumed by the TTA
    draws and then the dropout masks (softmax), or by the start noise and
    then each step's dropout masks (diffusion). Runs without autograd.
    """
    if built.au_type not in ("softmax", "diffusion"):
        raise NotImplementedError(f"AU type '{built.au_type}' is not ported")
    if built.au_type == "diffusion" and spec.tta:
        raise NotImplementedError("TTA on the diffusion path is not ported")
    if spec.member_mode not in ("single", "dropout"):
        raise NotImplementedError(f"member_mode '{spec.member_mode}' is not ported")
    module = built.module
    n_members = spec.n_members if spec.member_mode != "single" else 1
    member_is_generative = built.is_generative or spec.tta
    num_steps = spec.diffusion_num_steps or built.diffusion_num_steps
    sampler_type = spec.diffusion_sampler or built.diffusion_sampler_type
    samples_per_member = spec.n_pred if member_is_generative else 1
    # one generative-like member: its samples become singleton groups
    split_into_singletons = member_is_generative and n_members == 1
    if split_into_singletons:
        n = n_members * samples_per_member
        meta = SamplerMeta(n, 1, (built.is_generative,) * n)
    else:
        meta = SamplerMeta(n_members, samples_per_member, (built.is_generative,) * n_members)

    def flat_softmax(images, generator):
        b, h, w, _ = images.shape
        rows = n_members * samples_per_member
        x = images.unsqueeze(0).expand((rows,) + images.shape).reshape((rows * b,) + images.shape[1:])
        tta_params = None
        if spec.tta:
            tta_params = sample_tta_params(spec.tta_config, generator, rows * b, h, w)
            x = apply_tta(x, tta_params)
        probs = torch.softmax(module(x, generator), dim=-1)
        if spec.tta:
            probs = invert_tta(probs, tta_params)
        return probs.reshape(n_members, samples_per_member, b, h, w, probs.shape[-1])

    def flat_diffusion(images, generator):
        b, h, w, _ = images.shape
        c = built.num_classes
        rows = n_members * samples_per_member
        imgs = images.unsqueeze(0).expand((rows,) + images.shape).reshape(
            (rows * b,) + images.shape[1:])
        x_init = initial_noise((rows * b, h, w, c), generator, images.dtype)

        def model_fn(x_with_im, t, gen):
            return module(x_with_im, gen, timesteps=t)

        # final_act=softmax: the x_0 prediction of the last step is a simplex
        x0 = built.diffusion.sample_loop(model_fn, x_init, imgs, num_steps, generator,
                                         sampler_type=sampler_type)
        return x0.reshape(n_members, samples_per_member, b, h, w, c)

    flat_fn = flat_diffusion if built.au_type == "diffusion" else flat_softmax

    def finalize(groups):
        if split_into_singletons:
            m, s = groups.shape[0], groups.shape[1]
            groups = groups.reshape((m * s, 1) + groups.shape[2:])
        group_means = groups.mean(dim=1)
        return PredictionStack(groups, group_means, group_means.mean(dim=0))

    @torch.no_grad()
    def sampler(images: torch.Tensor, generator: torch.Generator) -> PredictionStack:
        return finalize(flat_fn(images, generator))

    sampler.meta = meta
    return sampler
