"""The fused (members x samples x batch) prediction stack (port of
``diffuncertainty_tpu/sampling/sampler.py``: the flat-row paths of softmax,
diffusion, SSN and prob-U-Net, and stacked-parameter members).

MC-dropout members, TTA rounds and diffusion trajectories share the
parameters and differ only in random draws, so all ``n_members * n_pred``
rounds fold into the batch axis (the softmax path takes either backbone,
the DiffUnet or the HRNet, whose final dropout draws per row and branch): rows are member-major (row ``r*B + i`` is
round r of image i), every row gets its own TTA draw, dropout masks and
diffusion start noise, and one forward (softmax) or one reverse trajectory of
forwards (diffusion) serves the whole stack. The SSN runs one forward per
member and draws its ``n_pred`` logit samples from the low-rank normal
(``sampler.py:290-298``). The prob-U-Net runs one feature and prior forward
per member, then decodes ``n_pred`` latent draws; its decode rows are
sample-major (row ``s*B + i`` is sample s of image i, ``sampler.py:317-332``).

Stacked members (``member_mode="params_stack"``: SWAG draws, a deep or a
masked sub-ensemble) carry their own weights, bound when the sampler is
built. They run one after another (the JAX ``member_chunk`` 1), each through
the same flat body with one member, on the one module with its weights
swapped in by ``torch.func.functional_call``; each takes fresh draws from the
generator. The JAX package holds the flat fold and its per-member group
builders to be the same distribution (``sampler.py:259-268``).

Grouping as in the JAX sampler (``sampler.py:346-364, 391-405``): each member
contributes one group of ``n_pred`` samples when it is generative or TTA is
on (else 1); unless more than one generative member is counted (with
``external_generative_members`` from sibling samplers) and ``direct_au`` is
off, each sample becomes its own singleton group. ``discretize`` one-hots
each sample's argmax. ``group_means`` is the reference's "softmax_pred"
P-axis that feeds the heatmaps and BMA-GED.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..models import ssn
from ..models.factory import AU_TYPES, BuiltModel
from ..models.prob_unet import LatentParams, sample_latent
from .tta import TTAConfig, apply_tta, invert_tta, sample_tta_params


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    n_pred: int = 10
    n_members: int = 1
    member_mode: str = "single"  # single | dropout | params_stack
    # "auto": stacked members run one at a time, shared-weight members fold
    # into the rows; an int (chunked members) or None with params_stack
    # (vmapped members) is not ported
    member_chunk: int | None | str = "auto"
    tta: bool = False
    tta_config: TTAConfig = TTAConfig()
    same_dropout: bool = False  # not ported
    discretize: bool = False
    direct_au: bool = False
    flat_fold: bool = True  # False (the nested per-member path) is not ported
    member_fold: bool = False  # not ported
    external_generative_members: int = 0  # generative members of sibling samplers
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


def _tile_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``rows`` copies of ``x`` along a new leading axis, folded into the
    batch: row ``r*B + i`` is copy r of ``x[i]``."""
    return x.unsqueeze(0).expand((rows,) + x.shape).reshape((rows * x.shape[0],) + x.shape[1:])


class _Method(nn.Module):
    """Runs ``net.<name>`` as its forward, so that ``functional_call`` can
    bind member weights (keys ``net.<key>``) to a method other than forward."""

    def __init__(self, net: nn.Module, name: str):
        super().__init__()
        self.net, self.name = net, name

    def forward(self, *args, **kwargs):
        return getattr(self.net, self.name)(*args, **kwargs)


def _check_spec(built: BuiltModel, spec: SamplerSpec, members: dict | None) -> None:
    if built.au_type not in AU_TYPES:
        raise NotImplementedError(f"AU type '{built.au_type}' is not ported")
    if spec.member_mode not in ("single", "dropout", "params_stack"):
        raise ValueError(f"unknown member_mode '{spec.member_mode}'")
    for name, unported in (("same_dropout", spec.same_dropout),
                           ("member_fold", spec.member_fold),
                           ("flat_fold=False", not spec.flat_fold),
                           ("an integer member_chunk", isinstance(spec.member_chunk, int)),
                           ("member_chunk=None (vmapped members) with params_stack",
                            spec.member_chunk is None and spec.member_mode == "params_stack")):
        if unported:
            raise NotImplementedError(f"{name} is not ported")
    if spec.member_chunk not in ("auto", None) and not isinstance(spec.member_chunk, int):
        raise ValueError(f"member_chunk must be 'auto', None or an int, got {spec.member_chunk!r}")
    if spec.member_mode != "params_stack":
        if members is not None:
            raise ValueError(f"a member stack was given for member_mode '{spec.member_mode}'")
        return
    if members is None:
        raise ValueError("member_mode 'params_stack' needs the member stack (members=...)")
    own = built.module.state_dict()
    if set(members) != set(own):
        raise KeyError(f"member stack keys differ from the module's: missing "
                       f"{sorted(set(own) - set(members))[:5]}, unknown "
                       f"{sorted(set(members) - set(own))[:5]}")
    for key, value in members.items():
        if tuple(value.shape) != (spec.n_members,) + tuple(own[key].shape):
            raise ValueError(f"member stack '{key}' has shape {tuple(value.shape)}, expected "
                             f"({spec.n_members}, *{tuple(own[key].shape)}): its leading "
                             f"dimension must be n_members")


def make_sampler(built: BuiltModel, spec: SamplerSpec,
                 members: dict[str, torch.Tensor] | None = None) -> Callable:
    """Build ``fn(images, generator) -> PredictionStack``.

    ``images``: (B, H, W, C_in) normalized inputs on the model's device;
    ``generator``: a ``torch.Generator`` on that device, consumed by the TTA
    draws and then the dropout masks (softmax), by the start noise and then
    each step's dropout masks (diffusion), or by the dropout masks and then
    the logit or latent draws (SSN, prob-U-Net); stacked members consume it
    one after another. Runs without autograd. TTA applies to the softmax path
    only: the other paths ignore ``spec.tta``, as the JAX sampler does.

    ``members``: with ``member_mode="params_stack"``, the stacked member
    weights, a state dict of the module's keys whose tensors have a leading
    member axis of ``spec.n_members`` (``core/params.py``,
    ``models/swag.py::sample_members``, ``models/subensemble.py``); required
    there and refused for every other mode.
    """
    _check_spec(built, spec, members)
    module = built.module
    stacked = spec.member_mode == "params_stack"
    n_members = spec.n_members if spec.member_mode != "single" else 1
    # members folded into the rows of one forward
    folded = 1 if stacked else n_members
    member_is_generative = built.is_generative or (built.au_type == "softmax" and spec.tta)
    num_steps = spec.diffusion_num_steps or built.diffusion_num_steps
    sampler_type = spec.diffusion_sampler or built.diffusion_sampler_type
    samples_per_member = spec.n_pred if member_is_generative else 1
    generative_count = ((n_members if member_is_generative else 0)
                        + spec.external_generative_members)
    multiple_generative = generative_count > 1 and not spec.direct_au
    split_into_singletons = member_is_generative and not multiple_generative
    if split_into_singletons:
        n = n_members * samples_per_member
        meta = SamplerMeta(n, 1, (built.is_generative,) * n)
    else:
        meta = SamplerMeta(n_members, samples_per_member, (built.is_generative,) * n_members)

    n_pred = spec.n_pred

    # each body takes the forward (and, for the prob-U-Net, the decode) to run
    def flat_softmax(forward, decode, images, generator):
        b, h, w, _ = images.shape
        rows = folded * samples_per_member
        x = _tile_rows(images, rows)
        tta_params = None
        if spec.tta:
            tta_params = sample_tta_params(spec.tta_config, generator, rows * b, h, w)
            x = apply_tta(x, tta_params)
        probs = torch.softmax(forward(x, generator).logits, dim=-1)
        if spec.tta:
            probs = invert_tta(probs, tta_params)
        return probs.reshape(folded, samples_per_member, b, h, w, probs.shape[-1])

    def flat_diffusion(forward, decode, images, generator):
        b, h, w, _ = images.shape
        c = built.num_classes
        rows = folded * samples_per_member
        imgs = _tile_rows(images, rows)
        x_init = initial_noise((rows * b, h, w, c), generator, images.dtype)

        def model_fn(x_with_im, t, gen):
            return forward(x_with_im, gen, timesteps=t).logits

        # final_act=softmax: the x_0 prediction of the last step is a simplex
        x0 = built.diffusion.sample_loop(model_fn, x_init, imgs, num_steps, generator,
                                         sampler_type=sampler_type)
        return x0.reshape(folded, samples_per_member, b, h, w, c)

    def flat_ssn(forward, decode, images, generator):
        b, h, w, _ = images.shape
        out = forward(_tile_rows(images, folded), generator)
        dist = ssn.build_distribution(out.ssn_mean, out.ssn_cov_diag, out.ssn_cov_factor)
        flat = ssn.sample_n(dist, generator, n_pred)  # (S, M*B, N)
        logits = flat.reshape(n_pred, folded, b, h, w, out.logits.shape[-1])
        return torch.softmax(logits, dim=-1).movedim(0, 1)

    def flat_prob_unet(forward, decode, images, generator):
        b, h, w, _ = images.shape
        out = forward(_tile_rows(images, folded), generator=generator)
        prior = LatentParams(*(_tile_rows(p, n_pred) for p in out.prior))
        z = sample_latent(prior, generator)
        logits = decode(_tile_rows(out.features, n_pred), z)
        probs = torch.softmax(logits, dim=-1)
        return probs.reshape(n_pred, folded, b, h, w, probs.shape[-1]).movedim(0, 1)

    flat_fn = {"softmax": flat_softmax, "diffusion": flat_diffusion, "ssn": flat_ssn,
               "prob_unet": flat_prob_unet}[built.au_type]

    if stacked:
        call = torch.func.functional_call
        decoder = _Method(module, "decode") if built.au_type == "prob_unet" else None
        member_states = [{k: v[m] for k, v in members.items()} for m in range(n_members)]
        decode_states = [{f"net.{k}": v for k, v in st.items()} if decoder else None
                         for st in member_states]

        def run(images, generator):
            return torch.cat([flat_fn(
                lambda *a, _st=st, **kw: call(module, _st, a, kw),
                lambda *a, _st=dst: call(decoder, _st, a),
                images, generator) for st, dst in zip(member_states, decode_states)])
    else:
        def run(images, generator):
            return flat_fn(module, getattr(module, "decode", None), images, generator)

    def finalize(groups):
        if spec.discretize:
            groups = nn.functional.one_hot(groups.argmax(-1), groups.shape[-1]).to(groups.dtype)
        if split_into_singletons:
            m, s = groups.shape[0], groups.shape[1]
            groups = groups.reshape((m * s, 1) + groups.shape[2:])
        group_means = groups.mean(dim=1)
        return PredictionStack(groups, group_means, group_means.mean(dim=0))

    @torch.no_grad()
    def sampler(images: torch.Tensor, generator: torch.Generator) -> PredictionStack:
        return finalize(run(images, generator))

    sampler.meta = meta
    return sampler
