"""The fused (members x samples x batch) prediction stack (port of
``diffuncertainty_tpu/sampling/sampler.py``, every execution strategy).

Members run in *blocks*: a block of k members is one forward (one reverse
trajectory of forwards for diffusion) over k member-major blocks of rows,
row ``(m*S + s)*B + i`` being sample s of image i under member m (the JAX
``_tile_rows`` and ``reshape(n_members, samples_per_member, B)`` order,
``sampler.py:270-288``). Every row takes its own TTA draw, dropout masks and
diffusion start noise, drawn from the one generator block after block (in a
stack with no member-folded form, from each member's own generator). The
bodies (:func:`make_sampler`'s ``softmax_group``, ``ssn_group``,
``diffusion_group`` and ``prob_unet_group``) are the JAX per-member group
builders with their member and sample axes folded into the rows, as the JAX
flat path folds them (``sampler.py:259-268`` holds the two to be the same
distribution); the SSN draws its ``n_pred`` logit samples from the low-rank
normal of one forward, and the prob-U-Net decodes its latent draws on
sample-major rows (row ``s*kB + r``).

How members fold into blocks:

- shared-weight members (``member_mode`` single or dropout: MC-dropout
  replicas): blocks of ``member_chunk`` members, all in one block when it
  is None or "auto". With ``flat_fold`` on this is the JAX flat path, with
  it off (or an int chunk, or ``same_dropout``) the JAX nested path of
  per-member group builders under vmap or ``lax.map``: the port's bodies
  are both;
- stacked members (``params_stack``: SWAG draws, a deep or a masked
  sub-ensemble) carry their own weights, bound when the sampler is built
  and cast to the compute dtype there, once. A block of one member runs the
  module with its weights swapped in by ``torch.func.functional_call``; a
  block of k > 1 members runs a ``DiffUnet(members=k)`` built on the meta
  device with the block's ``(k, ...)`` slice of the stack bound the same
  way: member-folded rows, the port's stand-in for the JAX vmap and
  ``lax.map`` (the kernels are bound through ctypes, which a
  ``torch.func.vmap`` cannot pass). ``member_chunk``: an int k gives blocks
  of k, None one block of all, "auto" :data:`AUTO_MEMBER_CHUNK` for the
  stack's device and the family (one member a block where it names none).
  ``member_fold=True`` puts all members in one block whatever
  ``member_chunk`` says (the JAX flag replaces both vmap and chunking),
  except where the JAX sampler ignores it (``sampler.py:113-121``):
  with ``same_dropout``, with the prob-U-Net and off the DiffUnet; then
  ``member_chunk`` holds. The prob-U-Net and the HRNet have no member-folded
  form: their stacked members run one per block whatever the chunk, and
  with more than one member each draws from its own generator (dropout
  masks, TTA, latents, noise), seeded by the member's entry of one draw of
  ``n_members`` seeds from the call's generator, as the JAX sampler splits
  one key per member. A rank that holds members ``k..`` draws all the seeds
  and keeps its own, so a seed gives one stack whatever the layout; members
  of equal weights still draw apart.

``same_dropout`` (``sampler.py:200, 221``): one dropout draw per member and
image, reused across all of that member's samples (TTA rounds, diffusion
trajectories) and every diffusion step (``models/unet.py::SameDropout``).

With a ``mesh`` (``parallel/mesh.py``, one rank per card) the sampler takes
the global batch on every rank: each rank runs its ``data`` rows (every row
when the batch does not split over the axis, as the JAX job leaves such a
batch unsharded) and, for stacked members, its ``member`` slice of the
stack, all of it in one block: a member axis sharded across ranks wins over
an explicit ``member_chunk`` (the JAX sampler lets the chunk override it,
``sampler.py:152``, a fault the port does not copy). The draws are the
unsharded call's (``parallel/mesh.py::ShardedGenerator``: each rank draws
the global shape and keeps its rows, member-major), so a seed gives the
same stack whatever the layout, one block of all members being the
unsharded reference. The parts are gathered (``all_gather_into_tensor``)
and every rank returns the whole stack. A stack with no member-folded form
runs the rank's members one a block, each from its own generator.

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
from ..models.unet import Conv, Dense, DiffUnet, SameDropout
from ..parallel.mesh import ShardedGenerator, draw_rows, gather, shard_member_stack
from .tta import TTAConfig, apply_tta, invert_tta, sample_tta_params

# "auto" for stacked members, by the stack's device type and the family:
# on the H100 all members in one folded forward (None) was the fastest of
# chunk 1, 4 and all for the 16-member SWAG-diag softmax ensemble (16 images
# x TTA, 256 rows: 103.54 ms a call against 156.84 and 432.17, peak 4.34 GiB;
# PERF.md §6, chip_smoke.py's ensemble_folded phase). Stacked diffusion and
# SSN members (members x samples x batch rows, over every diffusion step)
# were not timed, nor was anything on the CPU: there, one member at a time
AUTO_MEMBER_CHUNK = {("cuda", "softmax"): None}
@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    n_pred: int = 10
    n_members: int = 1
    member_mode: str = "single"  # single | dropout | params_stack
    # members per forward: an int, None (all) or "auto" (shared-weight
    # members: all; stacked members: AUTO_MEMBER_CHUNK of the stack's device
    # and the family, else 1)
    member_chunk: int | None | str = "auto"
    tta: bool = False
    tta_config: TTAConfig = TTAConfig()
    same_dropout: bool = False  # one dropout draw per member, reused by its samples
    discretize: bool = False
    direct_au: bool = False
    flat_fold: bool = True  # the JAX flat fold or (False) its nested group builders
    member_fold: bool = False  # params_stack: all members in one folded forward
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
    generator's device (per row: ``draw_rows``)."""
    return draw_rows(lambda n, g: torch.randn((n,) + tuple(shape[1:]), generator=g,
                                              device=g.device, dtype=dtype), shape[0], generator)


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
    chunk = spec.member_chunk
    if not (chunk in ("auto", None) or (isinstance(chunk, int) and not isinstance(chunk, bool)
                                        and chunk > 0)):
        raise ValueError(f"member_chunk must be 'auto', None or a positive int, got {chunk!r}")
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


def cast_stack(module: nn.Module, members: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The member stack as the forwards use it: the weights and biases of
    every conv and dense layer that runs in the network's compute dtype
    (``Conv.compute_dtype``) cast to it once, conv kernels with each
    member's kernel channels-last (so a member's slice, or a block's, is
    what ``F.conv2d`` takes with no copy); the rest (GroupNorm affines, the
    heads that run in the input's dtype) as given."""
    out = dict(members)
    for name, m in module.named_modules():
        dtype = getattr(m, "dtype", None)
        if isinstance(m, DiffUnet) and dtype != torch.float32:
            for sub, layer in m.named_modules():
                if isinstance(layer, (Conv, Dense)) and layer.compute_dtype:
                    prefix = ".".join(p for p in (name, sub) if p)
                    w, b = f"{prefix}.weight", f"{prefix}.bias"
                    out[w] = out[w].to(dtype)
                    if out[w].ndim == 5:  # (M, O, I, kh, kw): each member channels-last
                        out[w] = out[w].permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
                    out[b] = out[b].to(dtype)
    return out


def make_sampler(built: BuiltModel, spec: SamplerSpec,
                 members: dict[str, torch.Tensor] | None = None, mesh=None) -> Callable:
    """Build ``fn(images, generator) -> PredictionStack``.

    ``images``: (B, H, W, C_in) normalized inputs on the model's device;
    ``generator``: a ``torch.Generator`` on that device, consumed block after
    block: by the TTA draws and then the dropout masks (softmax), by the
    start noise and then each step's dropout masks (diffusion), or by the
    dropout masks and then the logit or latent draws (SSN, prob-U-Net); a
    stack of more than one member with no member-folded form takes one seed
    a member from it and draws each member's from that member's generator.
    Runs without autograd. TTA applies to the softmax path only: the other paths
    ignore ``spec.tta``, as the JAX sampler does.

    ``members``: with ``member_mode="params_stack"``, the stacked member
    weights, a state dict of the module's keys whose tensors have a leading
    member axis of ``spec.n_members`` (``core/params.py``,
    ``models/swag.py::sample_members``, ``models/subensemble.py``); required
    there and refused for every other mode.

    ``mesh``: a ``parallel/mesh.py::Mesh`` of the ranks (see the module's
    docstring); every rank calls the sampler with the same images and a
    generator of the same seed.

    The returned function carries ``meta`` (the stack's grouping),
    ``blocks`` (the members of each forward) and ``modules`` (every module
    its forwards run: the built module and the member-folded ones).
    """
    _check_spec(built, spec, members)
    module = built.module
    stacked = spec.member_mode == "params_stack"
    n_members = spec.n_members if spec.member_mode != "single" else 1
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

    # members per block
    foldable = isinstance(module, DiffUnet) and built.au_type != "prob_unet"
    chunk = spec.member_chunk
    member_split = stacked and mesh is not None and mesh.size("member") > 1
    # stacked members that cannot fold draw from generators of their own
    own_generators = stacked and not foldable and spec.n_members > 1
    first_member = 0  # the global index of this rank's first member
    if member_split:
        if spec.n_members % mesh.size("member"):
            raise ValueError(f"{spec.n_members} members do not split over the mesh's member "
                             f"axis of {mesh.size('member')}")
        members = shard_member_stack(members, mesh)
        n_members = spec.n_members // mesh.size("member")
        first_member = mesh.coord("member") * n_members
        chunk = None  # the rank's members in one block, whatever member_chunk says
    elif stacked:
        if spec.member_fold and not spec.same_dropout and foldable:
            chunk = None
        elif chunk == "auto":
            device = next(iter(members.values())).device.type
            chunk = AUTO_MEMBER_CHUNK.get((device, built.au_type), 1)
    if stacked and not foldable:
        chunk = 1
    chunk = n_members if chunk in (None, "auto") else min(chunk, n_members)
    blocks = [(a, min(chunk, n_members - a)) for a in range(0, n_members, chunk)]

    n_pred = spec.n_pred

    def dropout_draws(generator, k, rounds):
        return SameDropout(generator, k, rounds) if spec.same_dropout else generator

    # each body runs a block of k members through ``forward`` (and, for the
    # prob-U-Net, ``decode``) -> (k, samples_per_member, B, H, W, C)
    def softmax_group(forward, decode, k, images, generator):
        b, h, w, _ = images.shape
        rows = k * samples_per_member
        x = _tile_rows(images, rows)
        tta_params = None
        if spec.tta:
            tta_params = sample_tta_params(spec.tta_config, generator, rows * b, h, w)
            x = apply_tta(x, tta_params)
        out = forward(x, dropout_draws(generator, k, samples_per_member))
        probs = torch.softmax(out.logits, dim=-1)
        if spec.tta:
            probs = invert_tta(probs, tta_params)
        return probs.reshape(k, samples_per_member, b, h, w, probs.shape[-1])

    def diffusion_group(forward, decode, k, images, generator):
        b, h, w, _ = images.shape
        c = built.num_classes
        rows = k * samples_per_member
        imgs = _tile_rows(images, rows)
        x_init = initial_noise((rows * b, h, w, c), generator, images.dtype)
        same = SameDropout(generator, k, samples_per_member) if spec.same_dropout else None

        def model_fn(x_with_im, t, gen):
            return forward(x_with_im, same or gen, timesteps=t).logits

        # final_act=softmax: the x_0 prediction of the last step is a simplex
        x0 = built.diffusion.sample_loop(model_fn, x_init, imgs, num_steps, generator,
                                         sampler_type=sampler_type)
        return x0.reshape(k, samples_per_member, b, h, w, c)

    def ssn_group(forward, decode, k, images, generator):
        b, h, w, _ = images.shape
        out = forward(_tile_rows(images, k), dropout_draws(generator, k, 1))
        dist = ssn.build_distribution(out.ssn_mean, out.ssn_cov_diag, out.ssn_cov_factor)
        flat = ssn.sample_n(dist, generator, n_pred)  # (S, k*B, N)
        logits = flat.reshape(n_pred, k, b, h, w, out.logits.shape[-1])
        return torch.softmax(logits, dim=-1).movedim(0, 1)

    def prob_unet_group(forward, decode, k, images, generator):
        b, h, w, _ = images.shape
        out = forward(_tile_rows(images, k), generator=dropout_draws(generator, k, 1))
        prior = LatentParams(*(_tile_rows(p, n_pred) for p in out.prior))
        z = sample_latent(prior, generator)
        logits = decode(_tile_rows(out.features, n_pred), z)
        probs = torch.softmax(logits, dim=-1)
        return probs.reshape(n_pred, k, b, h, w, probs.shape[-1]).movedim(0, 1)

    group_fn = {"softmax": softmax_group, "diffusion": diffusion_group, "ssn": ssn_group,
                "prob_unet": prob_unet_group}[built.au_type]

    modules = [module]
    if stacked:
        call = torch.func.functional_call
        stack = cast_stack(module, members)
        folded = {}
        for _, k in blocks:
            if k > 1 and k not in folded:
                with torch.device("meta"):
                    folded[k] = DiffUnet(**{**module.config, "members": k}).eval()
        modules += list(folded.values())
        decoder = _Method(module, "decode") if built.au_type == "prob_unet" else None
        runs = []
        for a, k in blocks:
            if k == 1:
                state = {key: v[a] for key, v in stack.items()}
                net = module
            else:
                state = {key: v[a:a + k] for key, v in stack.items()}
                net = folded[k]
            dstate = {f"net.{key}": v for key, v in state.items()} if decoder else None
            runs.append((k,
                         lambda *args, _n=net, _s=state, **kw: call(_n, _s, args, kw),
                         lambda *args, _s=dstate: call(decoder, _s, args)))
    else:
        decode = getattr(module, "decode", None)
        runs = [(k, module, decode) for _, k in blocks]

    def finalize(groups):
        if spec.discretize:
            groups = nn.functional.one_hot(groups.argmax(-1), groups.shape[-1]).to(groups.dtype)
        if split_into_singletons:
            m, s = groups.shape[0], groups.shape[1]
            groups = groups.reshape((m * s, 1) + groups.shape[2:])
        group_means = groups.mean(dim=1)
        return PredictionStack(groups, group_means, group_means.mean(dim=0))

    def member_generators(generator):
        """One generator for each of this rank's members, seeded by its
        entry of ``spec.n_members`` seeds drawn from ``generator`` (a
        data-sharded call keeps the rows of its part in each)."""
        base = generator.generator if isinstance(generator, ShardedGenerator) else generator
        seeds = torch.randint(0, 2**63 - 1, (spec.n_members,), generator=base,
                              device=base.device).tolist()
        gens = [torch.Generator(base.device).manual_seed(seed)
                for seed in seeds[first_member:first_member + n_members]]
        if isinstance(generator, ShardedGenerator):
            gens = [ShardedGenerator(g, generator.images, generator.data) for g in gens]
        return gens

    def run_blocks(images, generator):
        gens = member_generators(generator) if own_generators else [generator] * len(runs)
        groups = [group_fn(forward, decode, k, images, g)
                  for (k, forward, decode), g in zip(runs, gens)]
        return groups[0] if len(groups) == 1 else torch.cat(groups)

    @torch.no_grad()
    def sampler(images: torch.Tensor, generator: torch.Generator) -> PredictionStack:
        if mesh is None:
            return finalize(run_blocks(images, generator))
        data = mesh.size("data") if images.shape[0] % mesh.size("data") == 0 else 1
        if data > 1:
            images = images[mesh.rows(images.shape[0], "data")]
        member = ((mesh.coord("member"), mesh.size("member"))
                  if member_split and not own_generators else (0, 1))
        groups = run_blocks(images, ShardedGenerator(
            generator, images.shape[0], (mesh.coord("data") if data > 1 else 0, data), member))
        if member_split:
            groups = gather(groups, mesh, "member")
        if data > 1:
            groups = gather(groups, mesh, "data", dim=2)
        return finalize(groups)

    sampler.meta = meta
    sampler.blocks = [k for _, k in blocks]
    sampler.modules = modules
    return sampler
