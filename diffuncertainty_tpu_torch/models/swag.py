"""SWA-Gaussian posterior over a state dict (port of
``diffuncertainty_tpu/models/swag.py``).

The state is a triple of state dicts (mean, sq_mean, dev) beside a snapshot
count; ``dev`` holds fixed-shape ``(max_K, *param.shape)`` rings of
deviations, written at slot ``n % max_K`` against the new mean (sampling is
order-invariant over rows). ``sample`` draws one weight set:

    var = max(sq_mean - mean^2, var_clamp)
    w   = mean + sqrt(scale) * (sqrt(var) * eps + z . dev / sqrt(max_K - 1))   full rank
    w   = mean + scale * sqrt(var) * eps + scale * z . dev / sqrt(max_K - 1)   blockwise

with the rows of ``z`` past ``min(n, max_K)`` masked to 0. Full rank shares
one ``z`` across every parameter (cross-parameter correlations); blockwise
draws a fresh one per parameter. The normalizer uses the configured
``max_K``, not the collected count. The normals come from
:func:`draw_normal`: first ``z`` (one (max_K,) draw, or one per parameter
in the state's key order when blockwise), then ``eps`` per parameter in the
state's key order. ``sample_members`` stacks ``num_members`` draws into the
(M, ...) state dict the sampler's ``params_stack`` mode takes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

State = dict[str, torch.Tensor]


class SwagState(NamedTuple):
    n_models: int  # snapshots collected so far
    mean: State
    sq_mean: State
    dev: State | None  # (max_K, *shape) deviation rings; None if diag-only


def draw_normal(shape: tuple, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """Standard normals of ``shape``, drawn on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)


def init(params: State, max_num_models: int = 20, diag_only: bool = False) -> SwagState:
    dev = None if diag_only else {
        k: p.new_zeros((max_num_models,) + tuple(p.shape)) for k, p in params.items()}
    return SwagState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()}, dev)


def collect(state: SwagState, params: State, max_num_models: int) -> SwagState:
    """Fold one snapshot into the running moments; a new state, the old one
    is left as it was."""
    n = torch.tensor(float(state.n_models), dtype=torch.float32)
    inv = 1.0 / (n + 1.0)
    coeff = n * inv
    mean = {k: m * coeff + params[k] * inv for k, m in state.mean.items()}
    sq_mean = {k: s * coeff + params[k] * params[k] * inv for k, s in state.sq_mean.items()}
    dev = None
    if state.dev is not None:
        slot = state.n_models % max_num_models
        dev = {}
        for k, ring in state.dev.items():
            ring = ring.clone()
            ring[slot] = params[k] - mean[k]
            dev[k] = ring
    return SwagState(state.n_models + 1, mean, sq_mean, dev)


def sample(state: SwagState, generator: torch.Generator, *, max_num_models: int,
           scale: float = 1.0, use_low_rank: bool = True, blockwise: bool = False,
           var_clamp: float = 1e-30) -> State:
    """One weight set from the posterior (see the module docstring)."""
    if use_low_rank and state.dev is None:
        raise ValueError("Low-rank sampling requested but state is diag_only")
    keys = list(state.mean)
    z = dict.fromkeys(keys)
    if use_low_rank:
        first = state.mean[keys[0]]
        valid = torch.arange(max_num_models, device=first.device) < min(state.n_models,
                                                                         max_num_models)

        def masked_z():
            return torch.where(valid, draw_normal((max_num_models,), generator, torch.float32),
                               0.0)

        z = {k: masked_z() for k in keys} if blockwise else dict.fromkeys(keys, masked_z())
        normalizer = float(max(max_num_models - 1, 1)) ** 0.5
    out = {}
    for k in keys:
        mean = state.mean[k]
        var = torch.clamp(state.sq_mean[k] - mean ** 2, min=var_clamp)
        diag_term = torch.sqrt(var) * draw_normal(tuple(mean.shape), generator, mean.dtype)
        cov_term = (torch.tensordot(z[k], state.dev[k], dims=([0], [0])) / normalizer
                    if use_low_rank else 0.0)
        if blockwise:
            out[k] = mean + float(scale) * diag_term + cov_term * float(scale)
        else:
            out[k] = mean + float(scale) ** 0.5 * (diag_term + cov_term)
    return out


def sample_members(state: SwagState, generator: torch.Generator, num_members: int,
                   **kw) -> State:
    """(M, ...) stacked weight sets, drawn one member after another."""
    draws = [sample(state, generator, **kw) for _ in range(num_members)]
    return {k: torch.stack([d[k] for d in draws]) for k in state.mean}
