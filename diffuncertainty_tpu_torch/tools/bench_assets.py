"""Member stacks from the committed bench assets (the inference half of
``diffuncertainty_tpu/tools/train_bench_assets.py``).

``swag_draw_members`` expands the SWAG-diag moments asset
(``assets/bench_unet16_toy128_swag.npz``, read by
``core/params.py::load_swag_npz``) into the (M, ...) member stack of the
sampler's ``params_stack`` mode, as the reference's test-time expansion does
(``swag.sample(scale=1.0)`` per member, diag-only): each leaf is
``mean + sqrt(scale) * std * eps``, with the stored float16 ``std`` used as
is (no variance clamp). The normals come from ``models/swag.py::draw_normal``,
member after member, each member's leaves in the state's key order.
"""

from __future__ import annotations

import torch

from ..models import swag


def swag_draw_members(mean: dict[str, torch.Tensor], std: dict[str, torch.Tensor],
                      generator: torch.Generator, num_members: int,
                      scale: float = 1.0) -> dict[str, torch.Tensor]:
    """(M, ...) float32 member stack on the generator's device."""
    device = generator.device
    mean = {k: v.to(device=device, dtype=torch.float32) for k, v in mean.items()}
    std = {k: std[k].to(device=device, dtype=torch.float32) for k in mean}
    root = float(scale) ** 0.5
    stack = {k: torch.empty((num_members,) + tuple(m.shape), dtype=torch.float32, device=device)
             for k, m in mean.items()}
    for i in range(num_members):
        for k, m in mean.items():
            stack[k][i] = m + root * std[k] * swag.draw_normal(tuple(m.shape), generator,
                                                               torch.float32)
    return stack
