"""Model factory for the ported slices (port of
``diffuncertainty_tpu/models/factory.py``): the softmax and diffusion
families on the DiffUnet backbone. Diffusion models get
``in_channels += out_channels`` for the x_t concat."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.config import ExperimentConfig
from ..core.specs import DropoutSpec
from .diffusion import ContinuousGaussianDiffusion
from .unet import DiffUnet


@dataclasses.dataclass
class BuiltModel:
    module: nn.Module
    au_type: str
    eu_type: str
    is_generative: bool
    num_classes: int
    diffusion: ContinuousGaussianDiffusion | None = None
    diffusion_num_steps: int = 10
    diffusion_sampler_type: str = "ddpm"
    dropout_spec: DropoutSpec = dataclasses.field(default_factory=DropoutSpec)


def build_model(cfg: ExperimentConfig, device: str | torch.device = "cuda") -> BuiltModel:
    """``DiffUnet`` on ``device`` (compute dtype from ``trainer.precision``)."""
    net = cfg.network
    au_type = cfg.model.au_type
    if au_type not in ("softmax", "diffusion") or cfg.eu_method.name not in ("dropout", "none"):
        raise NotImplementedError(
            f"only softmax or diffusion with MC-dropout or no EU method is ported "
            f"(got {au_type}/{cfg.eu_method.name})")
    if cfg.eu_method.name == "dropout":
        dropout_spec = cfg.eu_method.dropout
        if dropout_spec.max_rate <= 0.0:
            raise ValueError("eu_method=dropout requires a positive dropout probability")
    else:
        rate = float(net.dropout)
        dropout_spec = DropoutSpec(enabled=rate > 0.0, probability_values=(rate,))
    is_diffusion = au_type == "diffusion"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA requested but torch.cuda.is_available() is False")
    module = DiffUnet(
        in_channels=net.in_channels + (net.out_channels if is_diffusion else 0),
        out_channels=net.out_channels,
        model_channels=net.model_channels,
        num_res_blocks=tuple(net.num_res_blocks),
        num_middle_res_blocks=net.num_middle_res_blocks,
        attention_resolutions=tuple(net.attention_resolutions),
        channel_mult=tuple(net.channel_mult),
        conv_resample=net.conv_resample,
        num_heads=net.num_heads,
        use_scale_shift_norm=net.use_scale_shift_norm,
        diffusion=is_diffusion,
        final_act=net.final_act,
        dropout_spec=dropout_spec,
        dtype=torch.bfloat16 if cfg.trainer.precision == "bf16" else torch.float32,
    ).to(device).eval()
    sampling = cfg.model.diffusion_sampling
    return BuiltModel(
        module=module,
        au_type=au_type,
        eu_type="dropout" if dropout_spec.max_rate > 0.0 else "none",
        is_generative=is_diffusion,
        num_classes=net.out_channels,
        diffusion=(ContinuousGaussianDiffusion(**dataclasses.asdict(cfg.model.diffusion))
                   if is_diffusion else None),
        diffusion_num_steps=sampling.num_steps,
        diffusion_sampler_type=sampling.sampler,
        dropout_spec=dropout_spec,
    )
