"""Model factory for the ported slice (port of
``diffuncertainty_tpu/models/factory.py``, softmax + MC-dropout only)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.config import ExperimentConfig
from ..core.specs import DropoutSpec
from .unet import DiffUnet


@dataclasses.dataclass
class BuiltModel:
    module: nn.Module
    au_type: str
    eu_type: str
    is_generative: bool
    num_classes: int
    dropout_spec: DropoutSpec = dataclasses.field(default_factory=DropoutSpec)


def build_model(cfg: ExperimentConfig, device: str | torch.device = "cuda") -> BuiltModel:
    """``DiffUnet`` on ``device`` (compute dtype from ``trainer.precision``)."""
    net = cfg.network
    if cfg.model.au_type != "softmax" or cfg.eu_method.name != "dropout":
        raise NotImplementedError(
            f"only softmax + MC-dropout is ported (got {cfg.model.au_type}/{cfg.eu_method.name})")
    dropout_spec = cfg.eu_method.dropout
    if dropout_spec.max_rate <= 0.0:
        raise ValueError("eu_method=dropout requires a positive dropout probability")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA requested but torch.cuda.is_available() is False")
    module = DiffUnet(
        in_channels=net.in_channels,
        out_channels=net.out_channels,
        model_channels=net.model_channels,
        num_res_blocks=tuple(net.num_res_blocks),
        num_middle_res_blocks=net.num_middle_res_blocks,
        attention_resolutions=tuple(net.attention_resolutions),
        channel_mult=tuple(net.channel_mult),
        conv_resample=net.conv_resample,
        num_heads=net.num_heads,
        dropout_spec=dropout_spec,
        dtype=torch.bfloat16 if cfg.trainer.precision == "bf16" else torch.float32,
    ).to(device).eval()
    return BuiltModel(
        module=module,
        au_type="softmax",
        eu_type="dropout",
        is_generative=False,
        num_classes=net.out_channels,
        dropout_spec=dropout_spec,
    )
