"""Model factory for the ported slices (port of
``diffuncertainty_tpu/models/factory.py:104-173``): the softmax, diffusion,
SSN and prob-U-Net families on the DiffUnet backbone, under every EU method
(none, MC-dropout, SWAG, SWAG-diag, a deep or a masked sub-ensemble; the
last four reach the sampler as a stacked member state). Diffusion models get
``in_channels += out_channels`` for the x_t concat; the prob-U-Net is
assembled by ``build_prob_unet``. The HRNet backbone (``factory.py:71-101``)
takes the softmax and SSN families only; its final dropout rate is the EU
method's largest dropout rate and its per-stage dropout stays zero.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.config import ExperimentConfig
from ..core.specs import DropoutSpec, ProbUnetSpec
from .diffusion import ContinuousGaussianDiffusion
from .hrnet import HRNet, HRNetSpec
from .prob_unet import build_prob_unet
from .unet import DiffUnet

AU_TYPES = ("softmax", "diffusion", "ssn", "prob_unet")
EU_TYPES = ("none", "dropout", "swag", "swag_diag", "ensemble", "subensemble")


@dataclasses.dataclass
class BuiltModel:
    module: nn.Module
    au_type: str
    eu_type: str
    is_generative: bool
    num_classes: int
    backbone: str = "diff_unet"  # diff_unet | hrnet
    diffusion: ContinuousGaussianDiffusion | None = None
    diffusion_num_steps: int = 10
    diffusion_sampler_type: str = "ddpm"
    prob_unet_spec: ProbUnetSpec | None = None
    dropout_spec: DropoutSpec = dataclasses.field(default_factory=DropoutSpec)

    @property
    def needs_dropout_rng(self) -> bool:
        """Whether a forward draws dropout masks from its generator."""
        return self.dropout_spec.max_rate > 0.0

    @property
    def has_batch_stats(self) -> bool:
        return self.backbone == "hrnet"


def _infer_eu_type(cfg: ExperimentConfig, dropout_spec: DropoutSpec) -> str:
    """The EU type from the config (``models/factory.py:45-61`` of the JAX
    package): the named method, SWAG's switch and a live dropout rate must
    not disagree."""
    explicit = cfg.eu_method.name
    if explicit not in EU_TYPES:
        raise ValueError(f"Unsupported EU method '{explicit}'")
    candidates = set()
    if explicit not in ("none", "ensemble", "subensemble"):
        candidates.add(explicit)
    if cfg.eu_method.swag.enabled:
        candidates.add("swag_diag" if cfg.eu_method.swag.diag_only else "swag")
    if dropout_spec.max_rate > 0.0:
        candidates.add("dropout")
    if len(candidates) > 1:
        raise ValueError(f"Conflicting EU indicators: {sorted(candidates)}")
    if candidates:
        return candidates.pop()
    return explicit if explicit in ("ensemble", "subensemble") else "none"


def build_model(cfg: ExperimentConfig, device: str | torch.device = "cuda") -> BuiltModel:
    """``DiffUnet``, ``ProbUnet`` or ``HRNet`` on ``device``, compute dtype
    from ``trainer.precision``."""
    net = cfg.network
    au_type = cfg.model.au_type
    if au_type not in AU_TYPES:
        raise NotImplementedError(f"only {', '.join(AU_TYPES)} are ported (got {au_type})")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA requested but torch.cuda.is_available() is False")
    dtype = torch.bfloat16 if cfg.trainer.precision == "bf16" else torch.float32
    if net.backbone == "hrnet":
        # reference guard: hrnet supports softmax/ssn only (hrnet :830-835)
        if au_type in ("diffusion", "prob_unet"):
            raise ValueError(f"HRNet does not support AU type '{au_type}'")
        if cfg.eu_method.name == "dropout":
            dropout_spec = cfg.eu_method.dropout
        else:
            rate = float(net.dropout)
            dropout_spec = DropoutSpec(enabled=rate > 0.0, probability_values=(rate,))
        spec = HRNetSpec(width=net.hrnet_width,
                         stage1_channels=32 if net.hrnet_width <= 24 else 64,
                         final_dropout=dropout_spec.max_rate)
        module = HRNet(net.out_channels, spec, in_channels=net.in_channels, ssn=au_type == "ssn",
                       ssn_rank=cfg.model.ssn_rank, ssn_eps=cfg.model.ssn_eps, dtype=dtype)
        return BuiltModel(module=module.to(device).eval(), au_type=au_type,
                          eu_type=_infer_eu_type(cfg, dropout_spec),
                          is_generative=au_type != "softmax", num_classes=net.out_channels,
                          backbone="hrnet", dropout_spec=dropout_spec)
    if cfg.eu_method.name == "dropout":
        dropout_spec = cfg.eu_method.dropout
        if dropout_spec.max_rate <= 0.0:
            raise ValueError("eu_method=dropout requires a positive dropout probability")
    else:
        rate = float(net.dropout)
        dropout_spec = DropoutSpec(enabled=rate > 0.0, probability_values=(rate,))
    is_diffusion = au_type == "diffusion"
    unet_kwargs = dict(
        in_channels=net.in_channels + (net.out_channels if is_diffusion else 0),
        out_channels=net.out_channels,
        model_channels=net.model_channels,
        num_res_blocks=tuple(net.num_res_blocks),
        num_middle_res_blocks=net.num_middle_res_blocks,
        attention_resolutions=tuple(net.attention_resolutions),
        channel_mult=tuple(net.channel_mult),
        conv_resample=net.conv_resample,
        num_heads=net.num_heads,
        num_heads_upsample=net.num_heads_upsample,
        use_scale_shift_norm=net.use_scale_shift_norm,
        diffusion=is_diffusion,
        final_act=net.final_act,
        one_skip_per_reso=net.one_skip_per_reso,
        new_upsample_method=net.new_upsample_method,
        mlp_attn=net.mlp_attn,
        act=net.act,
        ssn=au_type == "ssn",
        ssn_rank=cfg.model.ssn_rank,
        ssn_eps=cfg.model.ssn_eps,
        dropout_spec=dropout_spec,
        dtype=dtype,
    )
    if au_type == "prob_unet":
        module = build_prob_unet(unet_kwargs, cfg.model.prob_unet)
    else:
        module = DiffUnet(**unet_kwargs)
    sampling = cfg.model.diffusion_sampling
    return BuiltModel(
        module=module.to(device).eval(),
        au_type=au_type,
        eu_type=_infer_eu_type(cfg, dropout_spec),
        is_generative=au_type != "softmax",
        num_classes=net.out_channels,
        diffusion=(ContinuousGaussianDiffusion(**dataclasses.asdict(cfg.model.diffusion))
                   if is_diffusion else None),
        diffusion_num_steps=sampling.num_steps,
        diffusion_sampler_type=sampling.sampler,
        prob_unet_spec=cfg.model.prob_unet if au_type == "prob_unet" else None,
        dropout_spec=dropout_spec,
    )
