"""The slice's configuration as Python constants (no YAML).

Holds the fields of ``diffuncertainty_tpu/core/config.py`` that the ported
paths read, with the values that the JAX ``load_config`` composes from
``configs/{data/lidc128, data/gta_toy, network/unet16, network/hrnet-s,
network/hrnet-m, model/softmax, model/diffusion, model/ssn,
model/prob_unet}.yaml`` and ``configs/eu_method/{dropout, none, ensemble,
swag, swag_diag}.yaml``: the unet16 + MC-dropout softmax path
(``model="softmax", eu_method="dropout"``), the unet16 diffusion, SSN and
prob-U-Net paths (``model="diffusion"``, ``"ssn"`` or ``"prob_unet"`` with
``eu_method="none"``), the stacked-member EU methods (a deep ensemble, SWAG
and SWAG-diag) over any of them, the HRNet backbones (``network="hrnet-s"``
or ``"hrnet-m"``) and the 24-class street-scene toy (``data="gta_toy"``).
As in the JAX ``load_config``, ``network.out_channels`` follows
``data.num_classes``. Field names are kept so the two can be compared field
by field. Other groups are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses

from .specs import DropoutSpec, ProbUnetSpec


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    backbone: str = "diff_unet"  # diff_unet | hrnet
    in_channels: int = 3
    out_channels: int = 2  # == data.num_classes
    model_channels: int = 32
    num_res_blocks: tuple[int, ...] = (2, 2, 2, 2)
    num_middle_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 8)
    attention_resolutions: tuple[int, ...] = (-2, -1)
    num_heads: int = 4
    use_scale_shift_norm: bool = False
    conv_resample: bool = True
    final_act: str = "none"  # none | softmax (model/diffusion.yaml sets softmax)
    dropout: float = 0.0  # rate when eu_method does not patch the dropout spec
    # HRNet-specific (backbone == "hrnet")
    hrnet_width: int = 18
    hrnet_pretrained: str | None = None


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """``model.diffusion`` (``configs/model/diffusion.yaml``)."""

    schedule_name: str = "cosine"
    input_scale: float = 0.1
    model_pred_type: str = "X"
    weights_type: str = "uniform"
    sampler_type: str = "uniform_low_d"
    var_type: str = "large"
    loss_type: str = "MSE"
    logsnr_min: float = -10.0
    logsnr_max: float = 10.0
    decouple_loss_weights: bool = False


@dataclasses.dataclass(frozen=True)
class DiffusionSampling:
    num_steps: int = 10
    sampler: str = "ddpm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    au_type: str = "softmax"  # softmax | diffusion | ssn | prob_unet
    ssn_rank: int = 10
    ssn_eps: float = 1e-5
    ssn_pretrain_epochs: int = 0
    diffusion: DiffusionConfig = DiffusionConfig()
    diffusion_sampling: DiffusionSampling = DiffusionSampling()
    prob_unet: ProbUnetSpec = ProbUnetSpec()


@dataclasses.dataclass(frozen=True)
class SwagConfig:
    """``eu_method.swag``: SWA-Gaussian moment collection (the JAX defaults;
    ``configs/eu_method/swag*.yaml`` enable it)."""

    enabled: bool = False
    snapshot_frequency: int = 1
    max_snapshots: int = 20
    min_variance: float = 1e-30
    diag_only: bool = True


@dataclasses.dataclass(frozen=True)
class EUConfig:
    name: str = "dropout"
    dropout: DropoutSpec = DropoutSpec()
    swag: SwagConfig = SwagConfig()


@dataclasses.dataclass(frozen=True)
class AugmentationsConfig:
    mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    std: tuple[float, ...] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    num_classes: int = 2
    ignore_index: int = -1
    num_raters: int = 4
    augmentations: AugmentationsConfig = AugmentationsConfig()


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    precision: str = "fp32"  # fp32 | bf16 compute dtype; params stay fp32


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig
    network: NetworkConfig
    model: ModelConfig
    eu_method: EUConfig
    trainer: TrainerConfig = TrainerConfig()


_GROUPS = {
    "data": {
        "lidc128": DataConfig(),  # configs/data/lidc128.yaml
        "gta_toy": DataConfig(num_classes=24, num_raters=1),  # configs/data/gta_toy.yaml
    },
    "network": {
        "unet16": NetworkConfig(),  # configs/network/unet16.yaml
        # configs/network/hrnet-{s,m}.yaml: width 24 (stage-1 32), 48 (64)
        "hrnet-s": NetworkConfig(backbone="hrnet", hrnet_width=24),
        "hrnet-m": NetworkConfig(backbone="hrnet", hrnet_width=48),
    },
    "model": {
        "softmax": ModelConfig(),  # configs/model/softmax.yaml
        "diffusion": ModelConfig(au_type="diffusion"),  # configs/model/diffusion.yaml
        "ssn": ModelConfig(au_type="ssn", ssn_pretrain_epochs=10),  # configs/model/ssn.yaml
        # configs/model/prob_unet.yaml (not the ProbUnetSpec defaults)
        "prob_unet": ModelConfig(au_type="prob_unet", prob_unet=ProbUnetSpec(
            beta=2.5e-3, beta_warmup_epochs=32, regularizer_coeff=0.0,
            prior_channel_mult=0.75, posterior_channel_mult=0.75)),
    },
    "eu_method": {
        # configs/eu_method/dropout.yaml
        "dropout": EUConfig(dropout=DropoutSpec(enabled=True, probability_values=(0.2,))),
        "none": EUConfig(name="none"),  # configs/eu_method/none.yaml
        "ensemble": EUConfig(name="ensemble"),  # configs/eu_method/ensemble.yaml
        # configs/eu_method/swag.yaml and swag_diag.yaml
        "swag": EUConfig(name="swag", swag=SwagConfig(enabled=True, max_snapshots=30,
                                                      diag_only=False)),
        "swag_diag": EUConfig(name="swag_diag", swag=SwagConfig(enabled=True, max_snapshots=30,
                                                                diag_only=True)),
    },
}
# network fields a model group sets (configs/model/diffusion.yaml: network.final_act)
_MODEL_NETWORK = {"diffusion": {"final_act": "softmax"}}


def load_config(
    data: str = "lidc128",
    network: str = "unet16",
    model: str = "softmax",
    eu_method: str = "dropout",
    precision: str = "fp32",
) -> ExperimentConfig:
    """The composed config of the ported slice; other group names raise."""
    picked = {}
    for group, name in (("data", data), ("network", network), ("model", model),
                        ("eu_method", eu_method)):
        options = _GROUPS[group]
        if name not in options:
            raise NotImplementedError(
                f"config '{name}' in group '{group}' is not ported; "
                f"available: {sorted(options)}")
        picked[group] = options[name]
    picked["network"] = dataclasses.replace(picked["network"], **_MODEL_NETWORK.get(model, {}),
                                            out_channels=picked["data"].num_classes)
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be fp32 or bf16, got {precision!r}")
    return ExperimentConfig(**picked, trainer=TrainerConfig(precision=precision))
