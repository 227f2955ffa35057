"""The slice's configuration as Python constants (no YAML).

Holds the fields of ``diffuncertainty_tpu/core/config.py`` that the ported
unet16 + MC-dropout + softmax path reads, with the values that
``load_config(data="lidc128", network="unet16", model="softmax",
eu_method="dropout")`` composes from ``configs/{data/lidc128,
network/unet16, model/softmax, eu_method/dropout}.yaml``. Field names are
kept so the two can be compared field by field. Other groups are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses

from .specs import DropoutSpec


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    in_channels: int = 3
    out_channels: int = 2  # == data.num_classes
    model_channels: int = 32
    num_res_blocks: tuple[int, ...] = (2, 2, 2, 2)
    num_middle_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 8)
    attention_resolutions: tuple[int, ...] = (-2, -1)
    num_heads: int = 4
    conv_resample: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    au_type: str = "softmax"


@dataclasses.dataclass(frozen=True)
class EUConfig:
    name: str = "dropout"
    dropout: DropoutSpec = DropoutSpec()


@dataclasses.dataclass(frozen=True)
class AugmentationsConfig:
    mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    std: tuple[float, ...] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    num_classes: int = 2
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
    "data": {"lidc128": DataConfig()},  # configs/data/lidc128.yaml
    "network": {"unet16": NetworkConfig()},  # configs/network/unet16.yaml
    "model": {"softmax": ModelConfig()},  # configs/model/softmax.yaml
    "eu_method": {  # configs/eu_method/dropout.yaml
        "dropout": EUConfig(dropout=DropoutSpec(enabled=True, probability_values=(0.2,))),
    },
}


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
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be fp32 or bf16, got {precision!r}")
    return ExperimentConfig(**picked, trainer=TrainerConfig(precision=precision))
