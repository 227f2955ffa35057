"""The experiment configuration (port of ``diffuncertainty_tpu/core/config.py``,
without YAML).

The dataclasses carry every field of the JAX package's, with its defaults,
so that ``from_dict`` reads the ``config.json`` a JAX checkpoint holds and
``to_dict`` writes one the JAX ``from_dict`` reads back. Fields that only
training reads (trainer, EMA and snapshot schedules, batch sizes) are carried
through unread. Every network option of the JAX package is ported
(``models/unet.py``); as there, an unknown ``act`` or ``final_act`` raises
when the network is built.

``load_config`` composes the groups the port has, as the JAX ``load_config``
composes ``configs/<group>/<name>.yaml`` over the defaults: ``data/{lidc64,
lidc128, toy64, gta_toy}``, ``network/{unet4, unet16, unet64, unet256,
hrnet-s, hrnet-m}``,
``model/{softmax, diffusion, ssn, prob_unet}`` and ``eu_method/{dropout,
none, ensemble, swag, swag_diag}``, their patches held here as Python
constants, then the overrides: a nested dict, or the command line's dotted
``a.b=c`` tokens with each value read as a YAML 1.1 scalar or flow list
(:func:`parse_scalar`, without a YAML library). As there,
``network.out_channels`` follows ``data.num_classes``. Other group names
raise.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

from .specs import DropoutSpec, ProbUnetSpec


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    name: str = "unet"
    nickname: str = "unet_s"
    backbone: str = "diff_unet"  # diff_unet | hrnet
    in_channels: int = 3
    out_channels: int = 2  # == data.num_classes
    model_channels: int = 32
    num_res_blocks: tuple[int, ...] = (2, 2, 2, 2)
    num_middle_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 8)
    attention_resolutions: tuple[int, ...] = (-2, -1)
    num_heads: int = 4
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    conv_resample: bool = True
    new_upsample_method: bool = False
    one_skip_per_reso: bool = False
    mlp_attn: bool = False
    act: str = "silu"
    final_act: str = "none"  # none | softmax | tanh | sigmoid (model/diffusion.yaml: softmax)
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
    nickname: str = "au=softmax"
    ssn_rank: int = 10
    ssn_eps: float = 1e-5
    ssn_pretrain_epochs: int = 0
    n_aleatoric_samples: int = 10
    diffusion: DiffusionConfig = DiffusionConfig()
    diffusion_sampling: DiffusionSampling = DiffusionSampling()
    prob_unet: ProbUnetSpec = ProbUnetSpec()


@dataclasses.dataclass(frozen=True)
class SwagConfig:
    """``eu_method.swag``: SWA-Gaussian moment collection."""

    enabled: bool = False
    snapshot_frequency: int = 1
    max_snapshots: int = 20
    min_variance: float = 1e-30
    diag_only: bool = True


@dataclasses.dataclass(frozen=True)
class EUConfig:
    name: str = "none"  # none | dropout | swag | swag_diag | ensemble | subensemble
    nickname: str = "eu=none"
    dropout: DropoutSpec = DropoutSpec()
    swag: SwagConfig = SwagConfig()


@dataclasses.dataclass(frozen=True)
class AugmentationsConfig:
    """Augmentation knobs: TTA reads the flip, rotation, scale and
    ``augment_mult`` keys, inference the normalization."""

    hflip_p: float = 0.5
    rotation_limit: float = 22.5
    scale_limit: tuple[float, float] = (-0.2, 0.2)
    gauss_noise_var_limit: tuple[float, float] = (0.2, 0.44)
    gauss_noise_p: float = 0.5
    height: int = 64
    width: int = 64
    mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    std: tuple[float, ...] = (0.229, 0.224, 0.225)
    augment_mult: float = 0.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    name: str = "lidc64"
    nickname: str = "lidc64"
    data_input_dir: str = ""
    num_classes: int = 2
    ignore_index: int = -1
    batch_size: int = 64
    val_batch_size: int = 64
    data_fold_id: int = 0
    split_name: str = "ood_aug"
    splits_path: str = ""  # default: {dir}/splits/{split_name}/firstCycle/splits.pkl
    num_raters: int = 4
    single_rater: bool = False
    evaluate_all_raters: bool = True
    evaluate_training_data: bool = True
    validation_ratio: float = 0.1
    augmentations: AugmentationsConfig = AugmentationsConfig()


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    track_ema_weights: bool = True
    only_save_ema: bool = True
    ema_decay: float = 0.999


@dataclasses.dataclass(frozen=True)
class CheckpointScheduleConfig:
    use_linear_saving: bool = False
    use_exponential_saving: bool = False
    linear_freq: int = 10
    exponent_base: float = 2.0
    exponential_start: int = 10
    full_last_ckpt: bool = True
    last_every_n_epochs: int = 1
    shutdown_timer: float = 82800.0
    do_shutdown: bool = False


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_epochs: int = 320
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    gradient_clip_val: float = 0.5
    precision: str = "fp32"  # fp32 | bf16 compute dtype; params stay fp32
    remat: bool = False
    lr_schedule: str = "none"
    lr_schedule_total_steps: int = 0
    val_every_n_epochs: int = 1
    mesh_shape: tuple[int, ...] = (1, 1)
    mesh_axis_names: tuple[str, ...] = ("data", "member")
    loggers: tuple[str, ...] = ("jsonl", "tensorboard")

    def __post_init__(self):
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32 or bf16, got {self.precision!r}")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    exp_name: str | None = None
    version: str | None = None
    seed: int = 123
    save_dir: str = "./saves"
    data: DataConfig = DataConfig()
    network: NetworkConfig = NetworkConfig()
    model: ModelConfig = ModelConfig()
    eu_method: EUConfig = EUConfig()
    trainer: TrainerConfig = TrainerConfig()
    ema: EMAConfig = EMAConfig()
    ckpt_save_freq: CheckpointScheduleConfig = CheckpointScheduleConfig()

    @property
    def auto_exp_name(self) -> str:
        """``<data>_<network>_<model>_<eu>`` nicknames unless ``exp_name`` is set."""
        if self.exp_name:
            return self.exp_name
        return "_".join([self.data.nickname, self.network.nickname, self.model.nickname,
                         self.eu_method.nickname])

    def to_dict(self) -> dict:
        return _to_dict(self)

    @staticmethod
    def from_dict(d: dict) -> "ExperimentConfig":
        """The config of a ``config.json`` dict: the dict merged over the
        defaults; an unknown key raises ``KeyError``."""
        return _merge(ExperimentConfig(), d)


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def _merge(obj: Any, updates: dict) -> Any:
    """A copy of dataclass ``obj`` with the (nested) dict ``updates`` applied;
    lists become tuples."""
    fields = {f.name for f in dataclasses.fields(obj)}
    kwargs = {}
    for key, value in updates.items():
        if key not in fields:
            raise KeyError(f"Unknown config key '{key}' for {type(obj).__name__}; "
                           f"valid keys: {sorted(fields)}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            value = _merge(current, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    return dataclasses.replace(obj, **kwargs)


_AUG_128 = {"height": 128, "width": 128}
_LIDC = {"num_classes": 2, "ignore_index": -1, "split_name": "ood_aug", "num_raters": 4,
         "validation_ratio": 0.1}
# each group's patch, as configs/<group>/<name>.yaml of the JAX package holds it
_GROUPS = {
    "data": {
        "lidc64": {"data": dict(_LIDC, name="lidc64", nickname="lidc64", batch_size=64,
                                val_batch_size=64, augmentations={"height": 64, "width": 64})},
        "lidc128": {"data": dict(_LIDC, name="lidc128", nickname="lidc128", batch_size=32,
                                 val_batch_size=32, augmentations=dict(_AUG_128))},
        "toy64": {"data": {
            "name": "toy64", "nickname": "toy64", "num_classes": 2, "ignore_index": -1,
            "batch_size": 16, "val_batch_size": 16, "split_name": "default", "num_raters": 4,
            "validation_ratio": 0.2, "augmentations": {
                "gauss_noise_var_limit": (0.05, 0.1), "height": 64, "width": 64,
                "mean": (0.5,), "std": (0.25,)}}},
        "gta_toy": {"data": {
            "name": "gta_toy", "nickname": "gtatoy", "num_classes": 24, "ignore_index": -1,
            "batch_size": 16, "val_batch_size": 16, "split_name": "default", "num_raters": 1,
            "validation_ratio": 0.0, "augmentations": dict(
                _AUG_128, rotation_limit=10.0, scale_limit=(-0.1, 0.1),
                gauss_noise_var_limit=(0.01, 0.05))}},
    },
    "network": {
        "unet4": {"network": {"name": "unet", "nickname": "unet_s", "backbone": "diff_unet",
                              "model_channels": 16}},
        "unet16": {"network": {"name": "unet", "nickname": "unet_s", "backbone": "diff_unet"}},
        "unet64": {"network": {"name": "unet", "nickname": "unet_m", "backbone": "diff_unet",
                               "num_res_blocks": (2, 2, 3, 4, 4),
                               "channel_mult": (1, 2, 4, 8, 12)}},
        "unet256": {"network": {"name": "unet", "nickname": "unet_l", "backbone": "diff_unet",
                                "model_channels": 64, "num_res_blocks": (2, 2, 3, 4, 4),
                                "channel_mult": (1, 2, 4, 8, 12)}},
        "hrnet-s": {"network": {"name": "hrnet", "nickname": "hrnet_s", "backbone": "hrnet",
                                "hrnet_width": 24}},
        "hrnet-m": {"network": {"name": "hrnet", "nickname": "hrnet_m", "backbone": "hrnet",
                                "hrnet_width": 48}},
    },
    "model": {
        "softmax": {"model": {"au_type": "softmax", "nickname": "au=softmax"}},
        "diffusion": {"model": {"au_type": "diffusion", "nickname": "au=diff"},
                      "network": {"final_act": "softmax"}},
        "ssn": {"model": {"au_type": "ssn", "nickname": "au=ssn", "ssn_pretrain_epochs": 10}},
        "prob_unet": {"model": {"au_type": "prob_unet", "nickname": "au=prob_unet",
                                "prob_unet": {"beta": 2.5e-3, "beta_warmup_epochs": 32,
                                              "regularizer_coeff": 0.0,
                                              "prior_channel_mult": 0.75,
                                              "posterior_channel_mult": 0.75}}},
    },
    "eu_method": {
        "dropout": {"eu_method": {"name": "dropout", "nickname": "eu=dropout",
                                  "dropout": {"enabled": True, "probability_values": (0.2,)}}},
        "none": {"eu_method": {"name": "none", "nickname": "eu=none"}},
        "ensemble": {"eu_method": {"name": "ensemble", "nickname": "eu=ensemble"}},
        "swag": {"eu_method": {"name": "swag", "nickname": "eu=swag", "swag": {
            "enabled": True, "max_snapshots": 30, "diag_only": False}}},
        "swag_diag": {"eu_method": {"name": "swag_diag", "nickname": "eu=swag_diag", "swag": {
            "enabled": True, "max_snapshots": 30, "diag_only": True}}},
    },
}


def load_config(
    data: str = "lidc128",
    network: str = "unet16",
    model: str = "softmax",
    eu_method: str = "dropout",
    precision: str = "fp32",
    overrides: dict | list[str] | None = None,
) -> ExperimentConfig:
    """The four groups over the defaults, then ``trainer.precision`` and the
    ``overrides`` (a nested dict, or dotted ``a.b=c`` tokens); an unknown
    group name raises."""
    cfg = ExperimentConfig()
    for group, name in (("data", data), ("network", network), ("model", model),
                        ("eu_method", eu_method)):
        options = _GROUPS[group]
        if name not in options:
            raise NotImplementedError(
                f"no config '{name}' in group '{group}'; available: {sorted(options)}")
        cfg = _merge(cfg, options[name])
    cfg = _merge(cfg, {"trainer": {"precision": precision}})
    if isinstance(overrides, (list, tuple)):
        cfg = apply_overrides(cfg, overrides)
    else:
        cfg = _merge(cfg, overrides or {})
    return _merge(cfg, {"network": {"out_channels": cfg.data.num_classes}})


def apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """Apply ``a.b.c=value`` tokens in order, each value read by
    :func:`parse_scalar`."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override '{item}' is not of the form key=value")
        path, raw = item.split("=", 1)
        nested: Any = parse_scalar(raw)
        for key in reversed(path.split(".")):
            nested = {key: nested}
        cfg = _merge(cfg, nested)
    return cfg


# PyYAML's implicit resolvers for plain scalars (YAML 1.1, as yaml.safe_load)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")


def parse_scalar(text: str) -> Any:
    """A command-line value as ``yaml.safe_load`` reads it: null, bool, int
    (decimal, 0b, 0o-style octal, 0x), float (a dot is needed: ``1e-4`` stays
    a string, as in YAML 1.1), a quoted string, or a flow list ``[a, b]`` of
    these; anything else is the string itself."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        return [parse_scalar(item) for item in _split_flow(text[1:-1])]
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _NULL.match(text):
        return None
    if _TRUE.match(text):
        return True
    if _FALSE.match(text):
        return False
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(".inf"):
            return -math.inf if value[0] == "-" else math.inf
        return math.nan if value.endswith(".nan") else float(value)
    return text


def _split_flow(body: str) -> list[str]:
    """The top-level comma-separated items of a flow list's body."""
    items, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    if len(items) == 1 and not items[0].strip():
        return []
    return items
