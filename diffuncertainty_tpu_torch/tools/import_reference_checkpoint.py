"""Convert a reference Lightning ``.ckpt`` into a checkpoint of the port (port
of ``diffuncertainty_tpu/tools/import_reference_checkpoint.py``).

Usage:
    python -m diffuncertainty_tpu_torch.tools.import_reference_checkpoint \
        --ckpt /path/to/last.ckpt --out saves/imported/checkpoints/last

Reads the torch checkpoint on the CPU, translates the embedded hydra
``hyper_parameters`` into an ``ExperimentConfig`` (the self-describing-
checkpoint contract, ``test_utils.py:523-736``), maps the DiffUnet weights
through ``core/torch_import.py`` (raw, and EMA from ``ema_model.module.`` or
``ema_state_dict``), and writes a checkpoint of the port
(``core/checkpoint.py``; the JAX tool writes an orbax one) that the
inference job reads as it is.

A reference ``.ckpt`` pickles omegaconf containers in its
``hyper_parameters``; ``load_reference_checkpoint`` reads them without
omegaconf, as plain dicts and lists.
"""

from __future__ import annotations

import argparse
import pickle
import types
from pathlib import Path
from typing import Any

import torch

from ..core.checkpoint import save_checkpoint
from ..core.config import ExperimentConfig, apply_overrides
from ..core.params import torch_to_flax
from ..core.torch_import import import_torch_state_dict, strip_prefixes
from ..data.augment import check_geometric_transform_support
from ..models.factory import build_model


def translate_hparams(hparams: dict) -> ExperimentConfig:
    """Best-effort reference-hydra-hparams -> ExperimentConfig translation."""
    cfg = ExperimentConfig()
    model_cfg = {}
    net = (
        hparams.get("model", {}).get("cfg", {}).get("MODEL")
        or hparams.get("network", {}).get("cfg", {}).get("MODEL")
        or {}
    )
    net = {str(k).lower(): v for k, v in dict(net).items()}
    overrides = []

    def ov(key, value):
        overrides.append(f"{key}={value}")

    if net:
        if "in_channels" in net:
            ov("network.in_channels", net["in_channels"])
        if "out_channels" in net:
            ov("network.out_channels", net["out_channels"])
            ov("data.num_classes", net["out_channels"])
        for src, dst in [
            ("model_channels", "network.model_channels"),
            ("num_middle_res_blocks", "network.num_middle_res_blocks"),
            ("final_act", "network.final_act"),
            ("num_heads", "network.num_heads"),
            ("num_heads_upsample", "network.num_heads_upsample"),
            ("use_scale_shift_norm", "network.use_scale_shift_norm"),
            ("new_upsample_method", "network.new_upsample_method"),
            ("one_skip_per_reso", "network.one_skip_per_reso"),
            ("mlp_attn", "network.mlp_attn"),
            ("act", "network.act"),
            ("dropout", "network.dropout"),
        ]:
            if src in net:
                ov(dst, net[src])
        for src, dst in [
            ("num_res_blocks", "network.num_res_blocks"),
            ("channel_mult", "network.channel_mult"),
            ("attention_resolutions", "network.attention_resolutions"),
        ]:
            if src in net:
                ov(dst, str(list(net[src])).replace(" ", ""))
        if net.get("diffusion"):
            ov("model.au_type", "diffusion")
            # reference stores in_channels BEFORE the x_t concat
        elif net.get("ssn"):
            ov("model.au_type", "ssn")
            if "ssn_rank" in net:
                ov("model.ssn_rank", net["ssn_rank"])
        if net.get("swag"):
            ov("eu_method.name", "swag")
            ov("eu_method.swag.enabled", "true")
    data = hparams.get("data", {})
    if isinstance(data, dict):
        for src, dst in [
            ("name", "data.name"),
            ("num_classes", "data.num_classes"),
            ("ignore_index", "data.ignore_index"),
            ("data_input_dir", "data.data_input_dir"),
        ]:
            if src in data:
                ov(dst, data[src])
        aug = data.get("augmentations")
        if isinstance(aug, dict):
            # guard: geometric transforms outside {flip, rotate, scale} in
            # the training pipeline would be silently dropped by the TTA
            # knob sampler — reject them instead (test_2D.py:56-73 whitelist)
            check_geometric_transform_support(
                aug.get("TRAIN"), context="reference data.augmentations.TRAIN"
            )
            for src, dst in [
                ("rotation_limit", "data.augmentations.rotation_limit"),
                ("gauss_noise_p", "data.augmentations.gauss_noise_p"),
                ("height", "data.augmentations.height"),
                ("width", "data.augmentations.width"),
                ("augment_mult", "data.augmentations.augment_mult"),
            ]:
                if src in aug:
                    ov(dst, aug[src])
            for src, dst in [
                ("scale_limit", "data.augmentations.scale_limit"),
                ("gauss_noise_var_limit", "data.augmentations.gauss_noise_var_limit"),
                ("mean", "data.augmentations.mean"),
                ("std", "data.augmentations.std"),
            ]:
                if src in aug:
                    ov(dst, str(list(aug[src])).replace(" ", ""))
            hflip_p = _find_transform_param(aug.get("TRAIN"), "HorizontalFlip", "p")
            if hflip_p is not None:
                ov("data.augmentations.hflip_p", hflip_p)
    return apply_overrides(cfg, overrides)


def _find_transform_param(transforms, name: str, param: str):
    """First ``{name: {param: ...}}`` value in an albumentations-style tree."""
    if isinstance(transforms, dict):
        for k, body in transforms.items():
            if k == name and isinstance(body, dict) and param in body:
                return body[param]
            hit = _find_transform_param(body, name, param)
            if hit is not None:
                return hit
    elif isinstance(transforms, (list, tuple)):
        for item in transforms:
            hit = _find_transform_param(item, name, param)
            if hit is not None:
                return hit
    return None


class _DictConfig(dict):
    """Stands in for omegaconf's ``DictConfig`` (and Lightning's
    ``AttributeDict``): a plain dict of the container's values, whether its
    pickle carries items (a dict subclass) or omegaconf's ``_content``."""

    def __setstate__(self, state):
        content = state.get("_content") if isinstance(state, dict) else None
        if isinstance(content, dict):
            self.update({k: _value(v) for k, v in content.items()})


class _ListConfig(list):
    """Stands in for omegaconf's ``ListConfig``: a plain list of its values."""

    def __setstate__(self, state):
        content = state.get("_content") if isinstance(state, dict) else None
        if isinstance(content, list):
            self.extend(_value(v) for v in content)


class _Node:
    """Stands in for an omegaconf value node or metadata record."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


def _value(node):
    return node.__dict__.get("_val") if isinstance(node, _Node) else node


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "omegaconf" or module.startswith("omegaconf."):
            return {"DictConfig": _DictConfig, "ListConfig": _ListConfig}.get(name, _Node)
        if name == "AttributeDict" and "lightning" in module:
            return _DictConfig
        return super().find_class(module, name)


_PICKLE = types.ModuleType("reference_checkpoint_pickle")
_PICKLE.Unpickler = _Unpickler
_PICKLE.load = lambda f, **kw: _Unpickler(f, **kw).load()


def load_reference_checkpoint(path: str | Path) -> dict:
    """``torch.load`` of a reference checkpoint on the CPU, omegaconf's
    containers read as dicts and lists.

    This unpickles arbitrary objects (``weights_only=False``): a Lightning
    checkpoint holds more than tensors. Load only checkpoints you trust."""
    return torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PICKLE)


def _tensors(state: dict) -> dict:
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def convert(
    ckpt_path: str | Path,
    out_path: str | Path,
    config: ExperimentConfig | None = None,
    epoch: int | None = None,
) -> Path:
    """Write the port's checkpoint of a reference ``.ckpt`` at ``out_path``:
    ``params`` (and ``ema_params`` where the checkpoint has EMA weights) in
    the flax layout of the port's checkpoints, the translated config (or
    ``config``) and the checkpoint's epoch (or ``epoch``)."""
    payload = load_reference_checkpoint(ckpt_path)
    hparams = payload.get("hyper_parameters", {})
    cfg = config or translate_hparams(dict(hparams))
    built = build_model(cfg, device="cpu")
    if type(built.module).__name__ != "DiffUnet":
        raise NotImplementedError(
            "reference checkpoint import currently supports DiffUnet backbones"
        )

    state_dict = payload.get("state_dict", payload)
    raw = _tensors(strip_prefixes(state_dict, use_ema=False))

    def port_params(ref_state: dict) -> dict:
        return torch_to_flax(import_torch_state_dict(built.module, ref_state))

    state: dict[str, Any] = {"params": port_params(raw)}
    ema = {k: v for k, v in _tensors(strip_prefixes(state_dict, use_ema=True)).items()
           if k in raw}
    if ema and any(k.startswith("ema_model.") for k in state_dict):
        state["ema_params"] = port_params(ema)
    elif "ema_state_dict" in payload:
        ema_sd = _tensors(strip_prefixes(payload["ema_state_dict"], use_ema=False))
        ema_sd = {k[len("module."):] if k.startswith("module.") else k: v
                  for k, v in ema_sd.items()}
        ema_sd.pop("n_averaged", None)
        if ema_sd:
            state["ema_params"] = port_params(ema_sd)

    ep = epoch if epoch is not None else int(payload.get("epoch", 0))
    return save_checkpoint(out_path, state, cfg, epoch=ep, kind="imported")


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert a reference Lightning .ckpt (DiffUnet) "
                                            "into a checkpoint of the port.")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epoch", type=int, default=None)
    args = p.parse_args(argv)
    out = convert(args.ckpt, args.out, epoch=args.epoch)
    print(f"Imported -> {out}")


if __name__ == "__main__":
    main()
