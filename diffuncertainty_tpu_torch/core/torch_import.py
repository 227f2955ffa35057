"""Reference DiffUnet checkpoint importer (port of
``diffuncertainty_tpu/core/torch_import.py``).

Maps a reference ``DiffUnet`` state dict (``diff_unet2D_module.py:141-647``)
onto the port's ``models/unet.py::DiffUnet`` state dict. The mapping mirrors
the constructor's bookkeeping as the JAX module's does: the reference's
``input_blocks[i]`` / ``middle_block[k]`` / ``output_blocks[i]`` sequences
become ``enc{j}_res`` / ``mid{k}_res`` / ``dec{j}_res`` (``_mlp``, ``_attn``),
the heads ``out_norm``/``out_conv`` and the SSN's ``ssn_cov_*`` and
``ssn_factor_*``. Both sides are torch layouts, so most entries are renames:

- Conv2d ``(O, I, kh, kw)`` and Linear ``(O, I)`` keep their layout;
- Conv1d 1x1 (the attention's qkv and proj_out) ``(O, I, 1)`` -> ``(O, I)``
  (the port's ``Dense``);
- GroupNorm ``weight``/``bias`` keep their names.

Inputs are the reference's tensors or numpy arrays keyed by its names (strip
the Lightning ``model.`` / ``ema_model.module.`` prefixes first with
``strip_prefixes``, as the reference loader does, ``test_utils.py:618-668``).
A reference key that maps to nothing raises, and so does a port key that no
reference key fills.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.unet import DiffUnet


def _conv1d(w):  # (O, I, 1) -> (O, I)
    return w[..., 0]


def _ident(w):
    return w


class _Mapping:
    def __init__(self):
        self.entries: list[tuple[str, str, Callable]] = []

    def add(self, ref_key: str, port_key: str, transform=_ident):
        self.entries.append((ref_key, port_key, transform))

    def layer(self, ref_prefix: str, port_name: str, transform=_ident):
        """A conv, linear or GroupNorm: ``weight`` and ``bias``."""
        self.add(f"{ref_prefix}.weight", f"{port_name}.weight", transform)
        self.add(f"{ref_prefix}.bias", f"{port_name}.bias")


def build_mapping(model: DiffUnet) -> _Mapping:
    """Enumerate (reference key, port key, transform) for a DiffUnet."""
    cfg = model.config
    m = _Mapping()
    channel_mult = tuple(cfg["channel_mult"])
    n_levels = len(channel_mult)
    nres = cfg["num_res_blocks"]
    nres = (nres,) * n_levels if isinstance(nres, int) else tuple(nres)
    attn_res = {r + n_levels if r < 0 else r for r in cfg["attention_resolutions"]}
    spec = cfg["dropout_spec"]
    diffusion, mlp_attn = cfg["diffusion"], cfg["mlp_attn"]

    def map_resblock(tp: str, pp: str, stage: str, depth: int):
        rate = spec.stage_rate(stage, depth)
        # in_layers: [GN, act, (dropout), conv]
        conv_idx = 3 if (not spec.per_block and rate > 0.0) else 2
        m.layer(f"{tp}.in_layers.0", f"{pp}.in_norm")
        m.layer(f"{tp}.in_layers.{conv_idx}", f"{pp}.in_conv")
        if diffusion:
            m.layer(f"{tp}.emb_layers.1", f"{pp}.emb_proj")
        m.layer(f"{tp}.out_layers.0", f"{pp}.out_norm")
        m.layer(f"{tp}.out_layers.3", f"{pp}.out_conv")
        # present only where the channels change: absent on both sides is fine
        m.layer(f"{tp}.skip_connection", f"{pp}.skip_conv")

    def map_mlpblock(tp: str, pp: str):
        m.layer(f"{tp}.in_layers.0", f"{pp}.in_norm")
        m.layer(f"{tp}.in_layers.1", f"{pp}.in_conv")
        if diffusion:
            m.layer(f"{tp}.emb_layers", f"{pp}.emb_proj")
        m.layer(f"{tp}.out_layers.1", f"{pp}.out_conv")
        m.layer(f"{tp}.skip_connection", f"{pp}.skip_conv")

    def map_attention(tp: str, pp: str):
        m.layer(f"{tp}.norm", f"{pp}.norm")
        m.layer(f"{tp}.qkv", f"{pp}.qkv", _conv1d)
        m.layer(f"{tp}.proj_out", f"{pp}.proj_out", _conv1d)

    def map_block(tp_seq: str, pp_base: str, stage: str, depth: int):
        """One TimestepEmbedSequential: (MLP|Res)Block [+ Attention]."""
        if depth in attn_res and mlp_attn:
            map_mlpblock(f"{tp_seq}.0", f"{pp_base}_mlp")
            map_attention(f"{tp_seq}.1", f"{pp_base}_attn")
        else:
            map_resblock(f"{tp_seq}.0", f"{pp_base}_res", stage, depth)
            if depth in attn_res:
                map_attention(f"{tp_seq}.1", f"{pp_base}_attn")

    if diffusion:
        m.layer("time_embed.0", "time_embed_0")
        m.layer("time_embed.2", "time_embed_1")

    # ---- encoder ----
    m.layer("input_blocks.0.0", "input_conv")
    torch_i, block_idx, resolution = 1, 0, 0
    for level in range(n_levels):
        for _ in range(nres[level]):
            map_block(f"input_blocks.{torch_i}", f"enc{block_idx}", "encoder", resolution)
            torch_i += 1
            block_idx += 1
        if level != n_levels - 1:
            resolution += 1
            dp = f"input_blocks.{torch_i}.0"
            if cfg["conv_resample"]:
                m.layer(f"{dp}.op", f"down{resolution}.op")
            m.layer(f"{dp}.channel_mapper", f"down{resolution}.channel_mapper")
            torch_i += 1

    # ---- middle ----
    n_mid = cfg["num_middle_res_blocks"]
    if resolution in attn_res:
        for i in range(n_mid - 1):
            if mlp_attn:
                map_mlpblock(f"middle_block.{2 * i}", f"mid{i}_mlp")
            else:
                map_resblock(f"middle_block.{2 * i}", f"mid{i}_res", "mid", resolution)
            map_attention(f"middle_block.{2 * i + 1}", f"mid{i}_attn")
        last = 2 * (n_mid - 1)
        if mlp_attn:
            map_mlpblock(f"middle_block.{last}", f"mid{n_mid - 1}_mlp")
        else:
            map_resblock(f"middle_block.{last}", f"mid{n_mid - 1}_res", "mid", resolution)
    else:
        for i in range(n_mid):
            map_resblock(f"middle_block.{i}", f"mid{i}_res", "mid", resolution)

    if cfg["encoder_only"]:
        return m

    # ---- decoder ----
    block_idx = 0
    for level, n_res in zip(reversed(range(n_levels)), nres[::-1]):
        for i in range(n_res + 1):
            depth = resolution
            tp = f"output_blocks.{block_idx}"
            map_block(tp, f"dec{block_idx}", "decoder", depth)
            if level and i == n_res:
                resolution -= 1
                up = f"{tp}.{2 if depth in attn_res else 1}"
                m.layer(f"{up}.channel_mapper", f"up{resolution}.channel_mapper")
                if cfg["conv_resample"]:
                    m.layer(f"{up}.conv", f"up{resolution}.conv")
            block_idx += 1

    # ---- heads ----
    m.layer("out.1", "out_norm")
    m.layer("out.3", "out_conv")
    if cfg["ssn"]:
        m.layer("ssn_cov_head.1", "ssn_cov_norm")
        m.layer("ssn_cov_head.3", "ssn_cov_conv")
        m.layer("ssn_factor_head.1", "ssn_factor_norm")
        m.layer("ssn_factor_head.3", "ssn_factor_conv")
    return m


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value)


def import_torch_state_dict(model: DiffUnet, state_dict: dict) -> dict[str, torch.Tensor]:
    """The port's state dict for ``model`` (float32 CPU tensors) from a
    reference state dict.

    Entries present on only one side raise, except the optional skip and
    channel-mapper convs, which exist conditionally on both sides: absent
    on both is fine. Reference keys left over raise, except the diffusion
    process's buffers and, without diffusion, the ``emb_layers`` the
    reference builds anyway (dead parameters)."""
    target = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: dict[str, torch.Tensor] = {}
    consumed: set[str] = set()
    for ref_key, port_key, transform in build_mapping(model).entries:
        have_port, have_ref = port_key in target, ref_key in state_dict
        if not have_port and not have_ref:
            continue  # optional layer absent on both sides
        if have_port != have_ref:
            raise KeyError(f"Mapping mismatch: reference '{ref_key}' present={have_ref}, "
                           f"port '{port_key}' present={have_port}")
        w = transform(_numpy(state_dict[ref_key]))
        if tuple(w.shape) != target[port_key]:
            raise ValueError(f"Shape mismatch for {ref_key} -> {port_key}: {tuple(w.shape)} vs "
                             f"{target[port_key]}")
        out[port_key] = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
        consumed.add(ref_key)

    def allowed_unused(k: str) -> bool:
        return k.startswith("diffusion_process") or (
            not model.config["diffusion"] and ".emb_layers" in k)

    unused = sorted(k for k in state_dict if k not in consumed and not allowed_unused(k))
    if unused:
        raise KeyError(f"Unmapped torch parameters: {unused[:8]} ...")
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters no reference key fills: {missing[:8]} ...")
    return out


def strip_prefixes(state_dict: dict, use_ema: bool = False) -> dict:
    """Strip Lightning prefixes like the reference loader
    (``test_utils.py:618-668``): ``model.`` or ``ema_model.module.``."""
    prefix = "ema_model.module." if use_ema else "model."
    out = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not out:  # already bare
        out = dict(state_dict)
    out.pop("n_averaged", None)  # AveragedModel bookkeeping
    return out
