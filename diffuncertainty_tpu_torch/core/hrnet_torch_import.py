"""Reference HRNet checkpoint importer (port of
``diffuncertainty_tpu/core/hrnet_torch_import.py``).

Maps reference ``HighResolutionNet`` state dicts
(``uncertainty_modeling/models/hrnet_module.py:408-838``, the HRNetV2
seg_hrnet layout its ImageNet weights use) onto the port's ``models/hrnet.py``
state dict. Both are torch layouts (conv OIHW, BatchNorm weight, bias,
running_mean, running_var), so the import renames keys and checks shapes.

The reference's ``load_weights`` tolerates shape mismatches (pretrained heads
against task heads); ``import_hrnet_state_dict(strict=False)`` does the same:
mismatched or missing entries are skipped, and the port's values stay.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.hrnet import HRNet


def build_hrnet_mapping(model: HRNet) -> list[tuple[str, str]]:
    """(reference key, port key) entries."""
    spec = model.spec
    entries: list[tuple[str, str]] = []

    def conv(tp, pp, bias=False):
        entries.append((f"{tp}.weight", f"{pp}.weight"))
        if bias:
            entries.append((f"{tp}.bias", f"{pp}.bias"))

    def bn(tp, pp):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            entries.append((f"{tp}.{leaf}", f"{pp}.{leaf}"))

    conv("conv1", "stem_conv1")
    bn("bn1", "stem_bn1")
    conv("conv2", "stem_conv2")
    bn("bn2", "stem_bn2")

    # layer1: 4 bottlenecks; block 0 has a downsample
    for b in range(4):
        base, pb = f"layer1.{b}", f"layer1_block{b}"
        for c in ("conv1", "conv2", "conv3"):
            conv(f"{base}.{c}", f"{pb}.{c}")
        for n in ("bn1", "bn2", "bn3"):
            bn(f"{base}.{n}", f"{pb}.{n}")
        if b == 0:
            conv(f"{base}.downsample.0", f"{pb}.down_conv")
            bn(f"{base}.downsample.1", f"{pb}.down_bn")

    # transitions + stages
    prev_channels = [4 * spec.stage1_channels]
    for s, channels in enumerate(spec.stage_channels):
        t = s + 1
        for i, ch in enumerate(channels):
            if i < len(prev_channels):
                if prev_channels[i] != ch:
                    conv(f"transition{t}.{i}.0", f"t{s}_{i}_conv")
                    bn(f"transition{t}.{i}.1", f"t{s}_{i}_bn")
            else:  # new branch: a single stride-2 conv chain element
                conv(f"transition{t}.{i}.0.0", f"t{s}_{i}_conv")
                bn(f"transition{t}.{i}.0.1", f"t{s}_{i}_bn")
        n = len(channels)
        for m in range(spec.num_modules[s]):
            mt, mp = f"stage{s + 2}.{m}", f"stage{s + 2}_mod{m}"
            for i in range(n):
                for blk in range(spec.num_blocks):
                    bt, bp = f"{mt}.branches.{i}.{blk}", f"{mp}.branch{i}_block{blk}"
                    conv(f"{bt}.conv1", f"{bp}.conv1")
                    bn(f"{bt}.bn1", f"{bp}.bn1")
                    conv(f"{bt}.conv2", f"{bp}.conv2")
                    bn(f"{bt}.bn2", f"{bp}.bn2")
            if n > 1:
                for i in range(n):
                    for j in range(n):
                        if j > i:
                            conv(f"{mt}.fuse_layers.{i}.{j}.0", f"{mp}.fuse{i}_{j}_conv")
                            bn(f"{mt}.fuse_layers.{i}.{j}.1", f"{mp}.fuse{i}_{j}_bn")
                        elif j < i:
                            for k in range(i - j):
                                conv(f"{mt}.fuse_layers.{i}.{j}.{k}.0",
                                     f"{mp}.fuse{i}_{j}_down{k}_conv")
                                bn(f"{mt}.fuse_layers.{i}.{j}.{k}.1",
                                   f"{mp}.fuse{i}_{j}_down{k}_bn")
        prev_channels = list(channels)

    # heads
    conv("last_layer.0", "last_conv1", bias=True)
    bn("last_layer.1", "last_bn")
    conv("last_layer.3", "last_conv2", bias=True)
    if model.ssn:
        conv("cov_factor_conv.0", "ssn_factor_conv1", bias=True)
        bn("cov_factor_conv.1", "ssn_factor_bn")
        conv("cov_factor_conv.3", "ssn_factor_conv2", bias=True)
    return entries


def import_hrnet_state_dict(model: HRNet, state_dict: dict, *,
                            strict: bool = True) -> dict[str, torch.Tensor]:
    """A copy of ``model``'s state dict filled with the reference weights
    (numpy arrays or tensors); load it with ``model.load_state_dict``."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    consumed: set[str] = set()
    for ref_key, port_key in build_hrnet_mapping(model):
        ok, have = port_key in out, ref_key in state_dict
        if not ok or not have:
            if strict and ok != have:
                raise KeyError(f"Mapping mismatch: torch '{ref_key}' present={have}, "
                               f"port '{port_key}' present={ok}")
            continue
        w = torch.as_tensor(np.asarray(state_dict[ref_key]), dtype=torch.float32)
        expect = out[port_key].shape
        if tuple(w.shape) != tuple(expect):
            if strict:
                raise ValueError(f"Shape mismatch {ref_key} -> {port_key}: "
                                 f"{tuple(w.shape)} vs {tuple(expect)}")
            continue
        out[port_key] = w.to(out[port_key].device)
        consumed.add(ref_key)
    if strict:
        unused = {k for k in state_dict if k not in consumed and "num_batches_tracked" not in k}
        if unused:
            raise KeyError(f"Unmapped torch parameters: {sorted(unused)[:8]} ...")
    return out
