"""HRNetV2 segmentation backbone (port of ``diffuncertainty_tpu/models/hrnet.py``).

Stem of two stride-2 3x3 convs, four Bottlenecks, then three stages of
parallel branches at 1/4..1/32 resolution fused by SUM (stride-2 conv chains
downward, 1x1 conv + bilinear upsample upward, ``align_corners=False``), the
four branches concatenated at 1/4 resolution, a 1x1 conv head and a bilinear
upsample to the input size. Submodules carry the flax names (``stem_conv1``,
``layer1_block0``, ``stage3_mod0.branch1_block2``, ``fuse2_0_down1_conv``,
``t1_2_conv``, ``last_conv1``, ...), so the state_dict keys are the flax
paths with '.' for '/' (``core/params.py``); the BatchNorms' running
statistics are buffers fed from the flax ``batch_stats`` collection.

The public layout is NHWC like the JAX model; inside, tensors are NCHW views
of channels-last memory (the layout cuDNN takes as is). Parameters and
BatchNorm statistics stay float32. ``dtype`` is the compute dtype of the
backbone: convs run in it (weights cast per call, as flax's
``promote_dtype`` does), and each BatchNorm normalizes in float32 and rounds
its output to it, as flax's ``BatchNorm(dtype=...)`` does. The features are
cast back to the input's dtype before the heads, so the head convs, their
BatchNorm and the upsample run in the input's dtype (float32). BatchNorm
always uses its running statistics (inference only). Upsampling is
``F.interpolate`` bilinear, which agrees with ``jax.image.resize`` for the
integer factors (2, 4, 8) the network uses, edges included.

The final dropout is elementwise on each branch's features (keep
``1 - final_dropout``, scale ``1/keep``), always live when its rate is
positive, one draw per branch over all rows from the ``torch.Generator``
passed to ``forward`` (``HRNet.draw_keep``). ``stage_dropout`` (per-branch
channel dropout in stages 3 and 4), which the factory leaves at zero, is
not ported and raises.

With ``ssn=True`` the SSN heads of the reference are kept, quirk included:
the mean and the diagonal both come from the ``last`` head (hrnet
``:640-660``), the low-rank factor from an ``ssn_factor`` head.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .unet import UnetOutput


class Conv(nn.Module):
    """Bias-free ``k x k`` conv (padding ``k // 2``) on NCHW input, or a 1x1
    conv with a bias (the heads); weight OIHW. A strided 1x1 conv samples
    every ``stride``-th pixel, as the JAX ``MemberConv`` does."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.padding = stride, k // 2
        # lecun normal, the flax default; serving loads trained weights over it
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k) / math.sqrt(cin * k * k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight.to(dtype=dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), w, b, stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm over NCHW channels with the running statistics:
    float32 math, output rounded to ``dtype`` (momentum 0.9 in flax terms is
    training-only and not ported)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.batch_norm(x.to(dtype), self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to (h, w), ``align_corners=False``."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm and an identity residual (every HRModule
    block keeps its branch's width and resolution, so the JAX block's
    downsample never exists here)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = Conv(planes, planes, 3)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)

    def forward(self, x, dtype):
        out = F.relu(self.bn1(self.conv1(x, dtype), dtype))
        return F.relu(self.bn2(self.conv2(out, dtype), dtype) + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, out, 1)
        self.bn3 = BatchNorm(out)
        if stride != 1 or cin != out:
            self.down_conv = Conv(cin, out, 1, stride)
            self.down_bn = BatchNorm(out)
        else:
            self.down_conv = None

    def forward(self, x, dtype):
        out = F.relu(self.bn1(self.conv1(x, dtype), dtype))
        out = F.relu(self.bn2(self.conv2(out, dtype), dtype))
        out = self.bn3(self.conv3(out, dtype), dtype)
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x, dtype), dtype)
        return F.relu(out + residual)


class HRModule(nn.Module):
    """One HighResolutionModule: ``num_blocks`` BasicBlocks per branch, then
    SUM fusion ``out_i = relu(sum_j f_ij(y_j))``."""

    def __init__(self, num_channels: tuple[int, ...], num_blocks: int):
        super().__init__()
        self.num_channels, self.num_blocks = tuple(num_channels), num_blocks
        n = len(num_channels)
        for i, ch in enumerate(num_channels):
            for b in range(num_blocks):
                setattr(self, f"branch{i}_block{b}", BasicBlock(ch))
        if n == 1:
            return
        for i in range(n):
            for j in range(n):
                if j > i:
                    setattr(self, f"fuse{i}_{j}_conv", Conv(num_channels[j], num_channels[i], 1))
                    setattr(self, f"fuse{i}_{j}_bn", BatchNorm(num_channels[i]))
                elif j < i:
                    for k in range(i - j):
                        last = k == i - j - 1
                        ch = num_channels[i] if last else num_channels[j]
                        setattr(self, f"fuse{i}_{j}_down{k}_conv", Conv(num_channels[j], ch, 3, 2))
                        setattr(self, f"fuse{i}_{j}_down{k}_bn", BatchNorm(ch))

    def forward(self, xs: list[torch.Tensor], dtype) -> list[torch.Tensor]:
        n = len(self.num_channels)
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.num_blocks):
                x = getattr(self, f"branch{i}_block{b}")(x, dtype)
            ys.append(x)
        if n == 1:
            return ys
        outs = []
        for i in range(n):
            h, w = ys[i].shape[2], ys[i].shape[3]
            acc = None
            for j in range(n):
                if j == i:
                    t = ys[j]
                elif j > i:  # lower resolution -> 1x1 conv + upsample
                    t = getattr(self, f"fuse{i}_{j}_conv")(ys[j], dtype)
                    t = upsample_to(getattr(self, f"fuse{i}_{j}_bn")(t, dtype), h, w)
                else:  # higher resolution -> chain of stride-2 convs
                    t = ys[j]
                    for k in range(i - j):
                        t = getattr(self, f"fuse{i}_{j}_down{k}_conv")(t, dtype)
                        t = getattr(self, f"fuse{i}_{j}_down{k}_bn")(t, dtype)
                        if k != i - j - 1:
                            t = F.relu(t)
                acc = t if acc is None else acc + t
            outs.append(F.relu(acc))
        return outs


@dataclasses.dataclass(frozen=True)
class HRNetSpec:
    width: int = 24  # hrnet-s: 24 (stage1 32); hrnet-m: 48 (stage1 64)
    stage1_channels: int = 32
    num_modules: tuple[int, int, int] = (1, 4, 3)  # stages 2..4
    num_blocks: int = 4
    stage_dropout: tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    final_dropout: float = 0.0

    @property
    def stage_channels(self):
        w = self.width
        return ((w, 2 * w), (w, 2 * w, 4 * w), (w, 2 * w, 4 * w, 8 * w))


class HRNet(nn.Module):
    """HRNetV2 on NHWC input; ``forward(x, generator)`` returns a
    :class:`UnetOutput` with NHWC ``logits`` and ``features`` (the 1/4
    resolution concat, in the input's dtype)."""

    def __init__(self, num_classes: int, spec: HRNetSpec = HRNetSpec(), *, in_channels: int = 3,
                 ssn: bool = False, ssn_rank: int = 10, ssn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if any(spec.stage_dropout):
            raise NotImplementedError("HRNet stage dropout is not ported")
        self.num_classes, self.spec, self.dtype = num_classes, spec, dtype
        self.ssn, self.ssn_rank, self.ssn_eps = ssn, ssn_rank, ssn_eps
        self.stem_conv1 = Conv(in_channels, 64, 3, 2)
        self.stem_bn1 = BatchNorm(64)
        self.stem_conv2 = Conv(64, 64, 3, 2)
        self.stem_bn2 = BatchNorm(64)
        cin = 64
        for b in range(4):
            setattr(self, f"layer1_block{b}", Bottleneck(cin, spec.stage1_channels))
            cin = spec.stage1_channels * Bottleneck.expansion
        prev = [cin]
        for s, channels in enumerate(spec.stage_channels):
            for i, ch in enumerate(channels):
                if i < len(prev):
                    if prev[i] != ch:
                        setattr(self, f"t{s}_{i}_conv", Conv(prev[i], ch, 3))
                        setattr(self, f"t{s}_{i}_bn", BatchNorm(ch))
                else:  # new lower-resolution branch from the last existing one
                    setattr(self, f"t{s}_{i}_conv", Conv(prev[-1], ch, 3, 2))
                    setattr(self, f"t{s}_{i}_bn", BatchNorm(ch))
            for m in range(spec.num_modules[s]):
                setattr(self, f"stage{s + 2}_mod{m}", HRModule(channels, spec.num_blocks))
            prev = list(channels)
        feat = sum(spec.stage_channels[-1])
        self._head("last", feat, num_classes)
        if ssn:
            self._head("ssn_factor", feat, num_classes * ssn_rank)

    def _head(self, name: str, feat: int, out: int) -> None:
        # torch nn.Conv2d defaults: both head convs carry a bias
        setattr(self, f"{name}_conv1", Conv(feat, feat, 1, bias=True))
        setattr(self, f"{name}_bn", BatchNorm(feat))
        setattr(self, f"{name}_conv2", Conv(feat, out, 1, bias=True))

    def _run_head(self, name: str, feats: torch.Tensor) -> torch.Tensor:
        dt = feats.dtype
        t = getattr(self, f"{name}_conv1")(feats, dt)
        t = F.relu(getattr(self, f"{name}_bn")(t, dt))
        return getattr(self, f"{name}_conv2")(t, dt)

    def draw_keep(self, branch: int, shape: tuple[int, ...], generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
        """Boolean keep mask of the final dropout for ``branch``, NHWC ``shape``."""
        return torch.rand(shape, generator=generator, device=device) < 1.0 - self.spec.final_dropout

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                *, mean_only: bool = False) -> UnetOutput:
        spec, dt = self.spec, self.dtype
        orig_dtype = x.dtype
        in_h, in_w = x.shape[1], x.shape[2]
        h = x.to(dt).permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        h = F.relu(self.stem_bn1(self.stem_conv1(h, dt), dt))
        h = F.relu(self.stem_bn2(self.stem_conv2(h, dt), dt))
        for b in range(4):
            h = getattr(self, f"layer1_block{b}")(h, dt)

        branches = [h]
        for s, channels in enumerate(spec.stage_channels):
            new = []
            for i, ch in enumerate(channels):
                conv = getattr(self, f"t{s}_{i}_conv", None)
                if conv is None:
                    new.append(branches[i])
                    continue
                src = branches[i] if i < len(branches) else branches[-1]
                new.append(F.relu(getattr(self, f"t{s}_{i}_bn")(conv(src, dt), dt)))
            for m in range(spec.num_modules[s]):
                new = getattr(self, f"stage{s + 2}_mod{m}")(new, dt)
            branches = new

        if spec.final_dropout > 0.0:
            if generator is None:
                raise ValueError("HRNet's final dropout needs a torch.Generator")
            keep = 1.0 - spec.final_dropout
            zero = torch.zeros((), dtype=dt, device=x.device)
            branches = [
                torch.where(self.draw_keep(i, (br.shape[0], br.shape[2], br.shape[3], br.shape[1]),
                                           generator, x.device).permute(0, 3, 1, 2),
                            br / keep, zero)
                for i, br in enumerate(branches)]

        h0, w0 = branches[0].shape[2], branches[0].shape[3]
        feats = torch.cat([branches[0]] + [upsample_to(b, h0, w0) for b in branches[1:]], dim=1)
        feats = feats.to(orig_dtype)  # heads keep input-dtype numerics

        logits_low = self._run_head("last", feats)
        logits = upsample_to(logits_low, in_h, in_w).permute(0, 2, 3, 1)
        out = UnetOutput(logits=logits, features=feats.permute(0, 2, 3, 1))
        if not self.ssn:
            return out

        # SSN: the reference reuses the last head for mean AND cov (hrnet :640-660)
        b = logits.shape[0]
        out.ssn_mean = logits.reshape(b, -1)
        cov_diag = upsample_to(F.softplus(logits_low) + self.ssn_eps, in_h, in_w)
        cov_diag = torch.nan_to_num(cov_diag.permute(0, 2, 3, 1), nan=1.0, posinf=1e6,
                                    neginf=self.ssn_eps)
        out.ssn_cov_diag = cov_diag.clamp(min=self.ssn_eps).reshape(b, -1)
        if mean_only:
            out.ssn_cov_factor = torch.zeros((b, out.ssn_mean.shape[1], self.ssn_rank),
                                             dtype=out.ssn_mean.dtype, device=x.device)
        else:
            factor = upsample_to(self._run_head("ssn_factor", feats), in_h, in_w)
            factor = factor.permute(0, 2, 3, 1).reshape(b, in_h, in_w, self.ssn_rank,
                                                        self.num_classes)
            out.ssn_cov_factor = factor.transpose(3, 4).reshape(b, -1, self.ssn_rank)
        return out
