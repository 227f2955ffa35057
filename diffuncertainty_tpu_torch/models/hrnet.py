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
BatchNorm and the upsample run in the input's dtype (float32). Upsampling is
``F.interpolate`` bilinear, which agrees with ``jax.image.resize`` for the
integer factors (2, 4, 8) the network uses, edges included.

The final dropout is elementwise on each branch's features (keep
``1 - final_dropout``, scale ``1/keep``), always live when its rate is
positive, one draw per branch over all rows from the ``torch.Generator``
passed to ``forward`` (``HRNet.draw_keep``), or, given a
``models/unet.py::SameDropout`` (the sampler's ``same_dropout``), one draw
per member and image reused by its samples. ``stage_dropout`` (which the
factory leaves at zero) puts a ``ChannelDropout`` of its branch's rate after
the first BatchNorm of every block of stages 3 and 4, as the JAX model's
``BasicBlock(dropout=...)`` does, drawn from the same generator.

``forward(x, generator)`` normalizes by the running statistics (the JAX
model's ``train=False``). ``forward(x, generator, train=True)`` normalizes
each BatchNorm's input by its batch statistics (the mean and the biased
variance over N, H and W, in float32 even for bf16 input, as flax's
``BatchNorm`` takes them; ``F.batch_norm`` with no running buffers, so one
fused kernel each way) and returns, in ``UnetOutput.batch_stats``, the
running statistics after this batch (``0.9 * running + 0.1 * batch``,
flax's momentum 0.9; the batch's variance by ``torch.var_mean``, biased,
not the unbiased one ``F.batch_norm`` would write) by state_dict name,
detached. flax takes the variance as ``max(E[x^2] - mean^2, 0)``, which
differs from the two-pass variance by rounding alone. The forward writes no buffer: the caller commits
the update (``train/loop.py``), as flax's ``mutable=["batch_stats"]`` hands
it back, so a recompute of the forward (``trainer.remat``) cannot apply it
twice.

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

from ..parallel.mesh import all_reduce_sum, draw_rows
from .unet import ChannelDropout, SameDropout, UnetOutput

MOMENTUM = 0.9  # flax's convention (torch momentum 0.1)


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
    """BatchNorm over NCHW channels: float32 math, output rounded to
    ``dtype``. With ``batch_stats`` (a dict: the train mode) it normalizes by
    the batch's statistics and records ``batch_stats[self] = (mean, var)``,
    the batch's float32 (at least) mean and biased variance; else by the
    running ones. With ``group`` (a data-parallel process group, set by the
    trainer through :func:`sync_batch_stats`) the batch is the group's global
    batch: the per-channel (sum, sum of squares, count) are summed over it
    before the normalization, and the variance is flax's
    ``max(E[x^2] - mean^2, 0)``."""

    group = None

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                batch_stats: dict | None = None) -> torch.Tensor:
        x = x.to(dtype)
        if batch_stats is None:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        if self.group is not None:
            return self._global_batch_norm(x, dtype, batch_stats)
        # normalized by the batch's biased variance, no buffer touched
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.promote_types(dtype, torch.float32)),
                                       dim=(0, 2, 3), unbiased=False)
        batch_stats[self] = (mean, var)
        return y


    def _global_batch_norm(self, x: torch.Tensor, dtype: torch.dtype,
                           batch_stats: dict) -> torch.Tensor:
        xf = x.to(torch.promote_types(dtype, torch.float32))
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=xf.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                         count]), self.group)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        batch_stats[self] = (mean.detach(), var.detach())
        return y.to(dtype)


def sync_batch_stats(module: nn.Module, group) -> None:
    """Take every BatchNorm's train-mode statistics over ``group``'s global
    batch (None: this rank's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to (h, w), ``align_corners=False``."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm and an identity residual (every HRModule
    block keeps its branch's width and resolution, so the JAX block's
    downsample never exists here); with ``dropout`` > 0 a ``ChannelDropout``
    after the first BatchNorm's ReLU."""

    def __init__(self, planes: int, dropout: float = 0.0):
        super().__init__()
        self.conv1 = Conv(planes, planes, 3)
        self.bn1 = BatchNorm(planes)
        self.dropout = ChannelDropout(dropout) if dropout > 0.0 else None
        self.conv2 = Conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)

    def forward(self, x, dtype, stats=None, generator=None):
        out = F.relu(self.bn1(self.conv1(x, dtype), dtype, stats))
        if self.dropout is not None:  # channels last: the NHWC view
            out = self.dropout(out.permute(0, 2, 3, 1), generator).permute(0, 3, 1, 2)
        return F.relu(self.bn2(self.conv2(out, dtype), dtype, stats) + x)


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

    def forward(self, x, dtype, stats=None):
        out = F.relu(self.bn1(self.conv1(x, dtype), dtype, stats))
        out = F.relu(self.bn2(self.conv2(out, dtype), dtype, stats))
        out = self.bn3(self.conv3(out, dtype), dtype, stats)
        residual = (x if self.down_conv is None
                    else self.down_bn(self.down_conv(x, dtype), dtype, stats))
        return F.relu(out + residual)


class HRModule(nn.Module):
    """One HighResolutionModule: ``num_blocks`` BasicBlocks per branch (with
    branch i's ``dropout[i]``), then SUM fusion ``out_i = relu(sum_j f_ij(y_j))``."""

    def __init__(self, num_channels: tuple[int, ...], num_blocks: int,
                 dropout: tuple[float, ...] | None = None):
        super().__init__()
        self.num_channels, self.num_blocks = tuple(num_channels), num_blocks
        n = len(num_channels)
        for i, ch in enumerate(num_channels):
            for b in range(num_blocks):
                setattr(self, f"branch{i}_block{b}", BasicBlock(ch, dropout[i] if dropout else 0.0))
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

    def forward(self, xs: list[torch.Tensor], dtype, stats=None,
                generator=None) -> list[torch.Tensor]:
        n = len(self.num_channels)
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.num_blocks):
                x = getattr(self, f"branch{i}_block{b}")(x, dtype, stats, generator)
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
                    t = upsample_to(getattr(self, f"fuse{i}_{j}_bn")(t, dtype, stats), h, w)
                else:  # higher resolution -> chain of stride-2 convs
                    t = ys[j]
                    for k in range(i - j):
                        t = getattr(self, f"fuse{i}_{j}_down{k}_conv")(t, dtype)
                        t = getattr(self, f"fuse{i}_{j}_down{k}_bn")(t, dtype, stats)
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
            # the reference's DROPOUT: stages 3 and 4 only
            drop = tuple(spec.stage_dropout[i] if i < len(spec.stage_dropout) else 0.0
                         for i in range(len(channels))) if s >= 1 else None
            for m in range(spec.num_modules[s]):
                setattr(self, f"stage{s + 2}_mod{m}", HRModule(channels, spec.num_blocks, drop))
            prev = list(channels)
        feat = sum(spec.stage_channels[-1])
        self._head("last", feat, num_classes)
        if ssn:
            self._head("ssn_factor", feat, num_classes * ssn_rank)
        for name, module in self.named_modules():
            if isinstance(module, ChannelDropout):
                module.path = name

    def _head(self, name: str, feat: int, out: int) -> None:
        # torch nn.Conv2d defaults: both head convs carry a bias
        setattr(self, f"{name}_conv1", Conv(feat, feat, 1, bias=True))
        setattr(self, f"{name}_bn", BatchNorm(feat))
        setattr(self, f"{name}_conv2", Conv(feat, out, 1, bias=True))

    def _run_head(self, name: str, feats: torch.Tensor, stats=None) -> torch.Tensor:
        # flax's promote_dtype: the features' dtype and the weights'
        dt = torch.promote_types(feats.dtype, getattr(self, f"{name}_conv1").weight.dtype)
        t = getattr(self, f"{name}_conv1")(feats, dt)
        t = F.relu(getattr(self, f"{name}_bn")(t, dt, stats))
        return getattr(self, f"{name}_conv2")(t, dt)

    def draw_keep(self, branch: int, shape: tuple[int, ...], generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
        """Boolean keep mask of the final dropout for ``branch``, NHWC ``shape``."""
        return draw_rows(lambda n, g: torch.rand((n,) + tuple(shape[1:]), generator=g,
                                                 device=device), shape[0],
                         generator) < 1.0 - self.spec.final_dropout

    def _keep(self, branch: int, br: torch.Tensor, generator) -> torch.Tensor:
        """The NHWC keep mask of ``branch``'s NCHW features ``br``."""
        shape = (br.shape[0], br.shape[2], br.shape[3], br.shape[1])
        if isinstance(generator, SameDropout):
            return generator.mask(("hrnet", branch), shape, lambda s: self.draw_keep(
                branch, s, generator.generator, br.device))
        return self.draw_keep(branch, shape, generator, br.device)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                *, mean_only: bool = False, train: bool = False) -> UnetOutput:
        spec, dt = self.spec, self.dtype
        stats = {} if train else None  # BatchNorm -> its running statistics after the batch
        orig_dtype = x.dtype
        in_h, in_w = x.shape[1], x.shape[2]
        h = x.to(dt).permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        h = F.relu(self.stem_bn1(self.stem_conv1(h, dt), dt, stats))
        h = F.relu(self.stem_bn2(self.stem_conv2(h, dt), dt, stats))
        for b in range(4):
            h = getattr(self, f"layer1_block{b}")(h, dt, stats)

        branches = [h]
        for s, channels in enumerate(spec.stage_channels):
            new = []
            for i, ch in enumerate(channels):
                conv = getattr(self, f"t{s}_{i}_conv", None)
                if conv is None:
                    new.append(branches[i])
                    continue
                src = branches[i] if i < len(branches) else branches[-1]
                new.append(F.relu(getattr(self, f"t{s}_{i}_bn")(conv(src, dt), dt, stats)))
            for m in range(spec.num_modules[s]):
                new = getattr(self, f"stage{s + 2}_mod{m}")(new, dt, stats, generator)
            branches = new

        if spec.final_dropout > 0.0:
            if generator is None:
                raise ValueError("HRNet's final dropout needs a torch.Generator")
            keep = 1.0 - spec.final_dropout
            zero = torch.zeros((), dtype=dt, device=x.device)
            branches = [torch.where(self._keep(i, br, generator).permute(0, 3, 1, 2),
                                    br / keep, zero) for i, br in enumerate(branches)]

        h0, w0 = branches[0].shape[2], branches[0].shape[3]
        feats = torch.cat([branches[0]] + [upsample_to(b, h0, w0) for b in branches[1:]], dim=1)
        feats = feats.to(orig_dtype)  # heads keep input-dtype numerics

        logits_low = self._run_head("last", feats, stats)
        logits = upsample_to(logits_low, in_h, in_w).permute(0, 2, 3, 1)
        out = UnetOutput(logits=logits, features=feats.permute(0, 2, 3, 1))
        if not self.ssn:
            return self._with_stats(out, stats)

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
            factor = upsample_to(self._run_head("ssn_factor", feats, stats), in_h, in_w)
            factor = factor.permute(0, 2, 3, 1).reshape(b, in_h, in_w, self.ssn_rank,
                                                        self.num_classes)
            out.ssn_cov_factor = factor.transpose(3, 4).reshape(b, -1, self.ssn_rank)
        return self._with_stats(out, stats)

    def _with_stats(self, out: UnetOutput, stats: dict | None) -> UnetOutput:
        """``out`` with the train mode's running statistics by state_dict name."""
        if stats is None:
            return out
        names, running, batch = [], [], []
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm) and mod in stats:
                names += [f"{name}.running_mean", f"{name}.running_var"]
                running += [mod.running_mean, mod.running_var]
                batch += list(stats[mod])
        with torch.no_grad():  # flax's update: momentum * running + (1 - momentum) * batch
            new = torch._foreach_mul(running, MOMENTUM)
            torch._foreach_add_(new, batch, alpha=1.0 - MOMENTUM)
        # a BatchNorm the forward did not reach (the SSN factor head in the
        # mean-only phase) keeps its own, as flax leaves an unused module's
        out.batch_stats = {k: v.detach() for k, v in self.named_buffers()}
        out.batch_stats.update(zip(names, new))
        return out
