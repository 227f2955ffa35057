"""ADM-style 2D U-Net ("DiffUnet") for the softmax, diffusion, SSN and
prob-U-Net families (port of ``diffuncertainty_tpu/models/unet.py`` with
every option of the JAX model).

Public layout is NHWC like the JAX model. Convolutions run on NCHW views of
the NHWC tensors (channels-last memory, which cuDNN takes as is); 1x1 convs
and dense layers are channel matmuls on the NHWC tensor. Submodules carry the
flax names (``enc0_res``, ``mid0_attn``, ``enc3_mlp``, ``up2``, ...), so the
state_dict keys are the flax paths with '.' for '/' (``core/params.py``).

Parameters stay float32; ``flax_init_`` draws the JAX model's initial
weights for training (truncated ``lecun_normal`` kernels, zero ResBlock
``out_conv``, attention ``proj_out`` and output heads). ``dtype`` is the
compute dtype the convs, dense layers and attention run in: weights are cast
per call, as flax's ``promote_dtype`` does, unless they already are in it (a
sampler casts a member stack once, ``Conv.compute_dtype``). Every GroupNorm
goes through the hand-written GroupNorm+activation kernel
(``ops/cuda_groupnorm.py``), with float32 statistics and, where SiLU or ReLU
follows the norm, the activation fused in (GELU, the exact erf form as the
JAX model's ``approximate=False``, follows the kernel). The output head runs
in the input's dtype, as in the JAX model, and ends in ``final_act`` (none,
softmax for the diffusion family, tanh or sigmoid).

Options, as the JAX model takes them: ``act`` (silu, relu, gelu) everywhere
the JAX model applies its activation; ``new_upsample_method`` (skips added,
not concatenated; Downsample and Upsample map channels with a 1x1
``channel_mapper`` to the next level's width; bilinear upsampling);
``one_skip_per_reso`` (with ``new_upsample_method`` only: only the
activation before each downsample is a skip); ``mlp_attn`` (an ``MLPBlock``
in place of the ResBlock at the attention levels); ``num_heads_upsample``
(the decoder's head count; -1: ``num_heads``); ``ResBlock.use_conv_skip``
(a 3x3 skip conv where the width changes).

With ``diffusion=True`` the input is ``concat([x_t, image])`` and the forward
takes continuous times ``t``: a sinusoidal embedding through
``time_embed_0`` -> act -> ``time_embed_1`` feeds every ResBlock
(``emb_proj``), added before ``out_norm`` or, with ``use_scale_shift_norm``,
applied as ``norm(h) * (1 + scale) + shift``.

With ``ssn=True`` two more heads of the same form (``ssn_cov``,
``ssn_factor``) give the SSN's low-rank covariance over the flattened logits
(``models/ssn.py``). With ``encoder_only=True`` the network stops after the
middle blocks and builds no decoder or head: the prob-U-Net's latent
encoders. ``forward`` returns a :class:`UnetOutput`, as the JAX model does.

With ``members=M`` (the JAX model's ``members``) every conv, dense layer
and GroupNorm affine carries a leading member axis ``(M, ...)`` (a stacked
ensemble's weights, ``core/params.py::flax_to_torch_stacked``) and the
input is M member-major blocks of rows ``(M*B, H, W, C)``: member m's
weights act on rows ``[m*B, (m+1)*B)`` (``ops/member_fold.py``, the
``(M, C)`` affine of ``ops/cuda_groupnorm.py``). Attention, dropout and the
norm statistics are row-local and see the folded rows as a larger batch.

MC-dropout (``ChannelDropout``) zeroes whole channels with a (B, C) mask and
scales by 1/(1-p). It is always live when its rate is positive and draws from
the ``torch.Generator`` passed to ``forward``, or, given a
:class:`SameDropout`, reuses one draw per member and image (the sampler's
``same_dropout``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.specs import DropoutSpec
from ..ops.attention import qkv_attention
from ..ops.cuda_groupnorm import group_norm_act
from ..ops.member_fold import member_conv2d, member_dense
from ..ops.resample import downsample_avgpool2x, upsample2x
from ..ops.time_embed import timestep_embedding
from ..parallel.mesh import draw_rows


@dataclasses.dataclass
class UnetOutput:
    """Forward results (``UnetOutput`` of the JAX model); unused fields are None."""

    logits: torch.Tensor | None = None  # (B, H, W, out_channels), after final_act
    features: torch.Tensor | None = None  # decoder features, or the mid block's
    ssn_mean: torch.Tensor | None = None  # (B, N) flattened logits, N = H*W*out_channels
    ssn_cov_diag: torch.Tensor | None = None  # (B, N)
    ssn_cov_factor: torch.Tensor | None = None  # (B, N, rank)
    # the HRNet's train mode: its BatchNorms' running statistics after the
    # batch, by state_dict name (``models/hrnet.py``)
    batch_stats: dict[str, torch.Tensor] | None = None


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator,
                  scale: float = 1.0) -> None:
    """flax's ``lecun_normal``: variance_scaling(1, fan_in, truncated normal),
    a normal cut at +-2 sigma whose std is corrected by 1/0.87962566 (the
    std of the standard normal truncated to [-2, 2]) to 1/sqrt(fan_in);
    ``scale`` 2 gives ``kaiming_normal``. Drawn on the generator's device,
    then copied into ``weight``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    draw = torch.empty(weight.shape, device=generator.device)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(draw)


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize ``module``'s leaves in place as the JAX model's ``init``
    does. DiffUnet: conv and dense kernels ``lecun_normal`` (zero where the
    JAX model zero-initializes: every ResBlock ``out_conv``, every attention
    ``proj_out``, the output and SSN heads; ``kaiming_normal``, twice the
    variance, for the prob-U-Net's latent heads), biases 0 (normal with std
    1e-2 for the latent heads), GroupNorm scale 1 and bias 0. HRNet
    (``models/hrnet.py``): every conv kernel ``lecun_normal`` (flax's
    ``nn.Conv`` and the JAX ``MemberConv`` default), the head convs' biases
    0, BatchNorm scale 1 and bias 0, running mean 0 and variance 1. Leaves
    are drawn from ``generator`` in module order."""
    from . import hrnet  # imports this module

    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            with torch.no_grad():
                if m.zero_init:
                    m.weight.zero_()
                else:
                    lecun_normal_(m.weight, m.weight[0].numel(), generator, m.init_scale)
                if m.bias_std:
                    draw = torch.randn(m.bias.shape, generator=generator, device=generator.device)
                    m.bias.copy_(m.bias_std * draw)
                else:
                    m.bias.zero_()
        elif isinstance(m, GroupNorm32):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
        elif isinstance(m, hrnet.Conv):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, hrnet.BatchNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module


def activation(name: str):
    """The network activation ``act`` (JAX ``_act_fn``): silu, relu or the
    exact (erf) gelu."""
    fns = {"silu": F.silu, "relu": F.relu, "gelu": F.gelu}
    if name.lower() not in fns:
        raise ValueError(f"Unsupported activation: {name}")
    return fns[name.lower()]


def _final_act(name: str):
    fns = {"none": lambda x: x, "softmax": lambda x: torch.softmax(x, dim=-1),
           "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    key = (name or "none").lower()
    if key not in fns:
        raise ValueError(f"Unsupported final activation: {name}")
    return fns[key]


class SameDropout:
    """The dropout draws of ``same_dropout`` (JAX ``sampler.py:200, 221``):
    one keep mask per member and image at each dropout site, reused across
    the member's ``rounds`` samples (TTA rounds, diffusion trajectories) and
    across every forward it serves (the diffusion steps). Passed to a
    forward in place of the generator; rows are ``(members, rounds, B)``
    member-major."""

    def __init__(self, generator: torch.Generator, members: int, rounds: int):
        self.generator, self.members, self.rounds = generator, members, rounds
        self._masks: dict = {}

    def mask(self, site, shape: tuple, draw) -> torch.Tensor:
        """The mask of ``shape`` (rows first) at ``site``: ``draw(shape')``
        for one round of each member (``shape'`` = (members * B, ...)) on
        the first call, expanded over the rounds; the same tensor after."""
        if site not in self._masks:
            k, s = self.members, self.rounds
            b, rest = shape[0] // (k * s), tuple(shape[1:])
            if shape[0] != k * s * b:
                raise ValueError(f"rows {shape[0]} are not {k} members x {s} rounds x B")
            m = draw((k * b,) + rest).reshape((k, 1, b) + rest)
            self._masks[site] = m.expand((k, s, b) + rest).reshape(tuple(shape))
        return self._masks[site]


class Conv(nn.Module):
    """``k x k`` conv on NHWC input; weight OIHW, bias (O,), or with
    ``members=M`` (M, O, I, k, k) and (M, O) on member-folded rows.
    ``zero_init`` marks a conv the JAX model initializes to zero,
    ``init_scale`` the variance scale of its kernel's draw and ``bias_std`` a
    bias drawn from a normal (``flax_init_``). ``compute_dtype`` is False
    for a conv that runs in its input's dtype (the output and SSN heads):
    a sampler keeps only the other convs' weights cast to the network's
    compute dtype."""

    def __init__(self, cin: int, cout: int, k: int = 3, *, stride: int = 1,
                 zero_init: bool = False, init_scale: float = 1.0, bias_std: float = 0.0,
                 members: int = 0, compute_dtype: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = k // 2
        self.zero_init = zero_init
        self.init_scale = init_scale
        self.bias_std = bias_std
        self.members = members
        self.compute_dtype = compute_dtype
        lead = (members,) if members else ()
        # an untruncated lecun normal; training draws the flax init
        # (flax_init_), serving loads trained weights over it
        self.weight = nn.Parameter(torch.randn(lead + (cout, cin, k, k)) / math.sqrt(cin * k * k))
        self.bias = nn.Parameter(torch.zeros(lead + (cout,)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if self.members:
            return member_conv2d(x, self.weight.to(dtype), self.bias.to(dtype),
                                 stride=self.stride, pad=self.padding)
        if self.weight.shape[-1] == 1 and self.stride == 1:
            return F.linear(x, self.weight[:, :, 0, 0].to(dtype), self.bias.to(dtype))
        w = self.weight.to(dtype=dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias.to(dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Dense layer over the last axis; weight (O, I), or (M, O, I) with
    ``members=M``."""

    def __init__(self, cin: int, cout: int, *, zero_init: bool = False, members: int = 0):
        super().__init__()
        self.zero_init = zero_init
        self.init_scale, self.bias_std = 1.0, 0.0
        self.members = members
        self.compute_dtype = True
        lead = (members,) if members else ()
        self.weight = nn.Parameter(torch.randn(lead + (cout, cin)) / math.sqrt(cin))
        self.bias = nn.Parameter(torch.zeros(lead + (cout,)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.members:
            return member_dense(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class GroupNorm32(nn.Module):
    """Learned-affine GroupNorm with float32 statistics, then ``act``
    ("none", "silu", "relu" or "gelu"), through the GroupNorm+activation
    kernel: SiLU and ReLU fused in, GELU after it. Affine (C,), or (M, C)
    with ``members=M``."""

    def __init__(self, channels: int, act: str = "none", members: int = 0):
        super().__init__()
        if act not in ("none", "silu", "relu", "gelu"):
            raise ValueError(f"Unsupported activation: {act}")
        self.act = act
        self.members = members
        lead = (members,) if members else ()
        self.weight = nn.Parameter(torch.ones(lead + (channels,)))
        self.bias = nn.Parameter(torch.zeros(lead + (channels,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "gelu":
            return F.gelu(group_norm_act(x, self.weight, self.bias, "none"))
        return group_norm_act(x, self.weight, self.bias, self.act)


class ChannelDropout(nn.Module):
    """torch ``F.dropout2d(training=True)`` on channels-last input: a (B, C)
    keep mask, scale 1/(1-p). Always live when ``rate > 0``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.path = ""  # the flax path, set by DiffUnet (e.g. "enc0_res.out_dropout")

    def draw_mask(self, shape: tuple[int, int], generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
        """Boolean keep mask of ``shape`` (B, C) (per row: ``draw_rows``)."""
        return draw_rows(lambda n, g: torch.rand((n,) + tuple(shape[1:]), generator=g,
                                                 device=device), shape[0],
                         generator) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, generator) -> torch.Tensor:
        """``generator``: a ``torch.Generator``, or a :class:`SameDropout`
        whose masks are reused."""
        if self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError(f"dropout at '{self.path}' needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0], x.shape[-1])
        if isinstance(generator, SameDropout):
            mask = generator.mask(self, shape, lambda s: self.draw_mask(
                s, generator.generator, x.device))
        else:
            mask = self.draw_mask(shape, generator, x.device)
        mask = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ResBlock(nn.Module):
    """Residual block; time-conditioned through ``emb_proj`` when
    ``emb_channels`` is set (the diffusion family). ``use_conv_skip``: a 3x3
    skip conv where the width changes (else 1x1)."""

    def __init__(self, cin: int, cout: int, *, dropout: float, per_block: bool,
                 residual_dropout: float, emb_channels: int = 0,
                 use_scale_shift_norm: bool = False, act: str = "silu",
                 use_conv_skip: bool = False, members: int = 0):
        super().__init__()
        mm = members
        self.use_scale_shift_norm = use_scale_shift_norm
        self.act = activation(act)
        self.in_norm = GroupNorm32(cin, act=act, members=mm)
        self.in_dropout = ChannelDropout(0.0 if per_block else dropout)
        self.in_conv = Conv(cin, cout, 3, members=mm)
        self.emb_proj = None
        if emb_channels:
            self.emb_proj = Dense(emb_channels, 2 * cout if use_scale_shift_norm else cout,
                                  members=mm)
        # scale-shift applies between the norm and the activation, so it cannot fuse
        self.out_norm = GroupNorm32(cout, act="none" if use_scale_shift_norm else act, members=mm)
        self.out_dropout = ChannelDropout(dropout)
        self.out_conv = Conv(cout, cout, 3, zero_init=True, members=mm)
        self.skip_conv = (Conv(cin, cout, 3 if use_conv_skip else 1, members=mm)
                          if cin != cout else None)
        self.residual_dropout = ChannelDropout(residual_dropout)

    def forward(self, x, dtype, generator, emb=None):
        h = self.in_norm(x)
        h = self.in_dropout(h, generator)
        h = self.in_conv(h, dtype)
        if emb is None:
            h = self.out_norm(h)
        else:
            emb_out = self.emb_proj(self.act(emb), dtype).to(h.dtype)[:, None, None, :]
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=-1)
                h = self.act(self.out_norm(h) * (1 + scale) + shift)
            else:
                h = self.out_norm(h + emb_out)
        h = self.out_dropout(h, generator)
        h = self.out_conv(h, dtype)
        skip = x if self.skip_conv is None else self.skip_conv(x, dtype)
        return self.residual_dropout(skip, generator) + h


class MLPBlock(nn.Module):
    """The SiD-style MLP block of ``mlp_attn`` (JAX ``models/unet.py:295-333``):
    norm, a 1x1 conv to ``expansion * cin`` channels, act, the time
    embedding (no activation on it), dropout, a 1x1 conv back, and the skip."""

    def __init__(self, cin: int, cout: int, *, dropout: float, emb_channels: int = 0,
                 use_scale_shift_norm: bool = False, act: str = "silu",
                 expansion_factor: int = 4, members: int = 0):
        super().__init__()
        mm = members
        c = expansion_factor * cin
        self.use_scale_shift_norm = use_scale_shift_norm
        self.act = activation(act)
        self.in_norm = GroupNorm32(cin, act="none", members=mm)
        self.in_conv = Conv(cin, c, 1, members=mm)
        self.emb_proj = None
        if emb_channels:
            self.emb_proj = Dense(emb_channels, 2 * c if use_scale_shift_norm else c, members=mm)
        self.dropout = ChannelDropout(dropout)
        self.out_conv = Conv(c, cout, 1, members=mm)
        self.skip_conv = Conv(cin, cout, 1, members=mm) if cin != cout else None

    def forward(self, x, dtype, generator, emb=None):
        h = self.act(self.in_conv(self.in_norm(x), dtype))
        if emb is not None:
            emb_out = self.emb_proj(emb, dtype).to(h.dtype)[:, None, None, :]
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=-1)
                h = h * (1 + scale) + shift
            else:
                h = h + emb_out
        h = self.out_conv(self.dropout(h, generator), dtype)
        skip = x if self.skip_conv is None else self.skip_conv(x, dtype)
        return skip + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H*W tokens of an NHWC map."""

    def __init__(self, channels: int, num_heads: int, members: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels, act="none", members=members)
        self.qkv = Dense(channels, 3 * channels, members=members)
        self.proj_out = Dense(channels, channels, zero_init=True, members=members)

    def forward(self, x, dtype):
        b, hh, ww, c = x.shape
        xt = x.reshape(b, hh * ww, c)
        qkv = self.qkv(self.norm(xt), dtype)
        h = self.proj_out(qkv_attention(qkv, self.num_heads), dtype)
        return (xt + h).reshape(b, hh, ww, c)


class Downsample(nn.Module):
    """A stride-2 conv or a 2x2 average pool, then a 1x1 ``channel_mapper``
    to ``channels_out`` where it differs."""

    def __init__(self, channels: int, use_conv: bool, channels_out: int | None = None,
                 members: int = 0):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, members=members) if use_conv else None
        self.channel_mapper = None
        if channels_out is not None and channels_out != channels:
            self.channel_mapper = Conv(channels, channels_out, 1, members=members)

    def forward(self, x, dtype):
        x = downsample_avgpool2x(x) if self.op is None else self.op(x, dtype)
        return x if self.channel_mapper is None else self.channel_mapper(x, dtype)


class Upsample(nn.Module):
    """A 1x1 ``channel_mapper`` to ``channels_out`` where it differs, the 2x
    upsample (``mode`` nearest or bilinear), then a 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool, channels_out: int | None = None,
                 mode: str = "nearest", members: int = 0):
        super().__init__()
        self.mode = mode
        self.channel_mapper = None
        if channels_out is not None and channels_out != channels:
            self.channel_mapper = Conv(channels, channels_out, 1, members=members)
            channels = channels_out
        self.conv = Conv(channels, channels, 3, members=members) if use_conv else None

    def forward(self, x, dtype):
        if self.channel_mapper is not None:
            x = self.channel_mapper(x, dtype)
        x = upsample2x(x, self.mode)
        return x if self.conv is None else self.conv(x, dtype)


class DiffUnet(nn.Module):
    """The U-Net of the softmax, diffusion, SSN and prob-U-Net families;
    ``config`` holds the arguments it was built with."""

    def __init__(
        self,
        *,
        in_channels: int = 3,
        out_channels: int = 2,
        model_channels: int = 32,
        num_res_blocks: tuple[int, ...] = (2, 2, 2, 2),
        num_middle_res_blocks: int = 2,
        attention_resolutions: tuple[int, ...] = (-2, -1),
        channel_mult: tuple[int, ...] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = 4,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        diffusion: bool = False,
        final_act: str = "none",
        one_skip_per_reso: bool = False,
        new_upsample_method: bool = False,
        mlp_attn: bool = False,
        act: str = "silu",
        ssn: bool = False,
        ssn_rank: int = 10,
        ssn_eps: float = 1e-5,
        encoder_only: bool = False,
        dropout_spec: DropoutSpec = DropoutSpec(),
        dtype: torch.dtype = torch.float32,
        members: int = 0,
    ):
        config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        super().__init__()
        self.config = config
        self.final_act_fn = _final_act(final_act)
        self.act = activation(act)
        if channel_mult[0] != 1:
            raise ValueError("channel_mult[0] must be 1")
        nres = tuple(num_res_blocks)
        if len(nres) != len(channel_mult):
            raise ValueError("num_res_blocks and channel_mult differ in length")
        if one_skip_per_reso and not new_upsample_method:
            raise ValueError("one_skip_per_reso requires new_upsample_method")
        self.dtype = dtype
        self.diffusion = diffusion
        self.final_act = final_act
        self.ssn = ssn
        self.ssn_rank = ssn_rank
        self.ssn_eps = ssn_eps
        self.encoder_only = encoder_only
        self.members = mm = members
        spec = dropout_spec
        n_levels = len(channel_mult)
        attn_res = {r + n_levels if r < 0 else r for r in attention_resolutions}
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        mc = model_channels
        self.model_channels = mc
        emb_ch = 4 * mc if diffusion else 0
        if diffusion:
            self.time_embed_0 = Dense(mc, emb_ch, members=mm)
            self.time_embed_1 = Dense(emb_ch, emb_ch, members=mm)
        # forward plan: ("block", (layer names)) | ("push",) | ("down", name)
        # | ("up", name) | ("skip", "cat" | "add" | "none", skip-dropout name or "")
        self.plan: list[tuple] = []

        def add_block(cin, cout, stage, depth, prefix, heads, attention=True):
            rate = spec.stage_rate(stage, depth)
            if depth in attn_res and mlp_attn:
                name = f"{prefix}_mlp"
                self.add_module(name, MLPBlock(
                    cin, cout, dropout=rate, emb_channels=emb_ch,
                    use_scale_shift_norm=use_scale_shift_norm, act=act, members=mm))
            else:
                name = f"{prefix}_res"
                self.add_module(name, ResBlock(
                    cin, cout, dropout=rate, per_block=spec.per_block,
                    residual_dropout=rate if spec.residual_connections else 0.0,
                    emb_channels=emb_ch, use_scale_shift_norm=use_scale_shift_norm, act=act,
                    members=mm))
            names = (name,)
            if attention and depth in attn_res:
                self.add_module(f"{prefix}_attn", AttentionBlock(cout, heads, members=mm))
                names += (f"{prefix}_attn",)
            self.plan.append(("block", names))

        self.input_conv = Conv(in_channels, mc, 3, members=mm)
        # channels of each activation pushed for the decoder, and whether it
        # is kept as a skip (one_skip_per_reso: only the one before each
        # downsample)
        skip_ch, keep = [mc], [False]
        ch = mc
        resolution = 0
        block_idx = 0
        for level, (mult, n_res) in enumerate(zip(channel_mult, nres)):
            for _ in range(n_res):
                add_block(ch, mult * mc, "encoder", resolution, f"enc{block_idx}", num_heads)
                ch = mult * mc
                self.plan.append(("push",))
                skip_ch.append(ch)
                keep.append(False)
                block_idx += 1
            if level != n_levels - 1:
                resolution += 1
                ch_out = channel_mult[resolution] * mc if new_upsample_method else None
                keep[-1] = True
                self.add_module(f"down{resolution}", Downsample(ch, conv_resample, ch_out,
                                                                members=mm))
                ch = ch_out or ch
                self.plan.append(("down", f"down{resolution}"))
                self.plan.append(("push",))
                skip_ch.append(ch)
                keep.append(False)
        if not one_skip_per_reso:
            keep = [True] * len(keep)

        ch_mid = channel_mult[-1] * mc
        for i in range(num_middle_res_blocks):
            # the last mid block has no attention
            add_block(ch, ch_mid, "mid", resolution, f"mid{i}", num_heads,
                      attention=i < num_middle_res_blocks - 1)
            ch = ch_mid

        if not encoder_only:  # the decoder and the heads
            block_idx = 0
            for level, mult, n_res in zip(reversed(range(n_levels)), channel_mult[::-1],
                                          nres[::-1]):
                for i in range(n_res + 1):
                    depth = resolution
                    kept, ch_skip = keep.pop(), skip_ch.pop()
                    skip_name = ""
                    if kept and spec.skip_connections:
                        skip_name = f"dec{block_idx}_skip_dropout"
                        self.add_module(skip_name, ChannelDropout(spec.rate_at_depth(depth)))
                    mode = ("add" if new_upsample_method else "cat") if kept else "none"
                    self.plan.append(("skip", mode, skip_name))
                    cin = ch + ch_skip if mode == "cat" else ch
                    add_block(cin, mc * mult, "decoder", depth, f"dec{block_idx}", heads_up)
                    ch = mc * mult
                    if level and i == n_res:
                        resolution -= 1
                        ch_out = channel_mult[resolution] * mc if new_upsample_method else None
                        self.add_module(f"up{resolution}", Upsample(
                            ch, conv_resample, ch_out,
                            "bilinear" if new_upsample_method else "nearest", members=mm))
                        ch = ch_out or ch
                        self.plan.append(("up", f"up{resolution}"))
                    block_idx += 1

            heads = ["out"] + (["ssn_cov", "ssn_factor"] if ssn else [])
            for name in heads:
                width = out_channels * (ssn_rank if name == "ssn_factor" else 1)
                self.add_module(f"{name}_norm", GroupNorm32(ch, act=act, members=mm))
                self.add_module(f"{name}_conv", Conv(ch, width, 3, zero_init=True, members=mm,
                                                     compute_dtype=False))

        for name, module in self.named_modules():
            if isinstance(module, ChannelDropout):
                module.path = name

    def _head(self, name: str, features: torch.Tensor) -> torch.Tensor:
        """GroupNorm32 + act, then a 3x3 conv, in the features' dtype."""
        norm, conv = getattr(self, f"{name}_norm"), getattr(self, f"{name}_conv")
        return conv(norm(features), features.dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                timesteps: torch.Tensor | float | None = None, *,
                mean_only: bool = False) -> UnetOutput:
        """Forward pass on NHWC input ``(B, H, W, in_channels)`` (with
        ``members=M``, M member-major blocks of rows).

        ``logits`` are ``(B, H, W, out_channels)`` after ``final_act``;
        ``features`` the decoder's last activation (the mid block's with
        ``encoder_only``), in ``x``'s dtype. With ``ssn`` the flattened
        (H, W, C) mean, diag and factor follow; ``mean_only`` skips the
        factor head and gives a zero factor.

        For the diffusion family ``x`` is ``concat([x_t, image], -1)`` and
        ``timesteps`` a ``(B,)`` tensor or a scalar of continuous times.
        ``generator``: a ``torch.Generator`` for the dropout masks, or a
        :class:`SameDropout`.
        """
        dtype = self.dtype
        emb = None
        if self.diffusion:
            if timesteps is None:
                raise ValueError("timesteps must be provided when diffusion=True")
            t = torch.as_tensor(timesteps, device=x.device)
            if t.ndim == 0:
                t = t.expand(x.shape[0])
            emb = timestep_embedding(t, self.model_channels)
            emb = self.time_embed_1(self.act(self.time_embed_0(emb, dtype)), dtype)
        elif timesteps is not None:
            raise ValueError("timesteps must be None when diffusion=False")
        h = self.input_conv(x.to(dtype), dtype)
        skips = [h]
        for op, *args in self.plan:
            if op == "block":
                for name in args[0]:
                    layer = getattr(self, name)
                    h = layer(h, dtype) if isinstance(layer, AttentionBlock) else layer(
                        h, dtype, generator, emb)
            elif op == "push":
                skips.append(h)
            elif op in ("down", "up"):
                h = getattr(self, args[0])(h, dtype)
            else:  # "skip"
                mode, dropout = args
                skip = skips.pop()
                if mode != "none":
                    if dropout:
                        skip = getattr(self, dropout)(skip, generator)
                    h = h + skip if mode == "add" else torch.cat([h, skip], dim=-1)
        features = h.to(x.dtype)
        if self.encoder_only:
            return UnetOutput(features=features)
        logits = self.final_act_fn(self._head("out", features))
        if not self.ssn:
            return UnetOutput(logits=logits, features=features)
        # SSN low-rank MVN head, flattened in (H, W, C) order
        b, hh, ww, c = logits.shape
        mean = logits.reshape(b, -1)
        eps = self.ssn_eps
        cov_diag = F.softplus(self._head("ssn_cov", features)) + eps
        cov_diag = torch.nan_to_num(cov_diag, nan=1.0, posinf=1e6, neginf=eps)
        cov_diag = torch.clamp(cov_diag, min=eps).reshape(b, -1)
        if mean_only:
            cov_factor = mean.new_zeros((b, mean.shape[1], self.ssn_rank))
        else:
            factor = self._head("ssn_factor", features).reshape(b, hh, ww, self.ssn_rank, c)
            cov_factor = factor.transpose(3, 4).reshape(b, -1, self.ssn_rank)  # (B,H,W,C,rank)
        return UnetOutput(logits=logits, features=features, ssn_mean=mean,
                          ssn_cov_diag=cov_diag, ssn_cov_factor=cov_factor)
