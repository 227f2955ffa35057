"""ADM-style 2D U-Net ("DiffUnet") for the softmax, diffusion, SSN and
prob-U-Net families (port of ``diffuncertainty_tpu/models/unet.py``,
``members=0``).

Public layout is NHWC like the JAX model. Convolutions run on NCHW views of
the NHWC tensors (channels-last memory, which cuDNN takes as is); 1x1 convs
and dense layers are channel matmuls on the NHWC tensor. Submodules carry the
flax names (``enc0_res``, ``mid0_attn``, ``up2``, ...), so the state_dict keys
are the flax paths with '.' for '/' (``core/params.py``).

Parameters stay float32; ``dtype`` is the compute dtype the convs, dense
layers and attention run in (weights are cast per call, as flax's
``promote_dtype`` does). Every GroupNorm goes through the hand-written
GroupNorm+activation kernel (``ops/cuda_groupnorm.py``), with float32
statistics and, where SiLU follows the norm, the SiLU fused in. The output
head runs in the input's dtype, as in the JAX model, and ends in
``final_act`` (softmax for the diffusion family).

With ``diffusion=True`` the input is ``concat([x_t, image])`` and the forward
takes continuous times ``t``: a sinusoidal embedding through
``time_embed_0`` -> SiLU -> ``time_embed_1`` feeds every ResBlock
(``emb_proj``), added before ``out_norm`` or, with ``use_scale_shift_norm``,
applied as ``norm(h) * (1 + scale) + shift``.

With ``ssn=True`` two more heads of the same form (``ssn_cov``,
``ssn_factor``) give the SSN's low-rank covariance over the flattened logits
(``models/ssn.py``). With ``encoder_only=True`` the network stops after the
middle blocks and builds no decoder or head: the prob-U-Net's latent
encoders. ``forward`` returns a :class:`UnetOutput`, as the JAX model does.

MC-dropout (``ChannelDropout``) zeroes whole channels with a (B, C) mask and
scales by 1/(1-p). It is always live when its rate is positive and draws from
the ``torch.Generator`` passed to ``forward``.
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
from ..ops.resample import downsample_avgpool2x, upsample2x
from ..ops.time_embed import timestep_embedding


@dataclasses.dataclass
class UnetOutput:
    """Forward results (``UnetOutput`` of the JAX model); unused fields are None."""

    logits: torch.Tensor | None = None  # (B, H, W, out_channels), after final_act
    features: torch.Tensor | None = None  # decoder features, or the mid block's
    ssn_mean: torch.Tensor | None = None  # (B, N) flattened logits, N = H*W*out_channels
    ssn_cov_diag: torch.Tensor | None = None  # (B, N)
    ssn_cov_factor: torch.Tensor | None = None  # (B, N, rank)


class Conv(nn.Module):
    """``k x k`` conv on NHWC input; weight OIHW, bias (O,)."""

    def __init__(self, cin: int, cout: int, k: int = 3, *, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = k // 2
        # lecun normal, the flax default; serving loads trained weights over it
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k) / math.sqrt(cin * k * k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if self.weight.shape[-1] == 1 and self.stride == 1:
            return F.linear(x, self.weight[:, :, 0, 0].to(dtype), self.bias.to(dtype))
        w = self.weight.to(dtype=dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias.to(dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Dense layer over the last axis; weight (O, I)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin) / math.sqrt(cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class GroupNorm32(nn.Module):
    """Learned-affine GroupNorm with float32 statistics, then ``act``
    ("silu" or "none"), through the GroupNorm+activation kernel."""

    def __init__(self, channels: int, act: str = "none"):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        """Boolean keep mask of ``shape`` (B, C)."""
        return torch.rand(shape, generator=generator, device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError(f"dropout at '{self.path}' needs a torch.Generator")
        keep = 1.0 - self.rate
        mask = self.draw_mask((x.shape[0], x.shape[-1]), generator, x.device)
        mask = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ResBlock(nn.Module):
    """Residual block; time-conditioned through ``emb_proj`` when
    ``emb_channels`` is set (the diffusion family)."""

    def __init__(self, cin: int, cout: int, *, dropout: float, per_block: bool,
                 residual_dropout: float, emb_channels: int = 0,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(cin, act="silu")
        self.in_dropout = ChannelDropout(0.0 if per_block else dropout)
        self.in_conv = Conv(cin, cout, 3)
        self.emb_proj = None
        if emb_channels:
            self.emb_proj = Dense(emb_channels, 2 * cout if use_scale_shift_norm else cout)
        # scale-shift applies between the norm and the SiLU, so it cannot fuse
        self.out_norm = GroupNorm32(cout, act="none" if use_scale_shift_norm else "silu")
        self.out_dropout = ChannelDropout(dropout)
        self.out_conv = Conv(cout, cout, 3)
        self.skip_conv = Conv(cin, cout, 1) if cin != cout else None
        self.residual_dropout = ChannelDropout(residual_dropout)

    def forward(self, x, dtype, generator, emb=None):
        h = self.in_norm(x)
        h = self.in_dropout(h, generator)
        h = self.in_conv(h, dtype)
        if emb is None:
            h = self.out_norm(h)
        else:
            emb_out = self.emb_proj(F.silu(emb), dtype).to(h.dtype)[:, None, None, :]
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=-1)
                h = F.silu(self.out_norm(h) * (1 + scale) + shift)
            else:
                h = self.out_norm(h + emb_out)
        h = self.out_dropout(h, generator)
        h = self.out_conv(h, dtype)
        skip = x if self.skip_conv is None else self.skip_conv(x, dtype)
        return self.residual_dropout(skip, generator) + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H*W tokens of an NHWC map."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels, act="none")
        self.qkv = Dense(channels, 3 * channels)
        self.proj_out = Dense(channels, channels)

    def forward(self, x, dtype):
        b, hh, ww, c = x.shape
        xt = x.reshape(b, hh * ww, c)
        qkv = self.qkv(self.norm(xt), dtype)
        h = self.proj_out(qkv_attention(qkv, self.num_heads), dtype)
        return (xt + h).reshape(b, hh, ww, c)


class Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2) if use_conv else None

    def forward(self, x, dtype):
        return downsample_avgpool2x(x) if self.op is None else self.op(x, dtype)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.conv = Conv(channels, channels, 3) if use_conv else None

    def forward(self, x, dtype):
        x = upsample2x(x)
        return x if self.conv is None else self.conv(x, dtype)


class DiffUnet(nn.Module):
    """The U-Net of the softmax and diffusion families: SiLU, concat skips,
    nearest upsampling, the same head count in encoder and decoder."""

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
        use_scale_shift_norm: bool = False,
        diffusion: bool = False,
        final_act: str = "none",
        ssn: bool = False,
        ssn_rank: int = 10,
        ssn_eps: float = 1e-5,
        encoder_only: bool = False,
        dropout_spec: DropoutSpec = DropoutSpec(),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if final_act not in ("none", "softmax"):
            raise ValueError(f"final_act must be none or softmax, got {final_act!r}")
        if channel_mult[0] != 1:
            raise ValueError("channel_mult[0] must be 1")
        nres = tuple(num_res_blocks)
        if len(nres) != len(channel_mult):
            raise ValueError("num_res_blocks and channel_mult differ in length")
        self.dtype = dtype
        self.diffusion = diffusion
        self.final_act = final_act
        self.ssn = ssn
        self.ssn_rank = ssn_rank
        self.ssn_eps = ssn_eps
        self.encoder_only = encoder_only
        spec = dropout_spec
        n_levels = len(channel_mult)
        attn_res = {r + n_levels if r < 0 else r for r in attention_resolutions}
        mc = model_channels
        self.model_channels = mc
        emb_ch = 4 * mc if diffusion else 0
        if diffusion:
            self.time_embed_0 = Dense(mc, emb_ch)
            self.time_embed_1 = Dense(emb_ch, emb_ch)
        # forward plan: ("block", prefix) | ("down", name) | ("push", "")
        # | ("cat", skip-dropout name or "") | ("up", name)
        self.plan: list[tuple[str, str]] = []

        def add_block(cin, cout, stage, depth, prefix, attention=True):
            rate = spec.stage_rate(stage, depth)
            self.add_module(f"{prefix}_res", ResBlock(
                cin, cout, dropout=rate, per_block=spec.per_block,
                residual_dropout=rate if spec.residual_connections else 0.0,
                emb_channels=emb_ch, use_scale_shift_norm=use_scale_shift_norm))
            if attention and depth in attn_res:
                self.add_module(f"{prefix}_attn", AttentionBlock(cout, num_heads))
            self.plan.append(("block", prefix))

        self.input_conv = Conv(in_channels, mc, 3)
        skip_ch = [mc]
        ch = mc
        resolution = 0
        block_idx = 0
        for level, (mult, n_res) in enumerate(zip(channel_mult, nres)):
            for _ in range(n_res):
                add_block(ch, mult * mc, "encoder", resolution, f"enc{block_idx}")
                ch = mult * mc
                self.plan.append(("push", ""))
                skip_ch.append(ch)
                block_idx += 1
            if level != n_levels - 1:
                resolution += 1
                self.add_module(f"down{resolution}", Downsample(ch, conv_resample))
                self.plan.append(("down", f"down{resolution}"))
                self.plan.append(("push", ""))
                skip_ch.append(ch)

        ch_mid = channel_mult[-1] * mc
        for i in range(num_middle_res_blocks):
            # the last mid block has no attention
            add_block(ch, ch_mid, "mid", resolution, f"mid{i}",
                      attention=i < num_middle_res_blocks - 1)
            ch = ch_mid

        if not encoder_only:  # the decoder and the heads
            block_idx = 0
            for level, mult, n_res in zip(reversed(range(n_levels)), channel_mult[::-1],
                                          nres[::-1]):
                for i in range(n_res + 1):
                    depth = resolution
                    skip_name = ""
                    if spec.skip_connections:
                        skip_name = f"dec{block_idx}_skip_dropout"
                        self.add_module(skip_name, ChannelDropout(spec.rate_at_depth(depth)))
                    self.plan.append(("cat", skip_name))
                    cin = ch + skip_ch.pop()
                    add_block(cin, mc * mult, "decoder", depth, f"dec{block_idx}")
                    ch = mc * mult
                    if level and i == n_res:
                        resolution -= 1
                        self.add_module(f"up{resolution}", Upsample(ch, conv_resample))
                        self.plan.append(("up", f"up{resolution}"))
                    block_idx += 1

            self.out_norm = GroupNorm32(ch, act="silu")
            self.out_conv = Conv(ch, out_channels, 3)
            if ssn:
                self.ssn_cov_norm = GroupNorm32(ch, act="silu")
                self.ssn_cov_conv = Conv(ch, out_channels, 3)
                self.ssn_factor_norm = GroupNorm32(ch, act="silu")
                self.ssn_factor_conv = Conv(ch, out_channels * ssn_rank, 3)

        for name, module in self.named_modules():
            if isinstance(module, ChannelDropout):
                module.path = name

    def _head(self, name: str, features: torch.Tensor) -> torch.Tensor:
        """GroupNorm32 + SiLU, then a 3x3 conv, in the features' dtype."""
        norm, conv = getattr(self, f"{name}_norm"), getattr(self, f"{name}_conv")
        return conv(norm(features), features.dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                timesteps: torch.Tensor | float | None = None, *,
                mean_only: bool = False) -> UnetOutput:
        """Forward pass on NHWC input ``(B, H, W, in_channels)``.

        ``logits`` are ``(B, H, W, out_channels)``, or with
        ``final_act="softmax"`` their softmax; ``features`` the decoder's last
        activation (the mid block's with ``encoder_only``), in ``x``'s dtype.
        With ``ssn`` the flattened (H, W, C) mean, diag and factor follow;
        ``mean_only`` skips the factor head and gives a zero factor.

        For the diffusion family ``x`` is ``concat([x_t, image], -1)`` and
        ``timesteps`` a ``(B,)`` tensor or a scalar of continuous times.
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
            emb = self.time_embed_1(F.silu(self.time_embed_0(emb, dtype)), dtype)
        elif timesteps is not None:
            raise ValueError("timesteps must be None when diffusion=False")
        h = self.input_conv(x.to(dtype), dtype)
        skips = [h]
        for op, name in self.plan:
            if op == "block":
                h = getattr(self, f"{name}_res")(h, dtype, generator, emb)
                attn = getattr(self, f"{name}_attn", None)
                if attn is not None:
                    h = attn(h, dtype)
            elif op == "push":
                skips.append(h)
            elif op == "down" or op == "up":
                h = getattr(self, name)(h, dtype)
            else:  # "cat"
                skip = skips.pop()
                if name:
                    skip = getattr(self, name)(skip, generator)
                h = torch.cat([h, skip], dim=-1)
        features = h.to(x.dtype)
        if self.encoder_only:
            return UnetOutput(features=features)
        logits = self._head("out", features)
        if self.final_act == "softmax":
            logits = torch.softmax(logits, dim=-1)
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
