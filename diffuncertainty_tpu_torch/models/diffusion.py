"""Continuous-time Gaussian diffusion (port of
``diffuncertainty_tpu/models/diffusion.py``).

Gamma schedules (linear, cosine, linear_simple and parabola bases) with
input scaling and logSNR endpoint clamping: on the host in float64 for the
samplers' per-step constants, and on the device in float32 for the traced
training times ``t`` (the slope and bias still float64 on the host, as in
the JAX package). The training half: loss weights (the SNR family, uniform,
``sigmoid_b``, each optionally times ``-d logSNR/dt``), the t samplers
(uniform, low_discrepency, uniform_low_d), the masked MSE/BCE loss and
``train_loss_step``; its draws come from :func:`draw_t` and
:func:`draw_eps`. The prediction parameterizations (EPS / X / BOTH / V) and
the reverse samplers (DDIM and ancestral DDPM with the small or large
posterior variance): per-step constants are computed once in float64 and
cast to float32, as the JAX package feeds them to its ``lax.scan``; here the
steps are a Python loop of eager forwards. Layout NHWC: x is ``(B, H, W, C)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import draw_rows


def _base_gamma(name: str, xp) -> Callable:
    """The base schedule on ``xp`` arrays (numpy on the host, torch on the
    device)."""
    if name == "linear":
        return lambda t: 1.0 / (1.0 + xp.expm1(1e-4 + 10.0 * t * t))
    if name == "cosine":
        return lambda t: xp.cos(t * np.pi / 2.0) ** 2
    if name == "linear_simple":
        return lambda t: 1.0 - t
    if name == "parabola":
        return lambda t: 1.0 - 2.0 * t**2 + t**4
    raise NotImplementedError(name)


def draw_t(diffusion: "ContinuousGaussianDiffusion", bs: int,
           generator: torch.Generator) -> torch.Tensor:
    """The (bs,) training times of one step (``diffusion.sample_t``)."""
    return draw_rows(lambda n, g: diffusion.sample_t(g, n), bs, generator)


def draw_eps(shape: tuple, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """Standard normals of ``shape`` on the generator's device: the training
    noise, the start noise of a validation trajectory and the DDPM noise
    (per row: ``draw_rows``)."""
    return draw_rows(lambda n, g: torch.randn((n,) + tuple(shape[1:]), generator=g,
                                              device=g.device, dtype=dtype), shape[0], generator)


@dataclasses.dataclass(frozen=True)
class GammaSchedule:
    """gamma(t) with input scaling and the (slope, bias) correction that pins
    logSNR(0) = logsnr_max and logSNR(1) = logsnr_min, in float64."""

    schedule_name: str = "cosine"
    input_scale: float = 0.1
    logsnr_min: float = -10.0
    logsnr_max: float = 10.0

    def _scaled_gamma(self, base):
        b = float(self.input_scale)
        if abs(b - 1.0) > 1e-9:
            return lambda t: b * b * base(t) / ((b * b - 1.0) * base(t) + 1.0)
        return base

    @property
    def slope_bias(self) -> tuple[float, float]:
        g = self._scaled_gamma(_base_gamma(self.schedule_name, np))
        g0_old = g(np.float64(0.0))
        g1_old = g(np.float64(1.0))
        g0_new = 1.0 / (1.0 + np.exp(-np.float64(self.logsnr_max)))
        g1_new = 1.0 / (1.0 + np.exp(-np.float64(self.logsnr_min)))
        slope = (g0_new - g1_new) / (g0_old - g1_old)
        bias = g1_new - g1_old * slope
        return float(slope), float(bias)

    def gamma_np(self, t) -> np.ndarray:
        slope, bias = self.slope_bias
        g = self._scaled_gamma(_base_gamma(self.schedule_name, np))
        return g(np.asarray(t, dtype=np.float64)) * slope + bias

    def logsnr_np(self, t) -> np.ndarray:
        g = self.gamma_np(t)
        return np.log(g / (1.0 - g))

    # ---- device (a tensor t, in its dtype) ----
    def gamma(self, t: torch.Tensor) -> torch.Tensor:
        slope, bias = self.slope_bias
        g = self._scaled_gamma(_base_gamma(self.schedule_name, torch))
        return g(t) * slope + bias

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        g = self.gamma(t)
        return g / (1.0 - g)

    def alpha(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.gamma(t))

    def sigma(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(1.0 - self.gamma(t))

    def logsnr(self, t: torch.Tensor) -> torch.Tensor:
        return torch.log(self.snr(t))

    def diff_logsnr(self, t: torch.Tensor) -> torch.Tensor:
        """d logSNR / dt per element of ``t`` (autograd, as the JAX package
        differentiates it), detached from any graph."""
        with torch.enable_grad():
            ti = torch.atleast_1d(t).detach().clone().requires_grad_(True)
            (grad,) = torch.autograd.grad(self.logsnr(ti).sum(), ti)
        return grad


def _bcast(coefs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-batch coefficients ``(B,)`` broadcast over the other axes of x."""
    return coefs.reshape((coefs.shape[0],) + (1,) * (x.ndim - 1)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ContinuousGaussianDiffusion:
    """See the module docstring. Fields as ``configs/model/diffusion.yaml``."""

    schedule_name: str = "cosine"
    input_scale: float = 0.1
    model_pred_type: str = "X"  # EPS | X | V | BOTH
    weights_type: str = "sigmoid_-4"
    sampler_type: str = "uniform_low_d"  # t sampler for training
    var_type: str = "large"  # small | large
    loss_type: str = "MSE"
    logsnr_min: float = -10.0
    logsnr_max: float = 10.0
    decouple_loss_weights: bool = True

    @property
    def gamma_schedule(self) -> GammaSchedule:
        return GammaSchedule(self.schedule_name, self.input_scale, self.logsnr_min,
                             self.logsnr_max)

    # ---- training ---------------------------------------------------------------

    def loss_weights(self, t: torch.Tensor) -> torch.Tensor:
        gs = self.gamma_schedule
        snr = gs.snr(t)
        wt = self.weights_type
        if wt == "SNR":
            weights = snr
        elif wt == "SNR_plus1":
            weights = 1.0 + snr
        elif wt == "SNR_trunc":
            weights = torch.clamp(snr, min=1.0)
        elif wt == "uniform":
            weights = torch.ones_like(snr)
        elif wt.startswith("sigmoid"):
            bias = 0.0 if wt == "sigmoid" else float(wt.split("_")[1])
            weights = torch.sigmoid(gs.logsnr(t) + bias)
        else:
            raise NotImplementedError(wt)
        if self.decouple_loss_weights:
            weights = weights * (-gs.diff_logsnr(t))
        return weights

    def sample_t(self, generator: torch.Generator, bs: int) -> torch.Tensor:
        """The (bs,) training times in [0, 1), float32, on the generator's
        device."""
        dev = generator.device
        st = self.sampler_type
        if st == "uniform":
            return torch.rand(bs, generator=generator, device=dev)
        if st == "low_discrepency":
            t0 = torch.rand((), generator=generator, device=dev) / bs
            t = torch.arange(bs, device=dev) / bs + t0
            return t[torch.randperm(bs, generator=generator, device=dev)]
        if st == "uniform_low_d":
            perm = torch.randperm(bs, generator=generator, device=dev)
            return (perm + torch.rand(bs, generator=generator, device=dev)) / bs
        raise NotImplementedError(st)

    def _masked_loss(self, pred: torch.Tensor, gt: torch.Tensor,
                     loss_mask: torch.Tensor | None) -> torch.Tensor:
        """Per-element loss of the batch, each element's mask normalized to
        sum 1 (all pixels and classes when ``loss_mask`` is None)."""
        axes = tuple(range(1, gt.ndim))
        if loss_mask is None:
            norm_mask = torch.full_like(gt, 1.0 / math.prod(gt.shape[1:]))
        else:
            norm_mask = loss_mask / (loss_mask.sum(dim=axes, keepdim=True) + 1e-14)
        if self.loss_type == "MSE":
            return (norm_mask * (pred - gt) ** 2).sum(dim=axes)
        if self.loss_type == "BCE":
            likelihood = torch.prod(1.0 - 0.5 * (pred - gt).abs(), dim=-1, keepdim=True)
            return -(norm_mask * torch.log(likelihood)).sum(dim=axes)
        raise NotImplementedError(self.loss_type)

    def train_loss_step(self, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                        x: torch.Tensor, im: torch.Tensor, generator: torch.Generator,
                        loss_mask: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """One training step's loss: ``(scalar loss, pred_x)``.
        ``model_fn(concat([x_t, im], -1), t)`` is the conditioned forward;
        ``t`` comes from :func:`draw_t`, the noise from :func:`draw_eps`."""
        gs = self.gamma_schedule
        t = draw_t(self, x.shape[0], generator).to(x.device)
        eps = draw_eps(tuple(x.shape), generator, x.dtype).to(x.device)
        alpha_t, sigma_t = gs.alpha(t), gs.sigma(t)
        x_t = _bcast(alpha_t, x) * x + _bcast(sigma_t, eps) * eps
        output = model_fn(torch.cat([x_t, im], dim=-1), t)
        pred_x, _ = self.get_predictions(output, x_t, alpha_t, sigma_t)
        losses = self.loss_weights(t) * self._masked_loss(pred_x, x, loss_mask)
        return losses.mean(), pred_x

    # ---- prediction parameterizations ----------------------------------------

    def get_x_from_eps(self, eps, x_t, alpha_t, sigma_t):
        return _bcast(1.0 / alpha_t, x_t) * x_t - _bcast(sigma_t / alpha_t, eps) * eps

    def get_eps_from_x(self, x, x_t, alpha_t, sigma_t):
        return _bcast(1.0 / sigma_t, x_t) * x_t - _bcast(alpha_t / sigma_t, x) * x

    def get_predictions(self, output, x_t, alpha_t, sigma_t, clip_x: bool = False):
        """``(pred_x, pred_eps)`` from the model output; ``alpha_t`` and
        ``sigma_t`` are scalars or ``(B,)``."""
        alpha_t = torch.atleast_1d(torch.as_tensor(alpha_t, device=x_t.device))
        sigma_t = torch.atleast_1d(torch.as_tensor(sigma_t, device=x_t.device))
        if alpha_t.shape[0] == 1 and x_t.shape[0] != 1:
            alpha_t = alpha_t.expand(x_t.shape[0])
            sigma_t = sigma_t.expand(x_t.shape[0])
        mpt = self.model_pred_type.upper()
        if mpt == "EPS":
            pred_eps = output
            pred_x = self.get_x_from_eps(pred_eps, x_t, alpha_t, sigma_t)
        elif mpt == "X":
            pred_x = output
            pred_eps = self.get_eps_from_x(pred_x, x_t, alpha_t, sigma_t)
        elif mpt == "BOTH":
            pred_eps, pred_x_direct = output.chunk(2, dim=-1)
            pred_x = (_bcast(alpha_t, pred_x_direct) * pred_x_direct
                      + _bcast(sigma_t, x_t) * self.get_x_from_eps(pred_eps, x_t, alpha_t, sigma_t))
        elif mpt == "V":
            pred_x = _bcast(alpha_t, x_t) * x_t - _bcast(sigma_t, output) * output
            pred_eps = self.get_eps_from_x(pred_x, x_t, alpha_t, sigma_t)
        else:
            raise NotImplementedError(mpt)
        if clip_x:
            pred_x = pred_x.clamp(-1.0, 1.0)
        return pred_x, pred_eps

    # ---- reverse sampling -------------------------------------------------------

    def _step_constants(self, num_steps: int) -> dict[str, np.ndarray]:
        """Per-step posterior coefficients, float64 on the host cast to float32,
        stacked ``(num_steps,)``. Step k runs i = num_steps-1-k: t=(i+1)/N, s=i/N."""
        gs = self.gamma_schedule
        i = np.arange(num_steps - 1, -1, -1, dtype=np.float64)
        t = (i + 1.0) / num_steps
        s = i / num_steps
        logsnr_t = gs.logsnr_np(t)
        logsnr_s = gs.logsnr_np(s)
        gamma_t = gs.gamma_np(t)
        alpha_t = np.sqrt(gamma_t)
        sigma_t = np.sqrt(1.0 - gamma_t)
        # q(x_s | x_t, x) coefficients
        alpha_st = np.sqrt((1.0 + np.exp(-logsnr_t)) / (1.0 + np.exp(-logsnr_s)))
        alpha_s = np.sqrt(1.0 / (1.0 + np.exp(-logsnr_s)))
        r = np.exp(logsnr_t - logsnr_s)
        one_minus_r = -np.expm1(logsnr_t - logsnr_s)
        sigmoid_neg_t = 1.0 / (1.0 + np.exp(logsnr_t))
        sigmoid_neg_s = 1.0 / (1.0 + np.exp(logsnr_s))
        var = one_minus_r * (sigmoid_neg_s if self.var_type == "small" else sigmoid_neg_t)
        return {
            "is_last": (i == 0).astype(np.float32),
            "t": t.astype(np.float32),
            "alpha_t": alpha_t.astype(np.float32),
            "sigma_t": sigma_t.astype(np.float32),
            "mean_xt_coef": (r * alpha_st).astype(np.float32),
            "mean_x_coef": (one_minus_r * alpha_s).astype(np.float32),
            "std": np.sqrt(var).astype(np.float32),
            "ddim_alpha_s": alpha_s.astype(np.float32),
            "ddim_sigma_s": np.sqrt(sigmoid_neg_s).astype(np.float32),
        }

    def sample_loop(
        self,
        model_fn: Callable[[torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor],
        x_init: torch.Tensor,
        im: torch.Tensor,
        num_steps: int,
        generator: torch.Generator,
        sampler_type: str = "ddpm",
        clip_x: bool = False,
        noise_fn: Callable[[int, tuple], torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """The full reverse trajectory; returns the x_0 prediction.

        ``model_fn(concat([x_t, im], -1), t, generator)`` runs once a step,
        so its dropout draws fresh masks from ``generator`` each step. DDPM
        noise is ``noise_fn(step, shape)`` when given, else :func:`draw_eps`
        from ``generator``.
        """
        if sampler_type not in ("ddim", "ddpm"):
            raise NotImplementedError(sampler_type)
        consts = self._step_constants(num_steps)
        b = x_init.shape[0]
        dev = x_init.device
        x_t = x_init
        for k in range(num_steps):
            step = {name: float(v[k]) for name, v in consts.items()}
            t_cond = torch.full((b,), step["t"], dtype=x_t.dtype, device=dev)
            model_out = model_fn(torch.cat([x_t, im], dim=-1), t_cond, generator)
            pred_x, pred_eps = self.get_predictions(
                model_out, x_t,
                torch.full((b,), step["alpha_t"], dtype=torch.float32, device=dev),
                torch.full((b,), step["sigma_t"], dtype=torch.float32, device=dev),
                clip_x=clip_x)
            if sampler_type == "ddim":
                x_s = step["ddim_alpha_s"] * pred_x + step["ddim_sigma_s"] * pred_eps
            else:
                if noise_fn is not None:
                    noise = noise_fn(k, tuple(x_t.shape)).to(device=dev, dtype=x_t.dtype)
                else:
                    noise = draw_eps(tuple(x_t.shape), generator, x_t.dtype)
                mean = step["mean_xt_coef"] * x_t + step["mean_x_coef"] * pred_x
                x_s = mean + step["std"] * noise
            x_t = pred_x if step["is_last"] > 0 else x_s
        return x_t
