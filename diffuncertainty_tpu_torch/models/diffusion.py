"""Continuous-time Gaussian diffusion, the sampling half (port of
``diffuncertainty_tpu/models/diffusion.py``).

Gamma schedules (cosine and linear bases) with input scaling and logSNR
endpoint clamping, evaluated on the host in float64; the prediction
parameterizations (EPS / X / BOTH / V); and the reverse samplers (DDIM and
ancestral DDPM with the small or large posterior variance). Per-step
constants are computed once in float64 and cast to float32, as the JAX
package feeds them to its ``lax.scan``; here the steps are a Python loop of
eager forwards. The training half (loss weights, t samplers, masked loss,
``train_loss_step``) is not ported yet. Layout NHWC: x is ``(B, H, W, C)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def _base_gamma_np(name: str) -> Callable[[np.ndarray], np.ndarray]:
    if name == "linear":
        return lambda t: 1.0 / (1.0 + np.expm1(1e-4 + 10.0 * t * t))
    if name == "cosine":
        return lambda t: np.cos(t * np.pi / 2.0) ** 2
    raise NotImplementedError(f"gamma schedule '{name}' is not ported (cosine, linear)")


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
        g = self._scaled_gamma(_base_gamma_np(self.schedule_name))
        g0_old = g(np.float64(0.0))
        g1_old = g(np.float64(1.0))
        g0_new = 1.0 / (1.0 + np.exp(-np.float64(self.logsnr_max)))
        g1_new = 1.0 / (1.0 + np.exp(-np.float64(self.logsnr_min)))
        slope = (g0_new - g1_new) / (g0_old - g1_old)
        bias = g1_new - g1_old * slope
        return float(slope), float(bias)

    def gamma_np(self, t) -> np.ndarray:
        slope, bias = self.slope_bias
        g = self._scaled_gamma(_base_gamma_np(self.schedule_name))
        return g(np.asarray(t, dtype=np.float64)) * slope + bias

    def logsnr_np(self, t) -> np.ndarray:
        g = self.gamma_np(t)
        return np.log(g / (1.0 - g))


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
        noise is ``noise_fn(step, shape)`` when given, else a standard normal
        draw from ``generator``.
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
                    noise = torch.randn(x_t.shape, generator=generator, device=dev, dtype=x_t.dtype)
                mean = step["mean_xt_coef"] * x_t + step["mean_x_coef"] * pred_x
                x_s = mean + step["std"] * noise
            x_t = pred_x if step["is_last"] > 0 else x_s
        return x_t
