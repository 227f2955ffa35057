"""Batched affine warps for TTA (port of ``diffuncertainty_tpu/ops/warp.py``).

Matrices are 2x3 **dst->src** maps in xy convention, as cv2 takes them.
Both warps are bilinear with a replicate or a constant-0 border (the nearest
modes, for label masks, belong to the training slice). ``warp_affine`` is the
single composed resample the exact TTA path uses; ``warp_affine_separable``
is the two-pass X-then-Y warp of the fast path: each pass is a per-image
scale resample (a batched matmul with a bilinear interpolation matrix over a
margin-widened row) and a per-row fractional translation (a 2-tap lerp of a
shifted read). Both reproduce the JAX semantics; see the JAX module for the
derivation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert a (..., 2, 3) affine matrix (cv2.invertAffineTransform)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    row0 = torch.stack([ia, ib, ic], dim=-1)
    row1 = torch.stack([id_, ie, if_], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def rotation_matrix(angle_deg: torch.Tensor, scale: torch.Tensor,
                    center_xy: tuple[float, float]) -> torch.Tensor:
    """cv2.getRotationMatrix2D semantics, batched -> (..., 2, 3)."""
    angle = torch.deg2rad(angle_deg)
    alpha = scale * torch.cos(angle)
    beta = scale * torch.sin(angle)
    cx, cy = center_xy
    row0 = torch.stack([alpha, beta, (1 - alpha) * cx - beta * cy], dim=-1)
    row1 = torch.stack([-beta, alpha, beta * cx + (1 - alpha) * cy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def hflip_matrix(width: int, device: torch.device | str) -> torch.Tensor:
    """x -> W-1-x as a 2x3 affine on ``device``."""
    return torch.tensor([[-1.0, 0.0, width - 1.0], [0.0, 1.0, 0.0]], device=device)


def compose_affine(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Compose (..., 2, 3) maps: result(x) = m2(m1(x))."""
    last = torch.tensor([[0.0, 0.0, 1.0]], dtype=m1.dtype, device=m1.device)
    a = torch.cat([m1, last.expand(m1.shape[:-2] + (1, 3))], dim=-2)
    return m2 @ a


def warp_affine(images: torch.Tensor, dst_to_src: torch.Tensor, *,
                border_mode: str = "replicate") -> torch.Tensor:
    """Bilinear warp of (B, H, W, C) by per-image (B, 2, 3) dst->src matrices."""
    b, h, w, c = images.shape
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    dst = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    src = torch.einsum("bij,hwj->bhwi", dst_to_src.float(), dst)  # (B, H, W, 2) xy
    sx, sy = src[..., 0], src[..., 1]
    bidx = torch.arange(b, device=dev)[:, None, None]
    if border_mode == "replicate":
        sx_eff = sx.clamp(0.0, w - 1.0)
        sy_eff = sy.clamp(0.0, h - 1.0)
        padded = torch.nn.functional.pad(
            images.permute(0, 3, 1, 2), (0, 1, 0, 1), mode="replicate").permute(0, 2, 3, 1)
        shift = 0
    elif border_mode == "constant":
        sx_eff, sy_eff = sx, sy
        padded = torch.nn.functional.pad(images, (0, 0, 1, 1, 1, 1))
        shift = 1
    else:
        raise NotImplementedError(border_mode)
    hp, wp = padded.shape[1], padded.shape[2]
    x0 = torch.floor(sx_eff)
    y0 = torch.floor(sy_eff)
    fx = (sx_eff - x0)[..., None]
    fy = (sy_eff - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    # 2x2 patch whose start is clamped into the padded frame (lax.gather CLIP)
    iy = (y0i + shift).clamp(0, hp - 2)
    ix = (x0i + shift).clamp(0, wp - 2)
    top = padded[bidx, iy, ix] * (1 - fx) + padded[bidx, iy, ix + 1] * fx
    bot = padded[bidx, iy + 1, ix] * (1 - fx) + padded[bidx, iy + 1, ix + 1] * fx
    out = top * (1 - fy) + bot * fy
    if border_mode == "constant":
        far_outside = (x0i < -1) | (x0i >= w) | (y0i < -1) | (y0i >= h)
        out = torch.where(far_outside[..., None], torch.zeros((), device=dev), out)
    return out


@functools.lru_cache(maxsize=None)
def separable_margins(
    rotation_limit: float, smin: float, smax: float, flip_possible: bool,
    height: int, width: int,
) -> tuple[int, int]:
    """Static bounds on the separable warp's per-pass translation (pixels),
    from an angle grid x scale extremes x flip of the TTA transform family,
    forward and inverse; 5% headroom + 2 px guard. Host numpy, cached."""
    angles = np.linspace(-rotation_limit, rotation_limit, 65)
    scales = np.linspace(max(smin, 1e-3), smax, 9)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    flips = (False, True) if flip_possible else (False,)
    e_x = e_y = 1.0
    for ang in angles:
        a = np.deg2rad(ang)
        for sc in scales:
            alpha, beta = sc * np.cos(a), sc * np.sin(a)
            rot = np.array(
                [[alpha, beta, (1 - alpha) * cx - beta * cy],
                 [-beta, alpha, beta * cx + (1 - alpha) * cy],
                 [0.0, 0.0, 1.0]]
            )
            for flip in flips:
                fm = np.array([[-1.0, 0.0, width - 1.0], [0.0, 1.0, 0.0], [0, 0, 1.0]])
                fwd = rot @ fm if flip else rot
                for m in (fwd, np.linalg.inv(fwd)):
                    (m00, m01, m02), (m10, m11, m12) = m[0], m[1]
                    s_a = m00 - m01 * m10 / m11
                    e_x = max(e_x, abs(m01 / m11) * (height - 1) / 2 / abs(s_a))
                    e_y = max(e_y, abs(m10 / m11) * (width - 1) / 2)
    return int(np.ceil(e_x * 1.05)) + 2, int(np.ceil(e_y * 1.05)) + 2


def warp_affine_separable(
    images: torch.Tensor,
    dst_to_src: torch.Tensor,
    *,
    interpolation: str = "bilinear",
    border_mode: str = "replicate",
    margin_x: int | None = None,
    margin_y: int | None = None,
) -> torch.Tensor:
    """Two-pass (X then Y) affine warp of (B, H, W, C) images.

    The map ``out[v,u] = in(m10*u + m11*v + m12, m00*u + m01*v + m02)``
    factors into an X pass ``tmp[y,u] = in(y, sA*u + cA(y))`` with
    ``sA = m00 - m01*m10/m11`` and ``cA(y) = (m01/m11)*y + m02 - m01*m12/m11``,
    then a Y pass ``out[v,u] = tmp(m11*v + m10*u + m12, u)``. Each pass
    interpolates bilinearly (double interpolation). ``margin_x/y`` bound the
    per-row translation (pixels). ``interpolation="nearest"`` selects in each
    pass (a 0/1 matrix and the rounded tap), so values stay exact: the
    training warp of label masks.
    """
    b, h, w, c = images.shape
    if interpolation not in ("bilinear", "nearest"):
        raise NotImplementedError(interpolation)
    nearest = interpolation == "nearest"
    if border_mode not in ("constant", "replicate"):
        raise NotImplementedError(border_mode)
    replicate = border_mode == "replicate"
    orig_dtype = images.dtype

    m = dst_to_src.float()
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    s_a = m00 - m01 * m10 / m11
    off0_a = m02 - m01 * m12 / m11
    slope_a = m01 / m11
    e_x = int(margin_x) if margin_x is not None else w
    e_y = int(margin_y) if margin_y is not None else h

    x = images.float().permute(0, 3, 1, 2)  # (B, C, H, W)
    rows = _resample_rows_1d(x.reshape(b, c * h, w), s_a, off0_a, slope_a, n_rep=c,
                             n_rows=h, margin=e_x, replicate=replicate, l_out=w,
                             nearest=nearest)
    xt = rows.reshape(b, c, h, w).transpose(2, 3)  # (B, C, W, H)
    rows = _resample_rows_1d(xt.reshape(b, c * w, h), m11, m12, m10, n_rep=c,
                             n_rows=w, margin=e_y, replicate=replicate, l_out=h,
                             nearest=nearest)
    out = rows.reshape(b, c, w, h).permute(0, 3, 2, 1)  # (B, H, W, C)
    if not replicate and not nearest:  # nearest selection is already 0 outside
        # exact far-outside zeroing, as warp_affine's constant border
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=m.device),
            torch.arange(w, dtype=torch.float32, device=m.device), indexing="ij")
        sx = m00[:, None, None] * gx + m01[:, None, None] * gy + m02[:, None, None]
        sy = m10[:, None, None] * gx + m11[:, None, None] * gy + m12[:, None, None]
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        far = (x0 < -1) | (x0 >= w) | (y0 < -1) | (y0 >= h)
        out = torch.where(far[..., None], torch.zeros((), device=out.device), out)
    return out.to(orig_dtype)


def _resample_rows_1d(
    rows: torch.Tensor,
    scale: torch.Tensor,
    off0: torch.Tensor,
    off_slope: torch.Tensor,
    *,
    n_rep: int,
    n_rows: int,
    margin: int,
    replicate: bool,
    l_out: int,
    nearest: bool = False,
) -> torch.Tensor:
    """Per-row 1-D affine resample ``out[b,r,u] = rows[b,r](scale_b*u + off_b(row))``.

    rows (B, n_rep*n_rows, L_in), row index r = rep*n_rows + row,
    off_b(row) = off0_b + off_slope_b*row. The per-image center-row offset is
    folded into the interpolation matrix; the per-row residual shift is a
    read at lane ``(j + start) mod mid`` (the JAX barrel shifter's roll).
    ``nearest``: 0/1 selection (round half up) at the scale stage, then tap 0
    or tap 1, whichever holds the true nearest source pixel.
    """
    b, r, l_in = rows.shape
    dev = rows.device
    e = margin
    mid = l_out + 2 * e
    off_mid = off0 + off_slope * ((n_rows - 1) / 2.0)  # (B,)
    j = torch.arange(mid, dtype=torch.float32, device=dev)
    coord = scale[:, None] * (j[None] - e) + off_mid[:, None]  # (B, mid)
    if replicate:
        coord = coord.clamp(0.0, l_in - 1.0)
    wk = torch.arange(l_in, dtype=torch.float32, device=dev)
    row_idx = torch.arange(n_rows, dtype=torch.float32, device=dev)
    residual = off_slope[:, None] * (row_idx[None] - (n_rows - 1) / 2.0)
    shift = (residual / scale[:, None])[:, None, :].expand(b, n_rep, n_rows).reshape(b, r)
    k = torch.floor(shift)
    starts = (k.long() + e).clamp(0, 2 * e)
    lanes = torch.arange(l_out + 1, device=dev)
    if nearest:
        kmat = (torch.floor(coord + 0.5)[:, None, :] == wk[None, :, None]).to(rows.dtype)
        shifted = torch.gather(torch.bmm(rows, kmat), 2,
                               (lanes[None, None] + starts[..., None]) % mid)
        u = torch.arange(l_out, dtype=torch.float32, device=dev)
        scale_r = scale[:, None, None]
        off_r = off_mid[:, None, None]
        src_tap0 = scale_r * (u[None, None] + k[..., None]) + off_r
        src_true = scale_r * (u[None, None] + shift[..., None]) + off_r
        if replicate:
            src_tap0 = src_tap0.clamp(0.0, l_in - 1.0)
            src_true = src_true.clamp(0.0, l_in - 1.0)
        take_next = torch.floor(src_true + 0.5) != torch.floor(src_tap0 + 0.5)
        return torch.where(take_next, shifted[..., 1:], shifted[..., :l_out])
    # (B, L_in, mid) bilinear weights; out-of-range coords get all-zero columns
    kmat = torch.clamp(1.0 - torch.abs(coord[:, None, :] - wk[None, :, None]), min=0.0)
    sc = torch.bmm(rows, kmat)  # (B, R, mid)
    shifted = torch.gather(sc, 2, (lanes[None, None] + starts[..., None]) % mid)
    frac = (shift - k)[..., None]
    return (1.0 - frac) * shifted[..., :l_out] + frac * shifted[..., 1:]
