"""Baseline JPEG compression round trip in numpy (the port's replacement for
the PIL save/load that ``diffuncertainty_tpu/data/ood.py::ood_jpeg`` does).

Encoding and decoding lose information only in the quantization of the DCT
coefficients, so the round trip needs no entropy coding: it runs libjpeg's
integer pipeline at the defaults Pillow uses (libjpeg-turbo, 8-bit samples),
vectorized over the 8x8 blocks:

- encoder: the image padded to whole blocks by repeating its last column and
  row; for ``RGB`` the fixed-point RGB -> YCbCr of ``jccolor.c`` and the
  h2v2 (4:2:0) chroma downsampling of ``jcsample.c`` (rounding bias 1, 2, 1,
  2, ...), the chroma rows then padded to whole blocks by repeating the last
  one; the "islow" forward DCT (``jfdctint.c``); quantization by the IJG
  tables scaled for the quality (``jcparam.c``: 5000/q below 50, 200 - 2q
  above, clamped to 1..255 for baseline) through libjpeg-turbo's reciprocal
  multiplication (``jcdctmgr.c::compute_reciprocal``);
- decoder: dequantization and the islow inverse DCT (``jidctint.c``) with its
  wrapping range limit; for ``RGB`` the h2v2 "fancy" (triangle) upsampling of
  ``jdsample.c``, whose row above the first and below the last repeat the
  edge rows (box upsampling for chroma at most 2 samples wide), and the
  fixed-point YCbCr -> RGB of ``jdcolor.c``.

Both ``L`` and ``RGB`` match Pillow 12's round trip bit for bit at every
quality and size ``tests/test_torch_port_codecs.py`` draws.
"""

from __future__ import annotations

import numpy as np

CONST_BITS, PASS1_BITS = 13, 2
SCALEBITS = 16

# the IJG example tables (ITU T.81 Annex K), natural (row-major) order
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
STD_CHROMINANCE = np.full((8, 8), 99, np.int64)
STD_CHROMINANCE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                                    [24, 26, 56, 99], [47, 66, 99, 99]])


def _fix(x: float, bits: int = CONST_BITS) -> int:
    return int(x * (1 << bits) + 0.5)


F_0_298, F_0_390, F_0_541, F_0_765 = (_fix(v) for v in (0.298631336, 0.390180644, 0.541196100,
                                                          0.765366865))
F_0_899, F_1_175, F_1_501, F_1_847 = (_fix(v) for v in (0.899976223, 1.175875602, 1.501321110,
                                                          1.847759065))
F_1_961, F_2_053, F_2_562, F_3_072 = (_fix(v) for v in (1.961570560, 2.053119869, 2.562915447,
                                                          3.072711026))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def quant_table(quality: int, base: np.ndarray) -> np.ndarray:
    """``jpeg_set_quality(cinfo, quality, force_baseline=TRUE)``'s table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _odd_part(t0, t1, t2, t3):
    """The shared odd-part rotation of ``jfdctint.c``/``jidctint.c``;
    returns the four products summed as each file combines them."""
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175
    t0, t1, t2, t3 = t0 * F_0_298, t1 * F_2_053, t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of ``jpeg_fdct_islow`` along the last axis."""
    x = [d[..., i] for i in range(8)]
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
        bits = CONST_BITS - PASS1_BITS
    else:
        out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
        bits = CONST_BITS + PASS1_BITS
    z1 = (t12 + t13) * F_0_541
    out[2] = _descale(z1 + t13 * F_0_765, bits)
    out[6] = _descale(z1 + t12 * -F_1_847, bits)
    o7, o5, o3, o1 = _odd_part(t4, t5, t6, t7)
    out[7], out[5], out[3], out[1] = (_descale(v, bits) for v in (o7, o5, o3, o1))
    return np.stack(out, axis=-1)


def forward_dct(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) level-shifted samples -> coefficients scaled up by 8."""
    rows = _fdct_pass(blocks.astype(np.int64), True)
    return _fdct_pass(rows.swapaxes(-1, -2), False).swapaxes(-1, -2)


def quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's ``quantize`` with the reciprocals of
    ``compute_reciprocal(quantval << 3)``: |q| = ((|t| + c) * fq) >> r."""
    divisor = qtable.astype(np.int64) << 3
    b = np.floor(np.log2(divisor)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // divisor, (1 << r) % divisor
    c = divisor // 2
    power2 = fr == 0
    fq = np.where(power2, fq >> 1, np.where(fr > divisor // 2, fq + 1, fq))
    r = np.where(power2, r - 1, r)
    c = np.where(~power2 & (fr <= divisor // 2), c + 1, c)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _idct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of ``jpeg_idct_islow`` along the last axis."""
    x = [d[..., i] for i in range(8)]
    z1 = (x[2] + x[6]) * F_0_541
    t2, t3 = z1 + x[6] * -F_1_847, z1 + x[2] * F_0_765
    t0, t1 = (x[0] + x[4]) << CONST_BITS, (x[0] - x[4]) << CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd_part(x[7], x[5], x[3], x[1])
    bits = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return np.stack([_descale(v, bits) for v in out], axis=-1)


def _idct_range_limit() -> np.ndarray:
    """``jdmaster.c::prepare_range_limit_table``'s post-IDCT part, indexed
    by the descaled value & 1023."""
    idx = np.arange(1024)
    return np.select([idx < 128, idx < 512, idx < 896], [idx + 128, 255, 0],
                     idx - 896).astype(np.uint8)


_RANGE = _idct_range_limit()


def inverse_dct(q: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(N, 8, 8) quantized coefficients -> uint8 samples."""
    deq = q.astype(np.int64) * qtable
    cols = _idct_pass(deq.swapaxes(-1, -2), True).swapaxes(-1, -2)
    return _RANGE[_idct_pass(cols, False) & 1023]


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2).reshape(-1, 8, 8)


def _from_blocks(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    return blocks.reshape(h // 8, w // 8, 8, 8).swapaxes(1, 2).reshape(h, w)


def _plane_round_trip(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """One component whose sides are multiples of 8: DCT, quantize, back."""
    h, w = plane.shape
    coef = forward_dct(_to_blocks(plane.astype(np.int64) - 128))
    return _from_blocks(inverse_dct(quantize(coef, qtable), qtable), h, w)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """``jccolor.c::rgb_ycc_convert`` (uint8 (H, W, 3) -> int64 planes)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << (SCALEBITS - 1), 128 << SCALEBITS
    fix = lambda v: _fix(v, SCALEBITS)  # noqa: E731
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> SCALEBITS
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> SCALEBITS
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> SCALEBITS
    return np.stack([y, cb, cr])


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert`` on int64 planes -> uint8 (H, W, 3)."""
    half = 1 << (SCALEBITS - 1)
    fix = lambda v: _fix(v, SCALEBITS)  # noqa: E731
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * x_cr + half) >> SCALEBITS)
    g = y + ((-fix(0.34414) * x_cb + half - fix(0.71414) * x_cr) >> SCALEBITS)
    b = y + ((fix(1.77200) * x_cb + half) >> SCALEBITS)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """``jcsample.c::h2v2_downsample`` of an even-sided plane."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def upsample_h2v2_fancy(plane: np.ndarray) -> np.ndarray:
    """``jdsample.c::h2v2_fancy_upsample``: each output sample is 9/16,
    3/16, 3/16 and 1/16 of its four nearest inputs, the edges repeated.
    A plane at most 2 samples wide takes ``h2v2_upsample`` (each sample
    repeated 2x2), as ``jinit_upsampler`` chooses."""
    p = plane.astype(np.int64)
    if p.shape[1] <= 2:
        return p.repeat(2, axis=0).repeat(2, axis=1)
    up = np.concatenate([p[:1], p[:-1]])
    down = np.concatenate([p[1:], p[-1:]])
    h, w = p.shape
    out = np.empty((2 * h, 2 * w), np.int64)
    for v, near in ((0, up), (1, down)):
        colsum = 3 * p + near
        left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * colsum + left + 8) >> 4
        out[v::2, 1::2] = (3 * colsum + right + 7) >> 4
    return out


def jpeg_round_trip(arr: np.ndarray, quality: int = 75) -> np.ndarray:
    """Encode and decode a uint8 ``L`` (H, W) or ``RGB`` (H, W, 3) image as
    Pillow's ``save(format="JPEG", quality=quality)`` and ``open`` do."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"jpeg_round_trip takes uint8 samples, got {arr.dtype}")
    h, w = arr.shape[:2]
    luma_q = quant_table(quality, STD_LUMINANCE)
    if arr.ndim == 2:
        padded = _pad_edge(arr.astype(np.int64), -(-h // 8) * 8, -(-w // 8) * 8)
        return _plane_round_trip(padded, luma_q)[:h, :w].astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"jpeg_round_trip takes (H, W) or (H, W, 3), got {arr.shape}")
    chroma_q = quant_table(quality, STD_CHROMINANCE)
    y, cb, cr = rgb_to_ycbcr(arr)
    # luma: whole blocks; chroma: the image padded to an even height and to
    # whole 16-column MCUs, downsampled, then padded to whole 8-row blocks
    y_dec = _plane_round_trip(_pad_edge(y, -(-h // 8) * 8, -(-w // 8) * 8), luma_q)[:h, :w]
    ch, cw = -(-h // 2), -(-w // 2)
    chroma = []
    for plane in (cb, cr):
        small = downsample_h2v2(_pad_edge(plane, 2 * ch, -(-w // 16) * 16))
        small = _pad_edge(small, -(-h // 16) * 8, small.shape[1])
        dec = _plane_round_trip(small, chroma_q)[:ch, :cw]
        chroma.append(upsample_h2v2_fancy(dec)[:h, :w])
    return ycbcr_to_rgb(y_dec.astype(np.int64), *chroma)
