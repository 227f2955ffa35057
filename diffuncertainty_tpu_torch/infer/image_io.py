"""PNG, TIFF and JPEG files without PIL.

The JAX package writes its masks and heatmaps with PIL
(``diffuncertainty_tpu/infer/results.py``) and opens the raw retina trees
with it (``diffuncertainty_tpu/data/retina.py``); the port writes and reads
those forms itself.

Writers:

- 8-bit grayscale (``L``), palette (``P``, with a ``PLTE`` chunk) and 8-bit
  ``RGB`` PNGs, deflated by ``zlib`` at level 1, each row unfiltered;
- TIFFs as PIL writes them by default: little-endian, uncompressed, one
  strip; float32 (``F``, ``SampleFormat`` 3) and uint8 ``L`` and ``RGB``.

Readers (each gives what ``np.array(Image.open(path))`` gives):

- PNG: 8-bit ``RGB`` and ``RGBA``, grayscale at 1 bit (PIL's mode ``1``, a
  bool array), 2, 4 (scaled to 0..255, as PIL unpacks ``L;2`` and ``L;4``)
  and 8 bits, palette at 1, 2, 4 and 8 bits (the indices; the ``PLTE``
  entries beside them), with any of the five row filters. Interlaced,
  16-bit and gray-with-alpha PNGs raise.
- TIFF: little- or big-endian, in any number of strips, uncompressed or
  PackBits: float32 of one sample, uint8 ``L`` (``BlackIsZero``) and uint8
  chunky ``RGB``. Any other compression, photometric or sample layout
  raises with the tag.
- JPEG: baseline only (``data/jpeg_decode.py``).

:func:`read_image` opens any of them by its signature and returns the mode
beside the array; :func:`convert_rgb` and :func:`convert_l` give what PIL's
``convert("RGB")`` and ``convert("L")`` give.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB, _PALETTE, _RGBA = 0, 2, 3, 6  # PNG colour types


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str | Path, image: np.ndarray, palette: list[int] | None = None, *,
              mode: str = "L") -> None:
    """Write a (H, W) uint8 ``image`` as an ``L`` or ``P`` PNG, or a (H, W,
    3) one as an ``RGB`` PNG. ``palette`` (``P`` only): flat [r, g, b, ...]
    entries; a grayscale ramp if None."""
    image = np.asarray(image)
    if mode not in ("L", "P", "RGB"):
        raise ValueError(f"mode must be L, P or RGB, got {mode!r}")
    ndim = 3 if mode == "RGB" else 2
    if (image.ndim != ndim or image.dtype != np.uint8
            or (mode == "RGB" and image.shape[-1] != 3)):
        raise ValueError(f"write_png in mode {mode} takes a "
                         f"{'(H, W, 3)' if mode == 'RGB' else '(H, W)'} uint8 array, got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    colour = {"L": _GRAY, "P": _PALETTE, "RGB": _RGB}[mode]
    image = image.reshape(h, -1)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    if mode == "P":
        entries = (np.repeat(np.arange(256, dtype=np.uint8), 3) if palette is None
                   else np.asarray(palette, dtype=np.uint8))
        if entries.size % 3 or not 3 <= entries.size <= 768:
            raise ValueError(f"a palette holds 1 to 256 rgb entries, got {entries.size} values")
        chunks.append(_chunk(b"PLTE", entries.tobytes()))
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image], axis=1)  # filter 0 per row
    # level 1: lossless like any level, and the fastest to encode (the JAX
    # writer asks PIL for the same)
    chunks.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
    chunks.append(_chunk(b"IEND", b""))
    Path(path).write_bytes(PNG_SIGNATURE + b"".join(chunks))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of ``h`` rows of ``stride`` bytes whose
    pixels are ``bpp`` bytes apart (1 below 8 bits a pixel)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, {h * (stride + 1)} needed")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: a running sum mod 256 per byte of the pixel
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            row = np.asarray(cur, np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prev = out[y]
    return out


# colour type -> (samples a pixel, PIL mode, the bit depths read)
_PNG_FORMS = {_GRAY: (1, "L", (1, 2, 4, 8)), _RGB: (3, "RGB", (8,)),
              _PALETTE: (1, "P", (1, 2, 4, 8)), _RGBA: (4, "RGBA", (8,))}


class Decoded(NamedTuple):
    """An image as PIL opens it: ``np.array(image)``, ``image.mode`` and, for
    ``P``, the flat ``PLTE`` entries [r, g, b, ...] (else None)."""

    array: np.ndarray
    mode: str
    palette: list[int] | None = None


def decode_png(path: str | Path) -> Decoded:
    blob = Path(path).read_bytes()
    if not blob.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG")
    pos, idat, palette, header = len(PNG_SIGNATURE), [], None, None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = list(data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    form = _PNG_FORMS.get(colour)
    if form is None or depth not in form[2] or interlace:
        raise ValueError(f"{path}: PNG of depth {depth}, colour type {colour}, interlace "
                         f"{interlace} is not read (8-bit RGB/RGBA, grayscale or palette "
                         f"at 1, 2, 4 or 8 bits, not interlaced)")
    samples, mode = form[:2]
    stride = (w * samples * depth + 7) // 8
    packed = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, samples * depth // 8))
    if depth == 8:
        image = packed.reshape(h, w, samples) if samples > 1 else packed
    else:  # pixels packed from the high bits of each byte
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        image = ((packed[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if colour == _GRAY and depth == 1:
            return Decoded(image.astype(bool), "1")
        if colour == _GRAY:  # PIL's L;2 and L;4 unpackers scale to 0..255
            image = image * np.uint8(255 // ((1 << depth) - 1))
    if colour == _PALETTE and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    return Decoded(image, mode, palette if colour == _PALETTE else None)


def read_png(path: str | Path, *, with_palette: bool = False):
    """The array PIL opens a PNG as (palette indices for ``P``); with
    ``with_palette``, also the flat palette (None unless ``P``)."""
    image, _, palette = decode_png(path)
    return (image, palette) if with_palette else image


def read_image(path: str | Path) -> Decoded:
    """A PNG, TIFF or baseline JPEG, chosen by the file's first bytes."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(PNG_SIGNATURE):
        return decode_png(path)
    if magic[:4] in (b"II*\x00", b"MM\x00*"):
        image = read_tiff(path)
        return Decoded(image, "F" if image.dtype == np.float32 else
                       ("RGB" if image.ndim == 3 else "L"))
    if magic[:2] == b"\xff\xd8":
        from ..data.jpeg_decode import decode_jpeg

        image = decode_jpeg(path)
        return Decoded(image, "RGB" if image.ndim == 3 else "L")
    raise ValueError(f"{path}: not a PNG, TIFF or JPEG file (starts {magic!r})")


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's integer ITU-R 601 luma ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _palette_rgb(image: Decoded) -> np.ndarray:
    """(256, 3) uint8 palette, entries past the ``PLTE`` chunk black."""
    table = np.zeros(768, np.uint8)
    table[:len(image.palette)] = image.palette
    return table.reshape(256, 3)


def convert_rgb(image: Decoded) -> np.ndarray:
    """(H, W, 3) uint8 as PIL's ``convert("RGB")``: ``RGBA`` drops alpha,
    ``L`` and ``1`` (0/255) repeat, ``P`` looks its palette up."""
    a, mode = image.array, image.mode
    if mode == "RGB":
        return a
    if mode == "RGBA":
        return np.ascontiguousarray(a[..., :3])
    if mode in ("L", "1"):
        gray = a.astype(np.uint8) * np.uint8(255) if mode == "1" else a
        return np.repeat(gray[..., None], 3, axis=2)
    if mode == "P":
        return _palette_rgb(image)[a]
    raise ValueError(f"convert_rgb: mode {mode} is not converted")


def convert_l(image: Decoded) -> np.ndarray:
    """(H, W) uint8 as PIL's ``convert("L")``: the luma of ``RGB``,
    ``RGBA`` (alpha ignored) and of each ``P`` palette entry; ``1`` as 0/255."""
    a, mode = image.array, image.mode
    if mode == "L":
        return a
    if mode == "1":
        return a.astype(np.uint8) * np.uint8(255)
    if mode in ("RGB", "RGBA"):
        return _luma(a)
    if mode == "P":
        return _luma(_palette_rgb(image))[a]
    raise ValueError(f"convert_l: mode {mode} is not converted")


# TIFF tags, field types and values of the forms written and read
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES, _PLANAR = 273, 277, 278, 279, 284
_PREDICTOR, _EXTRA_SAMPLES, _SAMPLE_FORMAT = 317, 338, 339
_BYTE, _SHORT, _LONG = 1, 3, 4
_FIELD = {_BYTE: "B", _SHORT: "H", _LONG: "I"}
_IEEE_FLOAT = 3
_PACKBITS = 32773
_BLACK_IS_ZERO, _PHOTOMETRIC_RGB = 1, 2


def write_tiff(path: str | Path, image: np.ndarray) -> None:
    """Write a (H, W) float32 (``F``), (H, W) uint8 (``L``) or (H, W, 3)
    uint8 (``RGB``) ``image`` as a little-endian, uncompressed, one-strip
    TIFF."""
    image = np.asarray(image)
    if image.dtype == np.uint8 and (image.ndim == 2 or image.shape[2:] == (3,)):
        samples = 1 if image.ndim == 2 else 3
        bits, fmt = 8, 1
    else:
        if image.ndim != 2:
            raise ValueError(f"write_tiff takes a (H, W) float32 or a (H, W) / (H, W, 3) uint8 "
                             f"array, got {image.dtype} {image.shape}")
        image, samples, bits, fmt = image.astype("<f4"), 1, 32, _IEEE_FLOAT
    h, w = image.shape[:2]
    pixels = np.ascontiguousarray(image).tobytes()
    # three BitsPerSample values do not fit an entry: they follow the pixels
    extra_at = 8 + len(pixels)
    extra = struct.pack("<HHH", 8, 8, 8) if samples == 3 else b""
    entries = [(_WIDTH, _LONG, 1, w), (_LENGTH, _LONG, 1, h),
               (_BITS, _SHORT, samples, extra_at if samples == 3 else bits),
               (_COMPRESSION, _SHORT, 1, 1),
               (_PHOTOMETRIC, _SHORT, 1, _PHOTOMETRIC_RGB if samples == 3 else _BLACK_IS_ZERO),
               (_STRIP_OFFSETS, _LONG, 1, 8), (_SAMPLES, _SHORT, 1, samples),
               (_ROWS_PER_STRIP, _LONG, 1, h), (_STRIP_BYTES, _LONG, 1, len(pixels)),
               (_PLANAR, _SHORT, 1, 1), (_SAMPLE_FORMAT, _SHORT, 1, fmt)]
    ifd = struct.pack("<H", len(entries))
    for tag, kind, count, value in entries:
        inline = kind == _SHORT and count == 1
        ifd += struct.pack("<HHI", tag, kind, count) + (
            struct.pack("<HH", value, 0) if inline else struct.pack("<I", value))
    ifd += struct.pack("<I", 0)  # no further IFD
    header = b"II*\x00" + struct.pack("<I", extra_at + len(extra))
    Path(path).write_bytes(header + pixels + extra + ifd)


def _unpack_packbits(data: bytes, size: int) -> bytes:
    """TIFF PackBits (compression 32773): a header byte n < 128 copies the
    next n + 1 bytes, n > 128 repeats the next byte 257 - n times."""
    out, i = bytearray(), 0
    while i < len(data) and len(out) < size:
        n = data[i]
        if n < 128:
            out += data[i + 1:i + n + 2]
            i += n + 2
        else:
            if n > 128:  # 128 is a no-op
                out += data[i + 1:i + 2] * (257 - n)
            i += 2 if n > 128 else 1
    return bytes(out[:size])


def read_tiff(path: str | Path) -> np.ndarray:
    """The first image of a TIFF: (H, W) float32 of IEEE floats, (H, W)
    uint8 of ``L`` or (H, W, 3) uint8 of chunky ``RGB``; little- or
    big-endian, any number of strips, uncompressed or PackBits."""
    blob = Path(path).read_bytes()
    order = {b"II*\x00": "<", b"MM\x00*": ">"}.get(blob[:4])
    if order is None:
        raise ValueError(f"{path} is not a TIFF")
    (ifd,) = struct.unpack(order + "I", blob[4:8])
    (n,) = struct.unpack(order + "H", blob[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        tag, kind, count, raw = struct.unpack(order + "HHI4s",
                                              blob[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if kind not in _FIELD:
            continue  # a tag these forms do not need (e.g. a resolution)
        size = struct.calcsize(_FIELD[kind]) * count
        where = raw if size <= 4 else blob[struct.unpack(order + "I", raw)[0]:][:size]
        tags[tag] = struct.unpack(order + _FIELD[kind] * count, where[:size])

    def tag(key, default=None):
        return tags.get(key, (default,))

    samples = tag(_SAMPLES, 1)[0]
    bits = set(tag(_BITS, 1))
    fmt = tag(_SAMPLE_FORMAT, 1)[0]
    photometric = tag(_PHOTOMETRIC)[0]
    if bits == {32} and samples == 1 and fmt == _IEEE_FLOAT:
        dtype = np.dtype(order + "f4")
    elif bits == {8} and fmt == 1 and (samples, photometric) in (
            (1, _BLACK_IS_ZERO), (3, _PHOTOMETRIC_RGB)):
        dtype = np.dtype(np.uint8)
    else:
        raise ValueError(f"{path}: TIFF with BitsPerSample {sorted(bits)}, SamplesPerPixel "
                         f"{samples}, SampleFormat {fmt}, Photometric {photometric} is not read "
                         f"(float32, 8-bit L or 8-bit RGB)")
    for key, allowed in ((_PLANAR, (1,)), (_PREDICTOR, (1,)), (_EXTRA_SAMPLES, (None,)),
                         (_COMPRESSION, (1, _PACKBITS))):
        got = tag(key, allowed[0])[0]
        if got not in allowed:
            raise ValueError(f"{path}: TIFF tag {key} is {got}, only {allowed} is read")
    compression = tag(_COMPRESSION, 1)[0]
    w, h = tag(_WIDTH)[0], tag(_LENGTH)[0]
    rows = tag(_ROWS_PER_STRIP, h)[0]
    row_bytes = w * samples * dtype.itemsize
    strips = []
    for k, (o, c) in enumerate(zip(tag(_STRIP_OFFSETS), tag(_STRIP_BYTES))):
        data = blob[o:o + c]
        if compression == _PACKBITS:
            data = _unpack_packbits(data, min(rows, h - k * rows) * row_bytes)
        strips.append(data)
    pixels = np.frombuffer(b"".join(strips), dtype, count=h * w * samples)
    shape = (h, w) if samples == 1 else (h, w, samples)
    return pixels.reshape(shape).astype(dtype.newbyteorder("="))
