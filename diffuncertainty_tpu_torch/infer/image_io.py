"""PNG and TIFF files of the results tree, without PIL.

The JAX package writes its masks and heatmaps with PIL
(``diffuncertainty_tpu/infer/results.py``); the port writes the same forms
itself:

- 8-bit grayscale (``L``) and palette (``P``, with a ``PLTE`` chunk) PNGs,
  deflated by ``zlib`` at level 1, each row unfiltered (and 8-bit ``RGB``
  ones, the report's image panels, which the port writes and does not read);
- float32 TIFFs: little-endian, uncompressed, one strip, ``SampleFormat`` 3
  (IEEE float), as PIL's mode ``F`` writes them.

The readers take those forms, whoever wrote them: a PNG of one channel,
8-bit grayscale or a palette of 1, 2, 4 or 8 bits (PIL writes a short
palette at the depth it needs), not interlaced, with any of the five row
filters (PIL filters its grayscale rows); a little-endian uncompressed
float32 TIFF of one sample per pixel in any number of strips.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB, _PALETTE = 0, 2, 3  # PNG colour types


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


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    """Undo the per-row PNG filters of ``h`` rows of ``w`` bytes (one
    channel of at most 8 bits: the filters step one byte)."""
    data = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        kind, line = data[y, 0], data[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub: running sum mod 256
            row = (np.cumsum(line, dtype=np.uint64) % 256).astype(np.uint8)
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: each pixel needs its left neighbour
            row = np.zeros(w, np.uint8)
            left = 0
            for x in range(w):
                up = int(prev[x])
                pred = ((left + up) // 2 if kind == 3
                        else _paeth(left, up, int(prev[x - 1]) if x else 0))
                left = (int(line[x]) + pred) & 0xFF
                row[x] = left
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prev = row
    return out


def read_png(path: str | Path, *, with_palette: bool = False):
    """(H, W) uint8 of a grayscale or palette PNG (palette indices for
    ``P``); with ``with_palette``, also the flat palette (None for ``L``)."""
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
    if (colour, depth) not in {(_GRAY, 8)} | {(_PALETTE, d) for d in (1, 2, 4, 8)} or interlace:
        raise ValueError(f"{path}: only 8-bit grayscale or palette PNGs without interlace "
                         f"are read (depth {depth}, colour type {colour}, interlace "
                         f"{interlace})")
    packed = _unfilter(zlib.decompress(b"".join(idat)), h, (w * depth + 7) // 8)
    if depth == 8:
        image = packed
    else:  # pixels packed from the high bits of each byte
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        image = ((packed[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    return (image, palette if colour == _PALETTE else None) if with_palette else image


# TIFF tags, field types and values of the one form written and read
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES, _PLANAR, _SAMPLE_FORMAT = (
    273, 277, 278, 279, 284, 339)
_SHORT, _LONG = 3, 4
_IEEE_FLOAT = 3


def write_tiff(path: str | Path, image: np.ndarray) -> None:
    """Write a (H, W) float32 ``image`` as a little-endian, uncompressed,
    one-strip TIFF of IEEE floats."""
    image = np.ascontiguousarray(image, dtype="<f4")
    if image.ndim != 2:
        raise ValueError(f"write_tiff takes a (H, W) array, got {image.shape}")
    h, w = image.shape
    pixels = image.tobytes()
    entries = [(_WIDTH, _LONG, w), (_LENGTH, _LONG, h), (_BITS, _SHORT, 32),
               (_COMPRESSION, _SHORT, 1), (_PHOTOMETRIC, _SHORT, 1),
               (_STRIP_OFFSETS, _LONG, 8), (_SAMPLES, _SHORT, 1), (_ROWS_PER_STRIP, _LONG, h),
               (_STRIP_BYTES, _LONG, len(pixels)), (_PLANAR, _SHORT, 1),
               (_SAMPLE_FORMAT, _SHORT, _IEEE_FLOAT)]
    ifd = struct.pack("<H", len(entries))
    for tag, kind, value in entries:
        ifd += struct.pack("<HHI", tag, kind, 1) + (
            struct.pack("<HH", value, 0) if kind == _SHORT else struct.pack("<I", value))
    ifd += struct.pack("<I", 0)  # no further IFD
    header = b"II*\x00" + struct.pack("<I", 8 + len(pixels))
    Path(path).write_bytes(header + pixels + ifd)


def read_tiff(path: str | Path) -> np.ndarray:
    """(H, W) float32 of a little-endian uncompressed float32 TIFF."""
    blob = Path(path).read_bytes()
    if blob[:4] != b"II*\x00":
        raise ValueError(f"{path} is not a little-endian TIFF")
    (ifd,) = struct.unpack("<I", blob[4:8])
    (n,) = struct.unpack("<H", blob[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        tag, kind, count, raw = struct.unpack("<HHI4s", blob[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        size = {_SHORT: 2, _LONG: 4}.get(kind)
        if size is None:
            continue  # a tag this form does not need (e.g. a resolution)
        fmt = "<" + ("H" if kind == _SHORT else "I") * count
        where = raw if size * count <= 4 else blob[struct.unpack("<I", raw)[0]:][:size * count]
        tags[tag] = struct.unpack(fmt, where[:size * count])
    want = {_BITS: 32, _COMPRESSION: 1, _SAMPLES: 1, _SAMPLE_FORMAT: _IEEE_FLOAT}
    for tag, value in want.items():
        got = tags.get(tag, (1,) if tag in (_SAMPLES, _COMPRESSION) else (None,))[0]
        if got != value:
            raise ValueError(f"{path}: tag {tag} is {got}, only float32 uncompressed "
                             f"single-sample TIFFs are read")
    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    pixels = b"".join(blob[o:o + c] for o, c in zip(tags[_STRIP_OFFSETS], tags[_STRIP_BYTES]))
    return np.frombuffer(pixels, "<f4", count=h * w).reshape(h, w).astype(np.float32)
