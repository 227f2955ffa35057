"""Baseline JPEG decoding in numpy, as Pillow (libjpeg-turbo) decodes.

The port has no PIL; the REFUGE and RIGA raw trees hold JPEGs
(``data/retina.py``). This reads the files Pillow and cameras write in
baseline form:

- markers: SOI, APPn and COM (skipped, but for Adobe's colour transform),
  DQT (8-bit tables), SOF0 (baseline), DHT, SOS, DRI with RSTn, EOI;
- sequential Huffman decoding with byte stuffing, restart intervals, DC
  prediction and the zig-zag order, interleaved and single-component scans;
- 1 component (``L``) or 3 (``RGB``, YCbCr unless the component ids are
  'R', 'G', 'B' or an Adobe marker says untransformed) at any sampling
  factors whose chroma is upsampled 1x1, 2x1 (4:2:2) or 2x2 (4:2:0).

Then libjpeg's decompression defaults, which ``data/jpeg.py`` already
carries for the codec round trip: dequantization and the "islow" inverse DCT
with its wrapping range limit (:func:`jpeg.inverse_dct`), the "fancy"
(triangle) chroma upsampling (:func:`jpeg.upsample_h2v2_fancy`, and here
``jdsample.c::h2v1_fancy_upsample``) and the fixed-point YCbCr -> RGB
(:func:`jpeg.ycbcr_to_rgb`). The result equals Pillow's decode bit for bit
(``tests/test_torch_port_image_decode.py``).

Progressive, arithmetic-coded, 12-bit, lossless and hierarchical files, and
any colour form but 1 or 3 components (CMYK among them), raise with the SOF
marker or the component count and the path: there is no fallback.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .jpeg import inverse_dct, upsample_h2v2_fancy, ycbcr_to_rgb

# natural (row-major) index of the k-th coefficient in zig-zag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

SOF_NAMES = {0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
             0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
             0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
             0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
             0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
             0xCD: "SOF13", 0xCE: "SOF14", 0xCF: "SOF15"}


class HuffmanTable:
    """A DHT table as two 65536-entry lookups on the next 16 bits: the
    symbol and the length of its code (0 where no code matches)."""

    def __init__(self, counts: bytes, symbols: bytes):
        if len(counts) != 16 or len(symbols) != sum(counts) or sum(counts) > 256:
            raise ValueError("corrupt JPEG Huffman table")
        self.symbol = [0] * 65536
        self.length = [0] * 65536
        code, k = 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                lo, hi = code << (16 - bits), (code + 1) << (16 - bits)
                self.symbol[lo:hi] = [symbols[k]] * (hi - lo)
                self.length[lo:hi] = [bits] * (hi - lo)
                code += 1
                k += 1
            code <<= 1


class _Component:
    def __init__(self, ident: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = ident, h, v, tq


def _segments(blob: bytes, start: int, path) -> tuple[list[bytes], int]:
    """The entropy-coded data of a scan from ``start``, split at its RSTn
    markers, each part unstuffed (FF 00 -> FF); and the position of the
    marker that ends the scan."""
    parts, pos = [], start
    while True:
        end = blob.find(b"\xff", pos)
        while end >= 0 and end + 1 < len(blob) and blob[end + 1] in (0x00, 0xFF):
            if blob[end + 1] == 0x00:
                end = blob.find(b"\xff", end + 2)
            else:  # fill bytes before a marker
                end += 1
        if end < 0 or end + 1 >= len(blob):
            raise ValueError(f"{path}: the scan has no closing marker")
        # the segment up to ``end``, with FF 00 stuffing removed (FF fill too)
        parts.append(blob[pos:end].replace(b"\xff\x00", b"\xff"))
        marker = blob[end + 1]
        if 0xD0 <= marker <= 0xD7:
            pos = end + 2
            continue
        return parts, end


def _decode_segment(data: bytes, units: list, index: list, values: list, path) -> None:
    """Huffman-decode the blocks ``units`` [(component, dc table, ac
    table, block offset), ...] from ``data``; record each non-zero
    coefficient's flat index (block offset * 64 + zig-zag k) and value."""
    buf = data + b"\x00\x00\x00\x00"  # libjpeg reads zeros past the data
    nbits = len(data) * 8
    pos = 0
    dc_pred = {}  # each restart interval starts its predictions at 0
    for comp, dc, ac, base in units:
        window = (buf[pos >> 3] << 16 | buf[(pos >> 3) + 1] << 8 | buf[(pos >> 3) + 2])
        peek = (window >> (8 - (pos & 7))) & 0xFFFF
        s, n = dc.symbol[peek], dc.length[peek]
        if n == 0:
            raise ValueError(f"{path}: corrupt JPEG data (no DC code matches)")
        pos += n
        diff = 0
        if s:
            window = (buf[pos >> 3] << 16 | buf[(pos >> 3) + 1] << 8 | buf[(pos >> 3) + 2])
            diff = (window >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
            if diff < (1 << (s - 1)):
                diff -= (1 << s) - 1
            pos += s
        dc_pred[comp] = dc_pred.get(comp, 0) + diff
        index.append(base)
        values.append(dc_pred[comp])
        k = 1
        while k < 64:
            window = (buf[pos >> 3] << 16 | buf[(pos >> 3) + 1] << 8 | buf[(pos >> 3) + 2])
            peek = (window >> (8 - (pos & 7))) & 0xFFFF
            rs, n = ac.symbol[peek], ac.length[peek]
            if n == 0:
                raise ValueError(f"{path}: corrupt JPEG data (no AC code matches)")
            pos += n
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    break  # end of block
                k += 16
                continue
            k += r
            window = (buf[pos >> 3] << 16 | buf[(pos >> 3) + 1] << 8 | buf[(pos >> 3) + 2])
            v = (window >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pos += s
            if k > 63:
                raise ValueError(f"{path}: corrupt JPEG data (coefficient past 63)")
            index.append(base + k)
            values.append(v)
            k += 1
    if pos > nbits + 32:
        raise ValueError(f"{path}: corrupt JPEG data (the scan ran past its data)")


def upsample_h2v1_fancy(plane: np.ndarray) -> np.ndarray:
    """``jdsample.c::h2v1_fancy_upsample``: each output sample is 3/4 of its
    nearer input and 1/4 of the farther one, the edges repeated; a plane at
    most 2 samples wide takes ``h2v1_upsample`` (each sample repeated), as
    ``jinit_upsampler`` chooses."""
    p = plane.astype(np.int64)
    if p.shape[1] <= 2:
        return p.repeat(2, axis=1)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def decode_jpeg(path: str | Path) -> np.ndarray:
    """(H, W) uint8 of a grayscale or (H, W, 3) uint8 of a colour baseline
    JPEG, as ``np.array(Image.open(path))`` gives (Pillow's ``L`` / ``RGB``)."""
    blob = Path(path).read_bytes()
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{path} is not a JPEG (no SOI marker)")
    qtables: dict[int, np.ndarray] = {}
    huffman: dict[tuple[int, int], HuffmanTable] = {}
    comps: list[_Component] = []
    width = height = 0
    restart = 0
    adobe_transform = None
    coef = None
    pos = 2
    while True:
        while pos < len(blob) and blob[pos] == 0xFF and pos + 1 < len(blob) \
                and blob[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > len(blob) or blob[pos] != 0xFF:
            raise ValueError(f"{path}: JPEG ends before its EOI marker")
        marker = blob[pos + 1]
        if marker == 0xD9:  # EOI
            break
        if pos + 4 > len(blob):
            raise ValueError(f"{path}: JPEG ends inside a marker segment")
        length = int.from_bytes(blob[pos + 2:pos + 4], "big")
        seg = blob[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq != 0:
                    raise ValueError(f"{path}: 16-bit quantization tables are not read")
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                qtables[tq] = table.reshape(8, 8)
                i += 65
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                try:
                    huffman[(tc, th)] = HuffmanTable(counts, seg[i + 17:i + 17 + total])
                except ValueError as exc:
                    raise ValueError(f"{path}: {exc}") from None
                i += 17 + total
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker in SOF_NAMES:
            if marker != 0xC0:
                raise ValueError(f"{path}: {SOF_NAMES[marker]} JPEG is not read (baseline "
                                 f"SOF0 only)")
            precision = seg[0]
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG samples are not read")
            height, width = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            n = seg[5]
            if n not in (1, 3):
                raise ValueError(f"{path}: JPEG of {n} components is not read (1 or 3)")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                seg[8 + 3 * i]) for i in range(n)]
            if height == 0:
                raise ValueError(f"{path}: JPEG height 0 (a DNL marker) is not read")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.blocks = (mcuy * c.v, mcux * c.h)  # the block grid, whole MCUs
                c.size = (-(-height * c.v // vmax), -(-width * c.h // hmax))
            offsets = np.cumsum([0] + [c.blocks[0] * c.blocks[1] for c in comps])
            coef = {"index": [], "values": [], "offsets": offsets}
        elif marker == 0xDA:  # SOS
            if coef is None:
                raise ValueError(f"{path}: JPEG scan before its SOF marker")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                k = next(j for j, c in enumerate(comps) if c.id == cid)
                scan.append((k, huffman[(0, tables >> 4)], huffman[(1, tables & 15)]))
            units = _scan_units(comps, scan, coef["offsets"], width, height)
            parts, pos = _segments(blob, pos, path)
            per = restart * (len(units) // _mcu_count(comps, scan, width, height)) \
                if restart else len(units)
            for j, part in enumerate(parts):
                _decode_segment(part, units[j * per:(j + 1) * per], coef["index"],
                                coef["values"], path)
        elif marker in (0xC8,) or 0xF0 <= marker <= 0xFD:
            raise ValueError(f"{path}: JPEG marker {marker:#04x} is not read")
        # APPn, COM and anything else: skipped
    if coef is None:
        raise ValueError(f"{path}: JPEG without a frame")
    flat = np.zeros(int(coef["offsets"][-1]) * 64, np.int64)
    flat[np.asarray(coef["index"], np.int64)] = coef["values"]
    planes = []
    for k, c in enumerate(comps):
        if c.tq not in qtables:
            raise ValueError(f"{path}: JPEG quantization table {c.tq} is missing")
        zz = flat[coef["offsets"][k] * 64:coef["offsets"][k + 1] * 64].reshape(-1, 64)
        natural = np.zeros_like(zz)
        natural[:, ZIGZAG] = zz
        samples = inverse_dct(natural.reshape(-1, 8, 8), qtables[c.tq])
        by, bx = c.blocks
        plane = samples.reshape(by, bx, 8, 8).swapaxes(1, 2).reshape(by * 8, bx * 8)
        planes.append(plane[:c.size[0], :c.size[1]])
    if len(comps) == 1:
        return planes[0][:height, :width].copy()
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    full = []
    for c, plane in zip(comps, planes):
        fh, fv = hmax // c.h, vmax // c.v
        if hmax % c.h or vmax % c.v or (fh, fv) not in ((1, 1), (2, 1), (2, 2)):
            raise ValueError(f"{path}: JPEG sampling {[(q.h, q.v) for q in comps]} needs an "
                             f"upsampling by {(fh, fv)}, which is not read")
        up = {(1, 1): lambda p: p.astype(np.int64), (2, 1): upsample_h2v1_fancy,
              (2, 2): upsample_h2v2_fancy}[(fh, fv)](plane)
        full.append(up[:height, :width])
    rgb_ids = [c.id for c in comps] == [ord("R"), ord("G"), ord("B")]
    if adobe_transform == 0 or (adobe_transform is None and rgb_ids):
        return np.stack(full, axis=-1).astype(np.uint8)
    return ycbcr_to_rgb(*full)


def _mcu_count(comps, scan, width: int, height: int) -> int:
    if len(scan) == 1:
        c = comps[scan[0][0]]
        return -(-c.size[0] // 8) * -(-c.size[1] // 8)
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    return -(-width // (8 * hmax)) * -(-height // (8 * vmax))


def _scan_units(comps, scan, offsets, width: int, height: int) -> list:
    """The scan's blocks in decoding order: (component, DC table, AC table,
    flat coefficient offset of the block). A single-component scan runs
    over the component's own blocks in raster order (one block an MCU);
    an interleaved one over whole MCUs, each component's h x v blocks."""
    units = []
    if len(scan) == 1:
        k, dc, ac = scan[0]
        c = comps[k]
        rows, cols = -(-c.size[0] // 8), -(-c.size[1] // 8)
        for by in range(rows):
            for bx in range(cols):
                units.append((k, dc, ac, int(offsets[k] + by * c.blocks[1] + bx) * 64))
        return units
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    for my in range(-(-height // (8 * vmax))):
        for mx in range(-(-width // (8 * hmax))):
            for k, dc, ac in scan:
                c = comps[k]
                for v in range(c.v):
                    for h in range(c.h):
                        block = (my * c.v + v) * c.blocks[1] + mx * c.h + h
                        units.append((k, dc, ac, int(offsets[k] + block) * 64))
    return units
