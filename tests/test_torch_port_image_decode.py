"""The port's decoders (``infer/image_io.py``: PNG and TIFF;
``data/jpeg_decode.py``: baseline JPEG) held to Pillow in every pixel, on
files Pillow writes (and, for the forms Pillow does not write, files built
here and read by Pillow too); ``convert_rgb``/``convert_l`` held to
Pillow's ``convert``; the forms that are not read raise."""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from diffuncertainty_tpu_torch.data.jpeg_decode import decode_jpeg
from diffuncertainty_tpu_torch.infer import image_io
from torch_threads import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).parent / "fixtures" / "retina_jpeg"


def picture(h, w, channels, seed):
    """Smooth gradients, edges and noise: rows that make Pillow's adaptive
    PNG filter pick every filter, and JPEG blocks of every kind."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(yy / 5.0 + seed)[..., None] + 50 * np.cos(xx / 7.0)[..., None]
    base = base + np.arange(channels) * 20 + rng.normal(0, 6, (h, w, channels))
    base[h // 3:h // 2] = rng.integers(0, 256, (len(range(h // 3, h // 2)), w, channels))
    out = np.clip(base, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def png_filters(path) -> set:
    blob = Path(path).read_bytes()
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        header = struct.unpack(">IIBBBBB", data) if kind == b"IHDR" else header
        idat += data if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, depth, colour = header[:4]
    samples = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
    raw = zlib.decompress(idat)
    stride = (w * samples * depth + 7) // 8 + 1
    return {raw[y * stride] for y in range(h)}


def assert_like_pillow(path):
    ref_im = Image.open(path)
    got = image_io.read_image(path)
    ref = np.array(ref_im)
    assert got.mode == ref_im.mode
    assert got.array.dtype == ref.dtype and np.array_equal(got.array, ref)
    assert np.array_equal(image_io.convert_rgb(got), np.array(ref_im.convert("RGB")))
    assert np.array_equal(image_io.convert_l(got), np.array(ref_im.convert("L")))
    return got


# -------------------------------------------------------------------- PNG

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "1"])
def test_png_modes_equal_pillow(tmp_path, mode):
    seen = set()
    channels = {"RGB": 3, "RGBA": 4, "L": 1, "1": 1}[mode]
    for seed, (h, w) in enumerate([(37, 53), (1, 9), (64, 31)]):
        arr = picture(h, w, channels, seed)
        image = Image.fromarray(arr > 127) if mode == "1" else Image.fromarray(arr)
        path = tmp_path / f"{mode}_{seed}.png"
        image.save(path)
        assert_like_pillow(path)
        seen |= png_filters(path)
    if mode != "1":
        assert seen >= {0, 1, 2, 4}, seen  # Pillow's adaptive filter took these
        # and every filter forced on every row, Average (3) among them
        arr = picture(9, 11, channels, 5).reshape(9, -1)
        for kind in range(5):
            raw_png(tmp_path / f"f{kind}.png", arr, 11, 8, {1: 0, 3: 2, 4: 6}[channels],
                    row_filter=kind, bpp=channels)
            assert png_filters(tmp_path / f"f{kind}.png") == {kind}
            assert_like_pillow(tmp_path / f"f{kind}.png")


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_png_equals_pillow(tmp_path, bits):
    rng = np.random.default_rng(bits)
    for entries in (1 << bits, max(2, (1 << bits) - 1)):
        idx = rng.integers(0, entries, (29, 43)).astype(np.uint8)
        image = Image.fromarray(idx, mode="P")
        image.putpalette(rng.integers(0, 256, 3 * entries).tolist())
        path = tmp_path / f"p{bits}_{entries}.png"
        image.save(path, bits=bits)
        got = assert_like_pillow(path)
        assert got.palette[:3 * entries] == list(np.array(image.getpalette()[:3 * entries]))


def filter_rows(rows: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """PNG filter ``kind`` applied to every row (the encoder's side, by the
    specification's definitions), each row led by its filter byte."""
    out = []
    prev = [0] * rows.shape[1]
    for row in rows.tolist():
        line = []
        for x, value in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b, c = prev[x], prev[x - bpp] if x >= bpp else 0
            pred = [0, a, b, (a + b) >> 1, image_io._paeth(a, b, c)][kind]
            line.append((value - pred) & 0xFF)
        out.append([kind] + line)
        prev = row
    return np.asarray(out, np.uint8)


def raw_png(path, image_rows: np.ndarray, width: int, depth: int, colour: int,
            interlace: int = 0, row_filter: int = 0, bpp: int = 1) -> None:
    """A PNG of packed rows under one filter, for the forms Pillow does not
    write."""
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h = image_rows.shape[0]
    rows = filter_rows(image_rows, row_filter, bpp)
    Path(path).write_bytes(
        image_io.PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", width, h, depth, colour, 0, 0, interlace))
        + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [2, 4])
def test_low_depth_gray_png_equals_pillow(tmp_path, depth):
    w = 13
    values = np.random.default_rng(depth).integers(0, 1 << depth, (7, w)).astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((7, -(-w // per) * per), np.uint8)
    padded[:, :w] = values
    shifts = np.arange(8 - depth, -1, -depth)
    packed = (padded.reshape(7, -1, per) << shifts).sum(axis=2).astype(np.uint8)
    raw_png(tmp_path / "g.png", packed, w, depth, 0)
    assert_like_pillow(tmp_path / "g.png")


def test_png_forms_not_read_raise(tmp_path):
    rows = np.zeros((4, 8), np.uint8)
    raw_png(tmp_path / "interlaced.png", rows, 8, 8, 0, interlace=1)
    Image.fromarray(np.zeros((4, 4), np.uint16) + 300).save(tmp_path / "sixteen.png")
    Image.fromarray(np.zeros((4, 4, 2), np.uint8), mode="LA").save(tmp_path / "la.png")
    for name in ("interlaced.png", "sixteen.png", "la.png"):
        with pytest.raises(ValueError, match=name):
            image_io.read_image(tmp_path / name)


# ------------------------------------------------------------------- TIFF

@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("order, compression", [(b"II", None), (b"II", "packbits"),
                                                (b"MM", None)])
def test_tiff_equals_pillow(tmp_path, monkeypatch, compression, mode, order):
    # Pillow writes 8-bit L and RGB little-endian; its byte-order prefix
    # swapped gives the same file big-endian (its PackBits writer, libtiff,
    # keeps little-endian)
    rawmode, _, *rest = TiffImagePlugin.SAVE_INFO[mode]
    monkeypatch.setitem(TiffImagePlugin.SAVE_INFO, mode, (rawmode, order, *rest))
    for seed, (h, w) in enumerate([(300, 211), (5, 3)]):  # several strips, then one
        arr = picture(h, w, 3 if mode == "RGB" else 1, seed)
        path = tmp_path / f"t{seed}.tif"
        Image.fromarray(arr).save(path, compression=compression)
        assert Path(path).read_bytes()[:2] == order
        assert_like_pillow(path)


def test_tiff_writer_round_trips_through_pillow(tmp_path):
    for arr in (picture(19, 23, 3, 0), picture(19, 23, 1, 1),
                np.random.default_rng(2).random((6, 5)).astype(np.float32)):
        image_io.write_tiff(tmp_path / "w.tif", arr)
        assert np.array_equal(np.array(Image.open(tmp_path / "w.tif")), arr)
        assert np.array_equal(image_io.read_tiff(tmp_path / "w.tif"), arr)


def test_tiff_forms_not_read_raise(tmp_path):
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "lzw.tif",
                                                        compression="tiff_lzw")
    Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(tmp_path / "rgba.tif")
    for name in ("lzw.tif", "rgba.tif"):
        with pytest.raises(ValueError, match=name):
            image_io.read_image(tmp_path / name)


# ------------------------------------------------------------------- JPEG

JPEG_SIZES = [(37, 53), (1, 17), (23, 2), (70, 45)]


@pytest.mark.parametrize("subsampling", [0, 1, 2])  # 4:4:4, 4:2:2, 4:2:0
def test_rgb_jpeg_equals_pillow(tmp_path, subsampling):
    for i, (h, w) in enumerate(JPEG_SIZES):
        for quality in (50, 75, 95):
            for restart in (0, 2):
                arr = picture(h, w, 3, i)
                kw = {"restart_marker_blocks": restart} if restart else {}
                path = tmp_path / "c.jpg"
                Image.fromarray(arr).save(path, quality=quality, subsampling=subsampling, **kw)
                assert_like_pillow(path)


def test_gray_jpeg_equals_pillow(tmp_path):
    for i, (h, w) in enumerate(JPEG_SIZES):
        for quality in (50, 75, 95):
            for restart in (0, 3):
                kw = {"restart_marker_blocks": restart} if restart else {}
                path = tmp_path / "g.jpg"
                Image.fromarray(picture(h, w, 1, i)).save(path, quality=quality, **kw)
                assert_like_pillow(path)


@pytest.mark.parametrize("name", ["fundus_420", "fundus_444", "fundus_gray"])
def test_committed_jpeg_fixtures_decode_to_their_npy(name):
    got = decode_jpeg(FIXTURES / f"{name}.jpg")
    assert np.array_equal(got, np.load(FIXTURES / f"{name}.npy"))


def test_jpeg_forms_not_read_raise(tmp_path):
    arr = picture(20, 20, 3, 0)
    Image.fromarray(arr).save(tmp_path / "progressive.jpg", progressive=True)
    with pytest.raises(ValueError, match="progressive.jpg.*SOF2"):
        decode_jpeg(tmp_path / "progressive.jpg")
    Image.fromarray(arr).convert("CMYK").save(tmp_path / "cmyk.jpg")
    with pytest.raises(ValueError, match="cmyk.jpg.*4 components"):
        image_io.read_image(tmp_path / "cmyk.jpg")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    (tmp_path / "cut.jpg").write_bytes(buf.getvalue()[:200])
    with pytest.raises(ValueError, match="cut.jpg"):
        decode_jpeg(tmp_path / "cut.jpg")
