"""Write the baseline JPEG fixtures of the retina path with Pillow, and
Pillow's decode of each beside it as ``.npy``:

- ``fundus_420.jpg``: 512x512 RGB at Pillow's defaults (quality 75, 4:2:0);
- ``fundus_444.jpg``: the same image at ``subsampling=0`` (4:4:4);
- ``fundus_gray.jpg``: its luma (``L``), one component.

The image is a synthetic fundus: a dark field, a lit disc of the retina, a
bright optic disc with a brighter cup at (296, 196), a few vessels and
smoothed noise, all from seed 0. The port decodes the JPEGs without Pillow
(``diffuncertainty_tpu_torch/data/jpeg_decode.py``) and must give the
``.npy`` arrays in every pixel (``tests/test_torch_port_image_decode.py``
and ``chip_smoke.py``'s retina path, on a host without Pillow).

    python tests/fixtures/retina_jpeg/make_fixtures.py
"""

from pathlib import Path

import numpy as np
from PIL import Image
from scipy import ndimage as ndi

HERE = Path(__file__).resolve().parent
SIZE = 512
DISC_CENTER = (296, 196)  # (row, col) of the optic disc
DISC_RADIUS, CUP_RADIUS = 44, 20


def fundus(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE].astype(np.float64)
    r = np.hypot(yy - SIZE / 2, xx - SIZE / 2)
    field = np.clip((236 - r) / 20, 0, 1)  # the lit retina, a soft edge
    img = np.stack([150 * field + 8, 70 * field + 4, 30 * field + 2], axis=-1)
    d = np.hypot(yy - DISC_CENTER[0], xx - DISC_CENTER[1])
    img += np.clip((DISC_RADIUS - d) / 6, 0, 1)[..., None] * np.array([80, 90, 60])
    img += np.clip((CUP_RADIUS - d) / 4, 0, 1)[..., None] * np.array([20, 60, 80])
    for k in range(6):  # vessels: dark curves leaving the disc
        angle = k * np.pi / 3 + 0.3
        along = (xx - DISC_CENTER[1]) * np.cos(angle) + (yy - DISC_CENTER[0]) * np.sin(angle)
        across = -(xx - DISC_CENTER[1]) * np.sin(angle) + (yy - DISC_CENTER[0]) * np.cos(angle)
        bend = 20 * np.sin(along / 60.0)
        vessel = np.exp(-((across - bend) / 3.0) ** 2) * (along > 0) * field
        img -= vessel[..., None] * np.array([60, 40, 20])
    noise = ndi.gaussian_filter(rng.normal(0, 12, (SIZE, SIZE, 3)), sigma=(2, 2, 0))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def main() -> None:
    rgb = fundus()
    forms = {"fundus_420": (Image.fromarray(rgb), {}),
             "fundus_444": (Image.fromarray(rgb), {"subsampling": 0}),
             "fundus_gray": (Image.fromarray(rgb).convert("L"), {})}
    for name, (image, kw) in forms.items():
        path = HERE / f"{name}.jpg"
        image.save(path, **kw)
        np.save(HERE / f"{name}.npy", np.array(Image.open(path)))
        print(path.name, path.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
