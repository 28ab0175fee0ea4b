"""The port's PNG reader and writer (``orbslam3_tpu_torch/utils/imageio.py``)
against OpenCV on the CPU: files that ``cv2.imwrite`` writes (grey, BGR,
BGRA, 16-bit grey) read exactly as ``cv2.imread`` reads them under each
flag; files with every scanline filter decode exactly; the port's files
read back exactly in both readers. Tolerance: none, every pixel equal."""
import struct
import zlib

import cv2
import numpy as np
import pytest

from orbslam3_tpu_torch.utils import imageio

_FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "gray": cv2.IMREAD_GRAYSCALE,
          "color": cv2.IMREAD_COLOR}


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:60, 0:90]
    g = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
         + rng.normal(0, 8, (60, 90))).clip(0, 255).astype(np.uint8)
    bgr = np.stack([g, np.roll(g, 5, 1), 255 - g], -1)
    return {"grey": g, "bgr": bgr, "bgra": np.concatenate([bgr, g[..., None]], -1),
            "grey16": g.astype(np.uint16) * 200 + rng.integers(0, 200, g.shape, dtype=np.uint16)}


@pytest.mark.parametrize("mode", sorted(_FLAGS))
@pytest.mark.parametrize("kind", ["grey", "bgr", "bgra", "grey16"])
def test_reads_what_cv2_writes_as_cv2_reads_it(tmp_path, kind, mode):
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, _images()[kind])
    got, want = imageio.imread(path, mode), cv2.imread(path, _FLAGS[mode])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _filtered_png(img: np.ndarray, ftypes) -> bytes:
    """An 8-bit grey or RGB PNG whose row r uses filter ftypes[r]."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.int64)
    bpp = x.shape[-1]
    rows = []
    for r in range(h):
        cur = x[r].reshape(-1)
        prev = x[r - 1].reshape(-1) if r else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [np.zeros_like(cur), a, prev, (a + prev) // 2, paeth][ftypes[r]]
        rows.append(np.concatenate([[ftypes[r]], (cur - pred) % 256]).astype(np.uint8))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3])
def test_every_scanline_filter(tmp_path, channels):
    """Rows filtered None, Sub, Up, Average and Paeth, in runs and mixed,
    decode to the image, as cv2 decodes them."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    ftypes = [0, 1, 2, 3, 4, 4, 3, 3, 2, 1, 0, 4, 1, 3, 2] + [4] * 4 + [3] * 4
    path = tmp_path / "filtered.png"
    path.write_bytes(_filtered_png(img, ftypes))
    assert np.array_equal(imageio.decode_png(path.read_bytes()), img)
    assert np.array_equal(imageio.imread(str(path), "unchanged"),
                          cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["grey", "bgr", "bgra", "grey16"])
def test_round_trip(tmp_path, kind):
    img = _images()[kind]
    path = str(tmp_path / f"{kind}.png")
    imageio.imwrite(path, img)
    assert np.array_equal(imageio.imread(path), img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_rejects_a_corrupt_file(tmp_path):
    data = bytearray(imageio.encode_png(_images()["grey"]))
    data[40] ^= 0xFF                      # inside IDAT: the CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        imageio.decode_png(bytes(data))
