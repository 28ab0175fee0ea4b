"""PNG read and write with ``zlib`` and numpy.

The machine with the card has no OpenCV and no Pillow, so the drivers and the
viewer read and write their images here, in place of ``cv2.imread`` /
``cv2.imwrite``. Supported: 8-bit grey, 8-bit RGB and RGBA, 8-bit grey with
alpha, and 16-bit grey, RGB and RGBA, not interlaced (every format the
EuRoC, KITTI, TUM-RGBD and TUM-VI sequences ship). ``imread`` returns what
``cv2.imread`` returns for the same flag: channels in BGR(A) order, and for
``mode="gray"`` libpng's own RGB → grey conversion (the weights
0.299 / 0.587 / rest in 15-bit fixed point, truncated) and the high byte of
a 16-bit sample.

The scanline filters None, Sub and Up are undone a row at a time; the
Average and Paeth filters, sequential along a row, along anti-diagonals:
pixel (r, c) depends on (r, c-1), (r-1, c) and (r-1, c-1) only, so every
pixel of one diagonal is decoded in one numpy step.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type → samples per pixel
# libpng's png_set_rgb_to_gray(…, 0.299, 0.587) coefficients (15-bit)
_RC = 29900 * 32768 // 100000
_GC = 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n: pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _wavefront(x: np.ndarray, ftype: np.ndarray, r0: int, r1: int) -> None:
    """Undo the filters of rows r0..r1-1 (any type; row r0-1 is decoded) in
    place, one anti-diagonal of the (r, c) grid per step."""
    h, w, bpp = x.shape
    zero = np.zeros((1, bpp), np.uint8)
    for d in range(r1 - r0 + w - 1):
        r = np.arange(max(0, d - w + 1), min(r1 - r0, d + 1)) + r0
        c = d - (r - r0)
        ft = ftype[r][:, None]
        a = np.where((c > 0)[:, None], x[r, np.maximum(c - 1, 0)], zero)
        b = np.where((r > 0)[:, None], x[np.maximum(r - 1, 0), c], zero)
        cc = np.where(((r > 0) & (c > 0))[:, None],
                      x[np.maximum(r - 1, 0), np.maximum(c - 1, 0)], zero)
        avg = ((a.astype(np.uint16) + b) >> 1).astype(np.uint8)
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, avg, _paeth(a, b, cc)], zero)
        x[r, c] += pred


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: ``raw`` is (h, 1 + w*bpp) bytes with the
    filter type first; returns (h, w, bpp) uint8. None, Sub and Up rows are
    whole-row numpy steps; a run of Average and Paeth rows (sequential along
    the row) goes through ``_wavefront``."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: bad filter type")
    x = raw[:, 1:].reshape(h, w, bpp).copy()
    r = 0
    while r < h:
        f = ftype[r]
        if f == 1:
            x[r] = np.cumsum(x[r], axis=0, dtype=np.uint8)
        elif f == 2 and r > 0:
            x[r] += x[r - 1]
        elif f >= 3:
            r1 = r
            while r1 < h and ftype[r1] >= 3:
                r1 += 1
            _wavefront(x, ftype, r, r1)
            r = r1
            continue
        r += 1
    return x


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → the image as stored: (h, w) or (h, w, C) uint8/uint16,
    channels in the file's order (grey, grey+alpha, RGB, RGBA)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"PNG: unsupported format (colour type {ctype}, depth {depth}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG: image data has the wrong size")
    x = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if depth == 16:
        x = x.reshape(h, w, ch, 2).astype(np.uint16)
        x = (x[..., 0] << 8) | x[..., 1]
    else:
        x = x.reshape(h, w, ch)
    return x[..., 0] if ch == 1 else x


def imread(path: str, mode: str = "unchanged") -> np.ndarray:
    """Read a PNG as ``cv2.imread`` does with IMREAD_UNCHANGED
    (``"unchanged"``: grey as (h, w), colour as BGR or BGRA, 16-bit kept),
    IMREAD_GRAYSCALE (``"gray"``: (h, w) uint8) or IMREAD_COLOR
    (``"color"``: (h, w, 3) uint8 BGR)."""
    with open(path, "rb") as f:
        x = decode_png(f.read())
    if x.ndim == 2:
        x = x[..., None]
    ch = x.shape[-1]
    if mode == "unchanged":
        if ch == 1:
            return x[..., 0]
        if ch == 2:                      # grey + alpha → BGRA
            return np.concatenate([x[..., :1]] * 3 + [x[..., 1:]], axis=-1)
        return np.concatenate([x[..., 2::-1], x[..., 3:]], axis=-1)
    if x.dtype == np.uint16:
        x = (x >> 8).astype(np.uint8)    # libpng's png_set_strip_16
    if mode == "gray":
        if ch <= 2:
            return x[..., 0]
        rgb = x[..., :3].astype(np.uint32)
        g = (_RC * rgb[..., 0] + _GC * rgb[..., 1] + _BC * rgb[..., 2]) >> 15
        same = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 0] == rgb[..., 2])
        return np.where(same, rgb[..., 0], g).astype(np.uint8)
    if mode == "color":
        if ch <= 2:
            return np.repeat(x[..., :1], 3, axis=-1)
        return x[..., 2::-1].copy()
    raise ValueError(f"mode must be 'unchanged', 'gray' or 'color', got {mode!r}")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(h, w) grey or (h, w, 3|4) BGR(A) uint8/uint16 → PNG bytes (the
    channel order of ``cv2.imwrite``), every row unfiltered."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG: uint8 or uint16 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if ch >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)   # → RGB(A)
    depth = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = rows.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` as a PNG file (``encode_png``)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
