"""PNG decode and encode without OpenCV or Pillow.

Reads the forms the datasets store: 8-bit RGB (TUM colour), 8-bit grey
(EuRoC), 16-bit grey (TUM and Replica depth) and 8-bit RGBA (the alpha
dropped, as ``cv2.imread`` drops it). The chunks are parsed here, the
image data inflated with the standard library's ``zlib`` and the five row
filters reversed either by the host routine ``csrc/png_unfilter.cpp``
(through ``ctypes``, which releases the interpreter lock) or by its plain
numpy version ``unfilter_plain``, which the CPU path runs. Interlaced and
palette images raise, naming the form (the JAX package reads them through
cv2; none of the datasets uses them). ``encode_png`` writes filter 0 rows
for the fixtures made on the card.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..render.blend_lists import count_launch

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# calls of the host routine, counted as the kernels' launches are
LAUNCHES = {"png_unfilter": 0}

# (bit depth, colour type) -> (channels stored, channels kept)
_FORMS = {(8, 2): (3, 3), (8, 0): (1, 1), (16, 0): (1, 1), (8, 6): (4, 3)}
_COLOUR = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


class PNGError(ValueError):
    pass


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise PNGError("truncated PNG: no IEND chunk")


def parse(data: bytes):
    """(width, height, bit depth, colour type, inflated filtered rows)."""
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise PNGError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise PNGError("interlaced (Adam7) PNG is not supported")
    if (depth, ctype) not in _FORMS:
        raise PNGError(f"{depth}-bit {_COLOUR.get(ctype, ctype)} PNG is not "
                       "supported (8-bit RGB, RGBA or grey, 16-bit grey)")
    return w, h, depth, ctype, zlib.decompress(b"".join(idat))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw: bytes, height: int, row_bytes: int, bpp: int):
    """Reverse the row filters: [height, row_bytes] uint8. Pixel (y, x)
    depends on (y, x - 1), (y - 1, x) and (y - 1, x - 1), so every pixel on
    one anti-diagonal is reconstructed at once."""
    if len(raw) != height * (row_bytes + 1):
        raise PNGError(f"PNG data holds {len(raw)} bytes, expected "
                       f"{height * (row_bytes + 1)}")
    f = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    ftype = f[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise PNGError(f"unknown PNG filter type {int(ftype.max())}")
    w = row_bytes // bpp
    src = f[:, 1:].reshape(height, w, bpp).astype(np.int32)
    out = np.zeros((height + 1, w + 1, bpp), np.int32)   # zero row/column
    for t in range(height + w - 1):
        y = np.arange(max(0, t - w + 1), min(height, t + 1))
        x = t - y
        a = out[y + 1, x]          # left (column 0 of out is the zeros)
        b = out[y, x + 1]          # above (row 0 of out is the zeros)
        c = out[y, x]
        ft = ftype[y][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(height, row_bytes)


def _unfilter_lib():
    from .._build import library

    return library("png_unfilter")


def unfilter_native(raw: bytes, height: int, row_bytes: int, bpp: int):
    """``unfilter_plain`` by the host routine (``csrc/png_unfilter.cpp``)."""
    if len(raw) != height * (row_bytes + 1):
        raise PNGError(f"PNG data holds {len(raw)} bytes, expected "
                       f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    rc = _unfilter_lib().png_unfilter(
        raw, out.ctypes.data_as(ctypes.c_void_p), height, row_bytes, bpp)
    if rc:
        raise PNGError(f"unknown PNG filter type in row {rc - 1}")
    count_launch(LAUNCHES, "png_unfilter")
    return out


def decode_png(data: bytes, native: bool = False) -> np.ndarray:
    """[H, W, 3] uint8 RGB, [H, W] uint8 or [H, W] uint16 (host order);
    ``native`` unfilters with the host routine, else with numpy."""
    w, h, depth, ctype, raw = parse(data)
    chans, keep = _FORMS[(depth, ctype)]
    bpp = chans * depth // 8
    rows = (unfilter_native if native else unfilter_plain)(
        raw, h, w * bpp, bpp)
    if depth == 16:                     # PNG stores samples big-endian
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    img = rows.reshape(h, w, chans)
    return img[..., 0] if chans == 1 else np.ascontiguousarray(img[..., :keep])


def read_png(path, native: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), native=native)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of [H, W] uint8 or uint16 grey or [H, W, 3] uint8 RGB,
    every row with filter 0."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        depth, ctype = 8, 2
    elif img.ndim == 2 and img.dtype == np.uint8:
        depth, ctype = 8, 0
    elif img.ndim == 2 and img.dtype == np.uint16:
        depth, ctype = 16, 0
        img = img.astype(">u2")
    else:
        raise PNGError(f"encode_png takes uint8 grey or RGB or uint16 grey, "
                       f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(img))
