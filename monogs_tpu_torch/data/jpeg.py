"""JPEG decode and encode: nvJPEG on the card, OpenCV on the CPU.

On the card a frame is decoded by nvJPEG (``csrc/nvjpeg_codec.cpp``, a
``ctypes`` library linked with the CUDA toolkit's ``libnvjpeg``) into
uint8 device planes at the stream's own subsampling (Huffman on the host,
the inverse DCT on the card); the kernel ``csrc/ycc_rgb.cu``
(``ycc_to_rgb``, four pixels a thread) then upsamples the chroma and
converts to RGB as libjpeg does, beside its plain version
``ycc_to_rgb_plain``. nvJPEG's own
upsampling and conversion differ from libjpeg's by up to 12 LSB on the
mean on sharp 4:2:0 chroma; with libjpeg's, the two decoders differ only
by their inverse DCTs. On the CPU a frame is decoded by ``cv2``, the JAX
package's decoder, imported only there (the card's path imports neither
OpenCV nor Pillow); without cv2 the CPU path raises. Only 4:4:4, 4:2:2,
4:2:0 and grey streams are decoded on the card. ``encode_jpeg`` is
nvJPEG's encoder, for the fixtures written on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, resolve_device
from ..render.blend_lists import count_launch

QUALITY = 95      # the encoder's quality, as the fixtures are written

LAUNCHES = {"ycc_rgb": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# libjpeg's YCbCr -> RGB in 16-bit fixed point (jdcolor.c): FIX(x) is
# round(x * 2^16); the red and blue terms are rounded into the tables, the
# green sum is rounded through ONE_HALF in the Cb term.
_SCALE, _HALF = 16, 1 << 15
_CR_R, _CB_B, _CR_G, _CB_G = 91881, 116130, 46802, 22554


def _upsample_plain(c, height, width, sx, sy):
    """A chroma plane [ch, cw] upsampled to [height, width] as libjpeg's
    decoder does (jdsample.c, fancy upsampling): the triangle filter, 3/4
    of the nearer sample and 1/4 of the further one in each doubled
    direction, edge samples repeated, with libjpeg's alternating rounding
    biases; a plane doubled across from at most 2 samples is replicated."""
    c = c.to(torch.int32)
    ch, cw = c.shape
    dev = c.device
    ys, xs = torch.arange(height, device=dev), torch.arange(width, device=dev)
    if sx == 1:                                 # 4:4:4
        return c
    if cw <= 2:                                 # box
        return c[ys // sy][:, xs // 2]
    col = c
    if sy == 2:
        r = ys // 2
        far = (r + torch.where(ys % 2 == 1, 1, -1)).clamp(0, ch - 1)
        col = 3 * c[r] + c[far]                 # [height, cw]
    k = xs // 2
    odd = xs % 2 == 1
    far = torch.where(odd, k + 1, k - 1).clamp(0, cw - 1)
    if sy == 2:                                 # 4:2:0
        return (3 * col[:, k] + col[:, far] + torch.where(odd, 7, 8)) >> 4
    return (3 * col[:, k] + col[:, far] + torch.where(odd, 2, 1)) >> 2


def _factors(chroma_shape, height, width):
    """(v, h) subsampling factors of a chroma plane; raises on a form
    other than 4:4:4, 4:2:2 and 4:2:0."""
    ch, cw = chroma_shape
    sy, sx = (1 if n == full else 2 for n, full in ((ch, height),
                                                    (cw, width)))
    if (ch, cw) != (-(-height // sy), -(-width // sx)) or (sx, sy) == (1, 2):
        raise ValueError(f"JPEG chroma {cw}x{ch} of a {width}x{height} "
                         "image: only 4:4:4, 4:2:2 and 4:2:0 are decoded")
    return sy, sx


def ycc_to_rgb_plain(y, cb=None, cr=None):
    """[H, W, 3] uint8 RGB from the decoded planes of a JPEG, as libjpeg
    makes it: luma ``y`` [H, W] and chroma ``cb``, ``cr`` [ch, cw] at the
    stream's subsampling (4:4:4, 4:2:2 or 4:2:0, read from the shapes),
    upsampled by ``_upsample_plain`` and converted in libjpeg's fixed
    point; without chroma, grey repeated."""
    height, width = y.shape
    yi = y.to(torch.int32)
    if cb is None:
        return y[..., None].expand(height, width, 3).contiguous()
    sy, sx = _factors(cb.shape, height, width)
    up = [_upsample_plain(p, height, width, sx, sy) - 128 for p in (cb, cr)]
    r = yi + ((_CR_R * up[1] + _HALF) >> _SCALE)
    g = yi + ((-_CB_G * up[0] + _HALF - _CR_G * up[1]) >> _SCALE)
    b = yi + ((_CB_B * up[0] + _HALF) >> _SCALE)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def ycc_to_rgb(y, cb=None, cr=None):
    """``ycc_to_rgb_plain``'s result: the kernel on CUDA tensors, else the
    plain version."""
    if not y.is_cuda:
        return ycc_to_rgb_plain(y, cb, cr)
    if y.dtype != torch.uint8 or y.dim() != 2:
        raise ValueError(f"ycc_to_rgb: luma must be [H, W] uint8, got "
                         f"{y.dtype} {tuple(y.shape)}")
    height, width = y.shape
    dev = y.get_device()
    sy, sx, ch, cw = 1, 1, 0, 0
    if cb is not None:
        if (cb.dtype != torch.uint8 or cr.dtype != torch.uint8
                or cb.dim() != 2 or cr.shape != cb.shape
                or cb.get_device() != dev or cr.get_device() != dev):
            raise ValueError("ycc_to_rgb: chroma must be two [ch, cw] uint8 "
                             "planes on the luma's device")
        ch, cw = cb.shape
        sy, sx = _factors(cb.shape, height, width)
        cb, cr = cb.contiguous(), cr.contiguous()
    y = y.contiguous()
    out = y.new_empty((height, width, 3))
    rc = _build.library("ycc_rgb").ycc_rgb_u8(
        y.data_ptr(), None if cb is None else cb.data_ptr(),
        None if cr is None else cr.data_ptr(), out.data_ptr(), height, width,
        ch, cw, sx, sy, _build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"ycc_rgb_u8: kernel launch failed with CUDA "
                           f"error {rc}")
    count_launch(LAUNCHES, "ycc_rgb")
    return out


def _lib():
    return _build.library("nvjpeg_codec")


def _raise_on(rc: int, fn: str):
    if rc != 0:
        raise RuntimeError(f"{fn} failed with code {rc} (1000 + a CUDA error, "
                           "2000 + an nvJPEG status)")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def decode_jpeg(data: bytes, device="cuda") -> torch.Tensor:
    """[H, W, 3] uint8 RGB on ``device``: nvJPEG on a CUDA device (the
    default), cv2 on the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("decoding JPEG on the CPU needs cv2 (OpenCV); "
                               "on the card nvJPEG decodes it") from e
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("cv2 could not decode the JPEG stream")
        return torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1]))
    return ycc_to_rgb(*decode_planes(data, device))


def decode_planes(data: bytes, device):
    """nvJPEG's decoded planes of a stream on a CUDA ``device``: luma
    [H, W] and, for colour, chroma [ch, cw] twice at the stream's
    subsampling (``None`` twice for grey)."""
    lib = _lib()
    ws, hs = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    n = ctypes.c_int()
    _raise_on(lib.jpeg_info(data, len(data), ws, hs, ctypes.byref(n)),
              "jpeg_info")
    if n.value not in (1, 3):
        raise ValueError(f"JPEG with {n.value} components: only grey and "
                         "YCbCr streams are decoded")
    planes = [torch.empty((hs[i], ws[i]), dtype=torch.uint8, device=device)
              for i in range(n.value)]
    if n.value == 3:
        _factors(planes[1].shape, hs[0], ws[0])
    ptrs = [p.data_ptr() for p in planes] + [None] * (3 - n.value)
    _raise_on(lib.jpeg_decode(data, len(data), *ptrs, ws, _stream(device)),
              "jpeg_decode")
    return planes + [None] * (3 - n.value)


def read_jpeg(path, device="cuda") -> torch.Tensor:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), device)


def encode_jpeg(rgb: torch.Tensor) -> bytes:
    """Baseline JPEG (4:2:0, ``QUALITY``) bytes of [H, W, 3] uint8 RGB on
    the card, by nvJPEG."""
    if (rgb.device.type != "cuda" or rgb.dtype != torch.uint8
            or rgb.dim() != 3 or rgb.shape[2] != 3):
        raise ValueError("encode_jpeg takes [H, W, 3] uint8 on a CUDA device")
    rgb = rgb.contiguous()
    h, w = rgb.shape[:2]
    n = ctypes.c_size_t(0)
    # a 4:2:0 stream at any quality stays under the raw size plus headers
    buf = ctypes.create_string_buffer(h * w * 3 + 4096)
    rc = _lib().jpeg_encode(rgb.data_ptr(), w, h, QUALITY, buf, len(buf),
                            ctypes.byref(n), _stream(rgb.device))
    _raise_on(rc, "jpeg_encode")
    return buf.raw[:n.value]


def write_jpeg(path, rgb: torch.Tensor):
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb))
