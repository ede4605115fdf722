"""Prefetching frame decoder (counterpart of
``monogs_tpu/data/native_loader.py``).

A pool of ``n_threads`` threads decodes frames ``i + 1 .. i + window``
while the caller works on frame ``i``, as the JAX package's
``native/frame_loader.cpp`` does. The port's decoders do their work
outside the interpreter lock (``zlib``, the PNG unfilter and nvJPEG
through ``ctypes``), so the threads overlap. Colour is decoded to [H, W, 3]
uint8 RGB (a grey PNG to [H, W]) and depth to [H, W] int32 holding the
16-bit PNG values, each on ``device``: on the card (the default; without
CUDA that raises unless the caller passes ``device="cpu"``) JPEG goes
straight to device memory through nvJPEG and PNG is unfiltered by the
host routine; on the CPU JPEG goes through cv2 and PNG through the numpy
unfilter. The loader always exists: there is no ``None`` "when
unbuilt".
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
from .jpeg import read_jpeg
from .png import read_png


def decode_image(path: str, device) -> torch.Tensor:
    """An image file as a uint8 tensor (RGB [H, W, 3] or grey [H, W]) on
    ``device``, or int32 [H, W] for a 16-bit PNG."""
    device = torch.device(device)
    if path.lower().endswith((".jpg", ".jpeg")):
        return read_jpeg(path, device)
    img = read_png(path, native=device.type == "cuda")
    if img.dtype == np.uint16:
        img = img.astype(np.int32)
    return torch.from_numpy(img).to(device)


class PrefetchLoader:
    """Frames ``(color, depth or None)`` decoded ahead of the caller."""

    def __init__(self, color_paths, depth_paths=None, n_threads=4, window=8,
                 device="cuda"):
        self.color_paths = list(color_paths)
        self.depth_paths = None if depth_paths is None else list(depth_paths)
        self.window = window
        self.device = resolve_device(device)
        self._pool = ThreadPoolExecutor(max_workers=n_threads,
                                        thread_name_prefix="frame-loader")
        self._futures = {}
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.color_paths)

    def _decode(self, idx):
        color = decode_image(self.color_paths[idx], self.device)
        depth = None
        if self.depth_paths is not None and self.depth_paths[idx]:
            depth = decode_image(self.depth_paths[idx], self.device)
        return color, depth

    def get(self, idx):
        """Frame ``idx``, waiting for its decode; queues the next
        ``window`` frames and forgets the ones before ``idx``."""
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        with self._lock:
            for i in range(idx, min(idx + self.window + 1, len(self))):
                if i not in self._futures:
                    self._futures[i] = self._pool.submit(self._decode, i)
            fut = self._futures.pop(idx)
            for i in [i for i in self._futures if i < idx]:
                self._futures.pop(i).cancel()
        return fut.result()

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


def make_loader(color_paths, depth_paths=None, n_threads=4, window=8,
                device="cuda"):
    """The prefetching loader over (color_paths, optional depth_paths), on
    the card unless ``device`` says otherwise."""
    return PrefetchLoader(color_paths, depth_paths, n_threads, window, device)
