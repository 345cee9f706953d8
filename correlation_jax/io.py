"""Image loading with background prefetch.

Replaces the reference's cv::imread ingestion (cuda_class.cu:475-519,
manager_class.cpp:167-243) and its async next-image prefetch
(manager_class.cpp:1438-1447, the std::async set_next_image overlap) with a
thread-pool prefetcher that decodes and stages frames ahead of the solve.

8-bit PNG and uint8 .npy frames decode with the standard library and
NumPy alone; other formats go through Pillow when it is installed.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# 8-bit PNG color types decoded here (grey, RGB) -> channels.
_PNG_CHANNELS = {0: 1, 2: 3}


def _gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma in Pillow's integer form (its convert("L"))."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8
    )


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None/Sub/Up/Average/Paeth)."""
    rows = raw.reshape(h, stride + 1)
    ftype = rows[:, 0]
    data = rows[:, 1:].astype(np.uint8)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line = data[y]
        f = ftype[y]
        if f == 0:
            cur = line
        elif f == 1:  # Sub: running sum per channel, mod 256
            cur = (
                np.cumsum(line.reshape(-1, bpp).astype(np.uint32), axis=0)
                .astype(np.uint8)
                .reshape(-1)
            )
        elif f == 2:  # Up
            cur = line + prev
        elif f in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.empty(stride, np.uint8)
            up = prev.astype(np.int32)
            lin = line.astype(np.int32)
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c
                    )
                cur[x] = (lin[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = cur
        prev = cur
    return out


def _decode_png(data: bytes) -> np.ndarray | None:
    """[H, W, C] uint8 from an 8-bit non-interlaced grey or RGB PNG, or
    None for any other PNG flavour."""
    pos = len(_PNG_SIG)
    idat = []
    hdr = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        return None
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def save_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W], [H, W, 1] or [H, W, 3] image as a PNG
    (unfiltered rows, zlib-compressed)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"save_png needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"save_png needs grey or RGB, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(
            ">I", crc
        )

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _decode_pillow(path: str, monochrome: bool) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        ext = os.path.splitext(path)[1] or "(no extension)"
        raise ValueError(
            f"{path}: format {ext} needs Pillow, which is not installed; "
            "8-bit PNG and uint8 .npy frames load without it"
        ) from None
    with Image.open(path) as im:
        arr = np.asarray(im.convert("L" if monochrome else "RGB"))
    return arr[..., None] if arr.ndim == 2 else arr


def load_image(path: str, monochrome: bool = True) -> np.ndarray:
    """Decode an image file to [H, W, C] float32 with uint8 values.

    monochrome=True converts to single-channel luma (the reference's
    cv::IMREAD_GRAYSCALE default, manager_class.cpp:100-104).
    """
    img = None
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim not in (2, 3):
            raise ValueError(
                f"{path}: .npy frames must be uint8 [H, W] or [H, W, C], "
                f"got {img.dtype} {img.shape}"
            )
        if img.ndim == 2:
            img = img[..., None]
    else:
        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(_PNG_SIG):
            img = _decode_png(data)
        if img is None:
            img = _decode_pillow(path, monochrome)
    if monochrome and img.shape[-1] == 3:
        img = _gray(img)[..., None]
    elif monochrome:
        img = img[..., :1]
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(np.float32)


class FramePrefetcher:
    """Decode frames ahead of the solver (the std::async analog).

    Keeps up to `ahead` decoded frames in flight and evicts frames that
    fall behind the newest request, so a length-N sequence holds O(ahead)
    decoded frames — not O(N) — mirroring the reference's three-image
    recycling (pyramid_class.cpp:211-258).  Evicted frames are re-decoded
    transparently if requested again (e.g. for overlay rendering).
    """

    def __init__(self, paths: list[str], monochrome: bool = True,
                 ahead: int = 2, behind: int = 1):
        self.paths = paths
        self.monochrome = monochrome
        self.ahead = ahead
        self.behind = behind
        self.max_cached = 0  # high-water mark, asserted bounded by tests
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._futures: dict[int, Future] = {}
        for i in range(min(ahead, len(paths))):
            self._submit(i)

    def _submit(self, idx: int):
        if 0 <= idx < len(self.paths) and idx not in self._futures:
            self._futures[idx] = self._pool.submit(
                load_image, self.paths[idx], self.monochrome
            )

    def get(self, idx: int) -> np.ndarray:
        self._submit(idx)
        for j in range(idx + 1, min(idx + 1 + self.ahead, len(self.paths))):
            self._submit(j)
        out = self._futures[idx].result()
        # Evict decoded frames behind the window (the run_sequence driver
        # caches the und/def pyramids it still needs on device).
        for k in [k for k in self._futures if k < idx - self.behind]:
            f = self._futures.pop(k)
            f.cancel()
        self.max_cached = max(self.max_cached, len(self._futures))
        return out

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
