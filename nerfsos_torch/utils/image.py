"""Image helpers in numpy: ``to8b``, a jet colormap, a PNG writer and a
PNG reader (8-bit gray/RGB(A), every row filter).

Port of what the eval engine uses from ``nerfsos_tpu/utils/io.py`` and
``utils/vis.py`` without imageio, matplotlib or cv2: the PNG is written with
``zlib`` and ``struct``, and the jet lookup table is built from matplotlib's
published segment data (256 entries, the same quantisation). The colorbar
strip that ``nerfsos_tpu`` appends to ``depth_*_.png`` is not drawn.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

# matplotlib's "jet" segment data: (x, y_left, y_right) per channel
_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1, 0, 0)),
}


def to8b(x: np.ndarray) -> np.ndarray:
    """Min-max normalize to uint8."""
    x = np.asarray(x)
    rng = x.max() - x.min()
    if rng == 0:
        return np.zeros_like(x, dtype=np.uint8)
    return (255 * (x - x.min()) / rng).astype(np.uint8)


def _lookup_table(data, n: int) -> np.ndarray:
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet(x: np.ndarray, n: int = 256) -> np.ndarray:
    """Colormap values in [0, 1] -> ``[..., 3]`` float64 rgb (NaN -> black)."""
    lut = np.stack([_lookup_table(_JET[c], n) for c in ("red", "green", "blue")], axis=-1)
    xa = np.array(x, dtype=np.result_type(x, np.float32), copy=True) * n
    bad = np.isnan(xa)
    out = lut[np.clip(np.where(bad, 0, xa), 0, n - 1).astype(int)]
    out[bad] = 0.0
    return out


def colorize(x: np.ndarray) -> np.ndarray:
    """Jet-colormapped 2-D array, min-max normalized (``colorize_np`` without a
    mask and without the colorbar strip)."""
    x = np.array(x, copy=True)
    vmin, vmax = x.min(), x.max() + 1e-5
    return jet((x - vmin) / (vmax - vmin))


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """8-bit PNG of a ``[H, W]``, ``[H, W, 1]``, ``[H, W, 3]`` or ``[H, W, 4]`` uint8 array."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[-1] in (3, 4):
        color_type = 2 if arr.shape[-1] == 3 else 6
    else:
        raise ValueError(f"write_png: unsupported shape {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # gray, RGB, gray + alpha, RGBA


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth) of
    ``rows [H, 1 + W * bpp]`` uint8 -> ``[H, W * bpp]`` uint8."""
    h, n = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.int32)
    for y in range(h):
        ft, x = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = x
        elif ft == 1:  # Sub: a running sum over each byte's channel, mod 256
            cur = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ft == 2:  # Up
            cur = (x + prev) & 0xFF
        elif ft in (3, 4):  # Average, Paeth: byte by byte, each reads its left neighbour
            cur, up = x.tolist(), prev.tolist()
            for i in range(n):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"PNG row filter {ft}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced gray, gray + alpha, RGB or RGBA PNG, any row
    filters -> ``[H, W]`` or ``[H, W, C]`` uint8, the array PIL gives for the
    same file (PNG is lossless). Palette, 16-bit and interlaced files raise
    ``ValueError``: those need PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color_type, _, _, interlace = ihdr
    channels = _PNG_CHANNELS.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are read "
                         f"without PIL (IHDR {ihdr})")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    img = _unfilter(rows, channels).reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
