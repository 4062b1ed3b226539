"""Image reading and resizing for dataset preparation (numpy; PIL where
importable).

Port of ``nerfsos_tpu/data/image_io.py``: ``imread`` decodes with PIL when
it imports, as the JAX package does, and otherwise reads PNGs with the
port's numpy decoder (``utils/image.read_png``: 8-bit gray/RGB(A), every
row filter; PNG is lossless, so both give the same array). JPEG and the
other formats, and ``minify`` (PIL's LANCZOS filter), need PIL and raise a
plain error naming the file when it is absent. ``resize_area`` is
``cv2.INTER_AREA`` in numpy: the mean of each pixel's source area.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from nerfsos_torch.utils.image import read_png

IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _pil(path: str, what: str):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: {what} needs PIL (Pillow), which is not importable") from None
    return Image


def imread(path: str) -> np.ndarray:
    """uint8 (uint16 for 16-bit files, through PIL) array of an image file."""
    try:
        from PIL import Image
    except ImportError:
        if not path.lower().endswith(".png"):
            raise RuntimeError(f"{path}: decoding this image needs PIL (Pillow), which is not "
                               "importable; only PNGs are read without it") from None
        return read_png(path)
    with Image.open(path) as im:
        return np.asarray(im)


def list_images(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if any(f.endswith(ext) for ext in IMG_EXTS)]


def minify(basedir: str, factors: Sequence[int] = (),
           resolutions: Sequence[Sequence[int]] = ()) -> None:
    """Write ``images_{f}`` / ``images_{w}x{h}`` copies of ``images/`` as PNG,
    resized with PIL's LANCZOS filter; directories that exist are kept (the
    reference's ``data/load_llff.py:8-57`` contract)."""
    todo = []
    for r in factors:
        if not os.path.exists(os.path.join(basedir, f"images_{r}")):
            todo.append(("factor", r))
    for r in resolutions:
        if not os.path.exists(os.path.join(basedir, f"images_{r[1]}x{r[0]}")):
            todo.append(("res", r))
    if not todo:
        return
    Image = _pil(os.path.join(basedir, "images"), "minifying")
    src = list_images(os.path.join(basedir, "images"))
    for kind, r in todo:
        sub = f"images_{r}" if kind == "factor" else f"images_{r[1]}x{r[0]}"
        outdir = os.path.join(basedir, sub)
        os.makedirs(outdir, exist_ok=True)
        print(f"Minifying {r} -> {outdir}")
        for f in src:
            with Image.open(f) as im:
                if kind == "factor":
                    size = (round(im.width / r), round(im.height / r))
                else:
                    size = (int(r[1]), int(r[0]))
                im = im.resize(size, Image.LANCZOS)
                name = os.path.splitext(os.path.basename(f))[0] + ".png"
                im.save(os.path.join(outdir, name))


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]``: the share of each source pixel in each output
    pixel's span ``[o s, (o + 1) s)``, ``s = n_in / n_out``, over ``s``."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    src = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(lo + s, src + 1) - np.maximum(lo, src), 0.0, None)
    return overlap / s


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Area-averaging downscale of ``img [H, W(, C)]`` (``cv2.INTER_AREA``):
    at integer factors each output pixel is the mean of its block, else each
    source pixel counts by the share of it that the output pixel covers.
    Keeps the input's float dtype."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    if height > H or width > W:
        raise ValueError(f"resize_area downscales only: {H}x{W} -> {height}x{width}")
    if H % height == 0 and W % width == 0:
        fh, fw = H // height, W // width
        return img.reshape(height, fh, width, fw, *img.shape[2:]).mean(axis=(1, 3),
                                                                       dtype=np.float64
                                                                       ).astype(img.dtype)
    wy, wx = _area_weights(H, height), _area_weights(W, width)
    out = np.einsum("oh,hw...->ow...", wy, img.astype(np.float64))
    return np.einsum("pw,ow...->op...", wx, out).astype(img.dtype)
