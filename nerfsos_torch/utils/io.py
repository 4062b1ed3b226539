"""Writers of the density export (MRC volumes, binary PLY point clouds) and
of the exhibit videos (mp4).

Port of ``write_mrc``, ``read_mrc``, ``write_ply_points``,
``write_voxel_ply`` and ``write_video`` of ``nerfsos_tpu/utils/io.py``. The
first four are numpy only, byte for byte: the reference writes these files
with ``mrc`` and ``open3d``, and the MRC2014 header and the binary PLY are
written directly instead. ``write_video`` encodes through cv2's mp4v writer,
else imageio, as the JAX package does, and raises a plain error when
neither is importable; both are imported only there.
"""
from __future__ import annotations

import importlib.util
import struct
from typing import Optional

import numpy as np


def write_mrc(path: str, volume: np.ndarray, voxel_size: float = 1.0) -> None:
    """Minimal MRC2014 (mode 2, float32) volume writer; readable by
    Chimera(X) and EMAN2. The volume's axes are (z, y, x)."""
    vol = np.ascontiguousarray(volume, np.float32)
    nz, ny, nx = vol.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)       # NX NY NZ
    struct.pack_into("<i", header, 12, 2)                # MODE 2 = float32
    struct.pack_into("<3i", header, 16, 0, 0, 0)         # NXSTART...
    struct.pack_into("<3i", header, 28, nx, ny, nz)      # MX MY MZ
    struct.pack_into("<3f", header, 40, nx * voxel_size, ny * voxel_size, nz * voxel_size)
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)
    struct.pack_into("<3i", header, 64, 1, 2, 3)         # MAPC MAPR MAPS
    struct.pack_into("<3f", header, 76, float(vol.min()), float(vol.max()), float(vol.mean()))
    struct.pack_into("<i", header, 88, 1)                # ISPG
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"                # little-endian machine stamp
    struct.pack_into("<f", header, 216, float(vol.std()))
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vol.tobytes())


def read_mrc(path: str) -> np.ndarray:
    """A float32 MRC volume as written by :func:`write_mrc`, axes (z, y, x)."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nx, ny, nz = struct.unpack_from("<3i", header, 0)
        (mode,) = struct.unpack_from("<i", header, 12)
        if mode != 2:
            raise ValueError(f"{path}: MRC mode {mode}, only 2 (float32) is read")
        data = np.frombuffer(f.read(nx * ny * nz * 4), np.float32)
    return data.reshape(nz, ny, nx)


def write_ply_points(path: str, points: np.ndarray,
                     colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY point cloud (``colors``: uint8 RGB a point)."""
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    props = "property float x\nproperty float y\nproperty float z\n"
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8)
        props += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n{props}end_header\n"
    ).encode()
    with open(path, "wb") as f:
        f.write(header)
        if colors is None:
            f.write(points.tobytes())
        else:
            dt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec = np.empty(n, dt)
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())


def write_voxel_ply(path: str, occupancy: np.ndarray, thres: float = 1e-6) -> None:
    """The centers of the voxels above ``thres``, in units of the grid's
    extent, as a PLY point cloud (the reference's open3d voxel export)."""
    xyz = np.stack((occupancy > thres).nonzero(), -1).astype(np.float32)
    xyz = xyz / np.array(occupancy.shape)
    write_ply_points(path, xyz)


def video_writer() -> str:
    """The mp4 route :func:`write_video` takes here: ``"cv2"``, ``"imageio"``
    or ``"none"`` (neither importable: it raises)."""
    for name in ("cv2", "imageio"):
        try:
            if importlib.util.find_spec(name) is not None:
                return name
        except ValueError:  # a module set to None in sys.modules
            continue
    return "none"


def write_video(path: str, frames: np.ndarray, fps: int = 30, quality: int = 8) -> None:
    """An mp4 of ``frames [T, H, W, 3]`` (or ``[T, H, W]``, ``[T, H, W, 1]``)
    uint8: cv2's mp4v writer, else (cv2 missing or its writer not opening)
    imageio's; ``RuntimeError`` naming both when neither is importable."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = np.repeat(frames[..., None], 3, axis=-1)
    if frames.ndim == 4 and frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in frames:
                vw.write(cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_RGB2BGR))
            vw.release()
            return
    try:
        import imageio
    except ImportError:
        raise RuntimeError(f"{path}: writing an mp4 needs cv2 (its mp4v writer) or imageio, "
                           "and neither is importable") from None
    imageio.mimwrite(path, frames, fps=fps, quality=quality)
