"""Writers of the density export: MRC volumes and binary PLY point clouds.

Port of ``write_mrc``, ``read_mrc``, ``write_ply_points`` and
``write_voxel_ply`` of ``nerfsos_tpu/utils/io.py`` (numpy only), byte for
byte: the reference writes these files with ``mrc`` and ``open3d``, and the
MRC2014 header and the binary PLY are written directly instead.
"""
from __future__ import annotations

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
