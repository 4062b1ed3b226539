"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one shared library.

On first use one ``nvcc`` per source in ``csrc/`` compiles it to an object
file, all of them at once, and a last ``nvcc`` links the objects into one
library under ``build/kernels/`` at the repository root (listed in
``.gitignore``). The two largest sources are compiled in parts (``PARTS``:
one ``nvcc`` a part, ``-DNERF_PART=p``, each part holding some of the
file's kernel instantiations), so that the build's longest compile is a
part's, not the file's. The library name carries a hash of the sources and headers,
so an edited source is rebuilt and a stale library is never loaded. The library
has a plain C interface and is bound with ``ctypes``: pointers and the stream
go as ``c_void_p``, and every launch function returns its ``cudaError_t``,
which :func:`check` turns into an exception. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# translation-unit parts of a source (its NERF_PART guards); one unit when
# SPLIT is off (tools/tile_probe's clock variants, whose counters are one
# unit's)
PARTS = {"train_render.cu": 7, "fused_field.cu": 6}
SPLIT = True


def sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _hashed_files() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _hashed_files():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(PARTS.items()) if SPLIT else None).encode())
    return os.path.join(BUILD_DIR, f"libnerfsos_kernels_{h.hexdigest()[:16]}.so")


def units() -> List[tuple]:
    """``(name, source, nvcc -D flags)`` of each translation unit: a source,
    or each part of a source in ``PARTS``."""
    out = []
    for src in sources():
        base = os.path.basename(src)
        n = PARTS.get(base, 1) if SPLIT else 1
        out += [(base if n == 1 else f"{base}:{p}", src, [] if n == 1 else [f"-DNERF_PART={p}"])
                for p in range(n)]
    return out


def build() -> str:
    """Compile the sources unless the library for them exists; returns its path.

    The compilers' resource reports (``-Xptxas -v``: registers, shared memory,
    spills per kernel) are kept beside the library as ``<lib>.log``, after
    a line of each unit's and the link's seconds.
    """
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, runs = [], []

    def run(name, cmd):  # one compiler, its seconds and its report
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        runs.append((name, cmd, proc.returncode, proc.stderr, time.perf_counter() - start))

    threads = []
    for i, (name, src, defs) in enumerate(units()):
        obj = f"{tmp}.{i}.{os.path.basename(src)}.o"
        objs.append(obj)
        threads.append(threading.Thread(target=run, args=(
            name, [nvcc, *NVCC_FLAGS, *defs, "-c", "-o", obj, src])))
        threads[-1].start()
    for t in threads:  # wait for every compiler before raising
        t.join()
    runs.sort(key=lambda r: [u[0] for u in units()].index(r[0]))
    for _, cmd, code, err, _ in runs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{err}")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    start = time.perf_counter()
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    seconds = {name: secs for name, _, _, _, secs in runs}
    seconds["link"] = time.perf_counter() - start
    with open(path + ".log", "w") as f:
        f.write(f"{time.perf_counter() - t0:.1f} s\n")
        f.write("seconds " + " ".join(f"{k}={v:.1f}" for k, v in seconds.items()) + "\n")
        for _, cmd, _, err, _ in runs:
            f.write(f"{' '.join(cmd)}\n{err}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, path)
    return path


class MLPLayer(ctypes.Structure):
    """One dense layer inside the packed parameter buffer (offsets in floats)."""
    _fields_ = [("w", ctypes.c_longlong), ("b", ctypes.c_longlong),
                ("k", ctypes.c_int), ("n", ctypes.c_int)]


MAX_LAYERS = 16


class MLPDesc(ctypes.Structure):
    """Mirror of ``MLPDesc`` in ``csrc/tile_mlp.cuh`` (``bf16``: the bf16 mode
    that every kernel runs at ``--compute_dtype bfloat16``; each entry point
    takes its bf16 instantiation when it is set)."""
    _fields_ = [("layer", MLPLayer * MAX_LAYERS),
                ("depth", ctypes.c_int), ("skip", ctypes.c_int),
                ("hrows", ctypes.c_int), ("emb_dim", ctypes.c_int),
                ("demb_dim", ctypes.c_int), ("sem_dim", ctypes.c_int),
                ("sem_with_coord", ctypes.c_int), ("bf16", ctypes.c_int)]


MAX_PLANES = 10 + MAX_LAYERS


class TrainDesc(ctypes.Structure):
    """Mirror of ``TrainDesc`` in ``csrc/train_sweep.cuh`` (``f.bf16`` picks
    the bf16 mode of the storing forwards and the reverse sweep (K3, K6,
    K10b, K8c/K8f), whose rings are then ``pack_ring``'s and
    ``pack_bwd_ring``'s bf16 layouts)."""
    _fields_ = [("f", MLPDesc), ("bwd", MLPLayer * MAX_LAYERS),
                ("gw", ctypes.c_longlong * MAX_LAYERS), ("gb", ctypes.c_longlong * MAX_LAYERS),
                ("grad_size", ctypes.c_longlong),
                ("plane", ctypes.c_longlong * MAX_PLANES), ("rows", ctypes.c_int * MAX_PLANES),
                ("ws_size", ctypes.c_longlong), ("rays_per_chunk", ctypes.c_int),
                ("ibwd", MLPLayer * MAX_LAYERS)]


MAX_RING_STAGES = 4


class RingDesc(ctypes.Structure):
    """Mirror of ``RingDesc`` in ``csrc/wgmma.cuh``."""
    _fields_ = [("off", ctypes.c_longlong * MAX_LAYERS), ("ncols", ctypes.c_int * MAX_LAYERS),
                ("hrows", ctypes.c_int), ("stages", ctypes.c_int),
                ("stage_floats", ctypes.c_int)]


class FrozenDesc(ctypes.Structure):
    """Mirror of ``FrozenDesc`` in ``csrc/train_render.cu`` (``bf16``: K5's bf16
    mode, ``frozen_sem_kernel<true>``)."""
    _fields_ = [("b0", ctypes.c_longlong), ("w1", ctypes.c_longlong),
                ("gw0", ctypes.c_longlong), ("gb0", ctypes.c_longlong),
                ("gw1", ctypes.c_longlong), ("gb1", ctypes.c_longlong),
                ("grad_size", ctypes.c_longlong), ("C", ctypes.c_int),
                ("kslices", ctypes.c_int), ("hidden", ctypes.c_int), ("sem_dim", ctypes.c_int),
                ("n_maps", ctypes.c_int), ("xstages", ctypes.c_int), ("wstages", ctypes.c_int),
                ("bf16", ctypes.c_int)]


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    train_p = ctypes.POINTER(TrainDesc)
    ring_p = ctypes.POINTER(RingDesc)
    lib.nerf_coarse_weights.argtypes = [vp, vp, vp, vp, train_p, ring_p, vp, i32, i32, vp]
    lib.nerf_rgb_train_grads.argtypes = [vp, vp, vp, vp, vp, vp, train_p, ring_p, ring_p, vp, vp,
                                         vp, vp, vp, i32, i32, i32, i32, ctypes.c_uint, f32, i32,
                                         vp]
    lib.nerf_train_render.argtypes = [vp, vp, vp, vp, train_p, ring_p, vp, vp, vp, i32, i32,
                                      ctypes.c_uint, f32, vp]
    lib.nerf_train_render_grads.argtypes = [vp, vp, vp, vp, vp, vp, vp, train_p, ring_p, ring_p,
                                            vp, vp, vp, i32, i32, i32, i32, ctypes.c_uint, f32, vp]
    lib.nerf_frozen_sem_grads.argtypes = [vp, vp, vp, vp, ctypes.POINTER(FrozenDesc), vp, vp,
                                          ctypes.c_longlong, i32, i32, ctypes.c_longlong, vp]
    lib.nerf_frozen_sem_clusters.argtypes = [ctypes.POINTER(FrozenDesc),
                                             ctypes.POINTER(ctypes.c_int)]
    lib.nerf_mip_render.argtypes = [vp, vp, vp, vp, train_p, ring_p, vp, vp, i32, i32,
                                    ctypes.c_uint, f32, vp]
    lib.nerf_mip_train_render_grads.argtypes = [vp, vp, vp, vp, vp, vp, vp, train_p, ring_p,
                                                ring_p, vp, vp, vp, i32, i32, i32, i32,
                                                ctypes.c_uint, f32, vp]
    i64 = ctypes.c_longlong
    lib.nerf_field_sigma.argtypes = [vp, vp, vp, train_p, ring_p, vp, i64, i32, vp]
    lib.nerf_field.argtypes = [vp, vp, vp, vp, train_p, ring_p, vp, i64, i32, i32, vp]
    lib.nerf_mip_field.argtypes = [vp, vp, vp, vp, vp, train_p, ring_p, vp, i64, i32, vp]
    lib.nerf_field_grads.argtypes = [vp] * 7 + [train_p, ring_p, ring_p, ring_p] + [vp] * 5 + [
        i32, i32, i32, vp]
    lib.geo_row_stats.argtypes = [vp] * 5 + [ctypes.c_longlong] + [i32] * 3 + [f32, vp]
    lib.geo_means.argtypes = [vp] * 10 + [ctypes.c_longlong] + [i32] * 5 + [f32, f32, f32, vp]
    lib.geo_grads.argtypes = [vp] * 14 + [ctypes.c_longlong] + [i32] * 5 + [f32, f32, f32, vp]
    lib.geo_rcp_mismatches.argtypes = [vp, vp]
    for fn in (lib.nerf_coarse_weights, lib.nerf_rgb_train_grads,
               lib.nerf_train_render, lib.nerf_train_render_grads, lib.nerf_frozen_sem_grads,
               lib.nerf_frozen_sem_clusters,
               lib.nerf_mip_render, lib.nerf_mip_train_render_grads, lib.nerf_field_sigma,
               lib.nerf_field, lib.nerf_mip_field, lib.nerf_field_grads,
               lib.geo_row_stats, lib.geo_means, lib.geo_grads, lib.geo_rcp_mismatches):
        fn.restype = i32
    lib.nerf_error_string.argtypes = [i32]
    lib.nerf_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = library().nerf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
