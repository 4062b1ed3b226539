"""Design probe of K7's pair sweeps (``csrc/flash_corr.cu``) on the card:
builds patched copies of that source alone under
``build/k7_probe/<variant>/`` (one nvcc each, all at once) and, for each
variant in turn, times the loss and the gradient sweep at the SOS step's
calls, checks them against the ``base`` variant's and between two calls,
and counts the SASS pair loop (``sass_spills.inner_loop``).

    python -m nerfsos_torch.tools.k7_probe [--variants base,rows4,cols32] [--reps 20]

The calls: K7f/K7g at 16 x 4096 pixels (two halves, two heads: the frozen
SOS step's), K7b/K7c at 8 x 4096 (one half, one head: ``--rand_neg``'s), 2
channels, seeded points and codes as chip_smoke's ``[K7s]``.

Variants (the sources themselves are never edited):

- ``base``: the source as it is;
- ``rowsN``: N rows a lane where a row's code values are at most 4 (``Tile::kRows``);
- ``colsN``: N columns a warp a tile (``kWarpCols``; the tile is 4 N wide);
- ``ieeercp``: every tile takes ``1.f / x`` (the IEEE division with its
  range test and slow-path call) in place of its fast path;
- ``frcp``: ``__frcp_rn(x)`` in place of ``1.f / x`` where the kernels take
  it (with ``ieeercp``: in every pair loop);
- ``sgnmul``: the gradient's sign terms as ``dd * sign(d)`` (fused into the
  sums) in place of dd with d's sign bit and a test for d == 0.

Joined with ``+``. Prints one JSON line a variant, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from nerfsos_torch import _build
from nerfsos_torch.tools import sass_spills

_SRC = os.path.join(_build.CSRC_DIR, "flash_corr.cu")
_OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "k7_probe")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"k7_probe patch: {old!r} not found")
    return text.replace(old, new)


def patch(text: str, variant: str) -> str:
    """The source text with the variant's patches applied."""
    for v in variant.split("+"):
        if v == "base":
            continue
        m = re.fullmatch(r"(rows|cols)(\d+)", v)
        if m and m.group(1) == "rows":
            text = _sub(text, "kK <= 4 ? 8 :", f"kK <= 4 ? {m.group(2)} :")
        elif m:
            text = _sub(text, "kWarpCols = 64;", f"kWarpCols = {m.group(2)};")
        elif v == "ieeercp":
            text = _sub(text, "if (__syncthreads_and(in_range))", "if (__syncthreads_and(0))")
        elif v == "frcp":
            text = _sub(text, "return 1.f / x;", "return __frcp_rn(x);")
        elif v == "sgnmul":
            text = _sub(text, "const float u = times_sign(dd, c[i][h][s] - xc[s]);",
                        "const float d = c[i][h][s] - xc[s]; "
                        "const float sg = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);")
            text = _sub(text, "g[i][h * kS + s] += u;", "g[i][h * kS + s] += dd * sg;")
            text = _sub(text, "t[h * kS + s] -= u;", "t[h * kS + s] += dd * -sg;")
        else:
            raise ValueError(f"unknown variant {v!r}")
    return text


def build(variants):
    """Compile each variant's copy of the source into its own library, all
    at once; returns {variant: library path}."""
    procs = {}
    for v in dict.fromkeys(variants):
        d = os.path.join(_OUT, v)
        os.makedirs(d, exist_ok=True)
        with open(_SRC) as f:
            src = patch(f.read(), v)
        with open(os.path.join(d, "flash_corr.cu"), "w") as f:
            f.write(src)
        lib = os.path.join(d, "libk7.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
               os.path.join(d, "flash_corr.cu")]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
    libs = {}
    for v, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{err}")
        with open(lib + ".log", "w") as f:
            f.write(err)
        libs[v] = lib
    return libs


def _bind(path: str):
    lib = ctypes.CDLL(path)
    vp, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.geo_means.argtypes = [vp] * 10 + [i64] + [i32] * 5 + [f32, f32, f32, vp]
    lib.geo_grads.argtypes = [vp] * 14 + [i64] + [i32] * 5 + [f32, f32, f32, vp]
    lib.geo_means.restype = lib.geo_grads.restype = i32
    return lib


def _inputs(B2: int, N: int, S: int, heads: int, seed: int):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B2, N, 3))
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    pts = [d * rng.uniform(2.0, 6.0, size=(B2, N, 1)) for _ in range(2)]
    codes = []
    for _ in range(2 * heads):
        c = rng.normal(size=(B2, N, S))
        codes.append(c / np.linalg.norm(c, axis=2, keepdims=True))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda() for a in (*pts, *codes)]


def _ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def run(lib, call, reps: int) -> dict:
    """Times and outputs of the loss and gradient sweeps of one call, on
    scratch enough for any variant's tiles (64-row x 128-column ones)."""
    B2, N, S, heads, halves, (f1, f2, *codes), rm, gm, coeff = call
    c1b, c2b = (codes[2], codes[3]) if heads == 2 else (None, None)
    k = heads * S
    scratch = torch.empty((-(-N // 64) + -(-N // 128)) * B2 * N * k, device="cuda")
    out = torch.empty(halves * heads, device="cuda")
    grads = [torch.empty_like(c) for c in codes]
    dc1b, dc2b = (grads[2], grads[3]) if heads == 2 else (None, None)
    stream = torch.cuda.current_stream().cuda_stream
    p = lambda *ts: [None if t is None else t.data_ptr() for t in ts]  # noqa: E731
    shifts = (0.5, 3.0) if halves == 2 else (0.5, 0.5)

    def means():
        code = lib.geo_means(*p(f1, f2, codes[0], codes[1], c1b, c2b, rm, gm, scratch, out),
                             scratch.numel(), B2, N, S, heads, halves, *shifts, 15.0, stream)
        if code:
            raise RuntimeError(f"geo_means returned {code}")

    def grad():
        code = lib.geo_grads(*p(f1, f2, codes[0], codes[1], c1b, c2b, rm, gm, coeff, scratch,
                                grads[0], grads[1], dc1b, dc2b), scratch.numel(), B2, N, S,
                             heads, halves, *shifts, 15.0, stream)
        if code:
            raise RuntimeError(f"geo_grads returned {code}")

    means(), grad()
    m, g = out.clone(), [x.clone() for x in grads]
    means(), grad()
    m2, g2 = out.clone(), [x.clone() for x in grads]
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(m, m2) and all(torch.equal(a, b) for a, b in zip(g, g2)))
    return {"means": m, "grads": g, "bitwise": bitwise, "means_ms": _ms(means, reps),
            "grads_ms": _ms(grad, reps)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    variants = args.variants.split(",")
    if "base" not in variants:
        variants.insert(0, "base")
    libs = build(variants)
    from nerfsos_torch.ops import flash_corr as fc

    calls = {}
    for name, B2, heads, halves in (("quad", 16, 2, 2), ("single", 8, 1, 1)):
        f1, f2, *codes = _inputs(B2, 4096, 2, heads, 21)
        rm, gm = fc.geo_row_stats_plain(f1, f2, 15.0, halves)
        coeff = torch.tensor([0.3, -1.0, 2.0, 0.7][:halves * heads], device="cuda") / (
            B2 // halves * 4096 * 4096)
        calls[name] = (B2, 4096, 2, heads, halves, (f1, f2, *codes), rm, gm, coeff)
    ref = {}
    for v in variants:
        lib = _bind(libs[v])
        funcs = sass_spills.functions(libs[v])
        line = {"variant": v}
        for name, call in calls.items():
            got = run(lib, call, args.reps)
            if name not in ref:  # base: against the plain versions
                ref[name] = got
                B2, N, S, heads, halves, pts_codes, rm, gm, coeff = call
                plain = fc.geo_quad_grads_plain if halves == 2 else fc.geo_single_grads_plain
                means_plain = fc.geo_quad_means_plain if halves == 2 else \
                    fc.geo_single_means_plain
                shifts = (0.5, 3.0) if halves == 2 else (0.5,)
                with torch.no_grad():
                    want = [means_plain(*pts_codes, rm, gm, *shifts, 15.0),
                            *plain(*pts_codes, rm, gm, coeff, *shifts, 15.0)]
                line[f"{name}_rel_err_vs_plain"] = max(
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip([got["means"], *got["grads"]], want))
            err = max([float((got["means"] - ref[name]["means"]).abs().max()
                             / ref[name]["means"].abs().max())]
                      + [float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(got["grads"], ref[name]["grads"])])
            h = call[3]
            loops = {kind: sass_spills.inner_loop(next(
                s for n, s in funcs.items() if f"{kind}_tile_kernelILi{h}ELi2E" in n))
                for kind in ("loss", "grad")}
            line[name] = {"means_ms": got["means_ms"], "grads_ms": got["grads_ms"],
                          "rel_err_vs_base": err, "bitwise": got["bitwise"],
                          **{f"{kind}_insns_per_pair": lp["insns"] * (1 + h) / lp["mufu"]
                             for kind, lp in loops.items()}}
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
