"""Where K4's time goes on the card: builds patched copies of the kernel
sources under ``<root>/build/tile_probe/<variant>/`` and times K4
(``ops.fused_render.train_render``) with each, in one process.

    python -m nerfsos_torch.tools.tile_probe [--root DIR] [--rays 32768]
        [--samples 192] [--variants base,wgclock] [--kernel k4|k9]

``--root`` is the checkout whose package, kernels and ``chip_smoke.py`` are
used (default: this one). To A/B K4 against the 64-point tile it replaced,
unpack the commit before it under ``build/`` and time both in one call:

    git archive 3e99da6 | tar -x -C build/parent
    python -m nerfsos_torch.tools.tile_probe --root build/parent --variants base,l1clock,l1
    python -m nerfsos_torch.tools.tile_probe --variants base,wgclock

Variants (a copy of ``nerfsos_torch/csrc`` each; the sources themselves are
never edited):

- ``base``: the sources as they are;
- ``l1clock`` (K4 on the 64-point ``dense()`` tile of ``csrc/tile_mlp.cuh``,
  as K4 was before 128-point tiles):
  clock64 counters, thread 0 of CTA 0, around each ``load_stage`` call
  (issuing the A and weight loads of a k step), each ``mma_stage`` call
  (the split and the mma, which first waits for those loads) and the
  kernel up to its composite;
- ``l1``: ``load_stage`` reads the first k step's weight rows at every k
  step, so the weights stay in L1 (results are wrong; the time is what K4
  takes without its L2 weight traffic);
- ``wgclock`` (K4's tile of ``csrc/wg_tile.cuh``): clock64 counters,
  thread 0 of CTA 0, around its waits for a full ring stage, the layers'
  k loops, the waits for its own wgmma inside them, the layers'
  epilogues and the whole tile loop, and the producer thread of CTA 0
  around its waits for an empty stage.

It prints one line per variant: K4's ms (CUDA events) and the counters as
shares of the counted span, then the card's name and power limit.
``--kernel k9`` times K9 (``fused_mip_render``, the mip eval pass, which
still runs the 64-point tile) instead, ``base`` variant only: an A/B of the
kernels that this tile change must leave alone.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_COUNTERS = """
static __device__ unsigned long long g_probe[8];
#define PROBE_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define PROBE_ADD(i, t0) do { if (PROBE_ON) g_probe[i] += clock64() - (t0); } while (0)
"""

_READER = """
extern "C" int probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  unsigned long long zero[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)e;
}
"""


def _sub(text: str, old: str, new: str, count: int = 0) -> str:
    n = text.count(old)
    if n == 0 or (count and n != count):
        raise RuntimeError(f"probe patch: {old!r} found {n} times")
    return text.replace(old, new)


def _patch(variant: str, csrc: str) -> None:
    def edit(name, fn):
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(fn(text))

    if variant == "l1":
        edit("tile_mlp.cuh", lambda t: _sub(
            t, "const size_t row = (size_t)(ks * 8 + t) * ldn + g;",
            "const size_t row = (size_t)t * ldn + g;", 1))
    elif variant == "l1clock":
        def tile(t):
            t = _sub(t, "#include <stdint.h>\n", "#include <stdint.h>\n" + _COUNTERS, 1)
            t = re.sub(r"(\n\s*)(load_stage\(st[01], [^;]*;)",
                       r"\1{ long long p0 = clock64(); \2 PROBE_ADD(1, p0); }", t)
            return re.sub(r"(\n\s*)(mma_stage\(acc, st[01], [^;]*;)",
                          r"\1{ long long p0 = clock64(); \2 PROBE_ADD(2, p0); }", t)

        edit("tile_mlp.cuh", tile)

        def kern(t):
            t = _sub(t, "float* __restrict__ semin, int R, int S, unsigned seed,\n"
                        "                        float noise_std) {\n",
                     "float* __restrict__ semin, int R, int S, unsigned seed,\n"
                     "                        float noise_std) {\n"
                     "  long long p_start = clock64();\n", 1)
            t = _sub(t, "  composite_chunk<kForward, kMip>(odv, zc, nullptr, nullptr, d, nullptr,",
                     "  PROBE_ADD(0, p_start);\n"
                     "  composite_chunk<kForward, kMip>(odv, zc, nullptr, nullptr, d, nullptr,", 1)
            return t + _READER

        edit("train_render.cu", kern)
    elif variant == "wgclock":
        def tile(t):
            t = _sub(t, "#include \"train_sweep.cuh\"\n",
                     "#include \"train_sweep.cuh\"\n" + _COUNTERS, 1)
            t = _sub(t, "    while (!mbar_try_wait(rg.full + slot, phase)) {\n    }\n",
                     "    long long p_w = clock64();\n"
                     "    while (!mbar_try_wait(rg.full + slot, phase)) {\n    }\n"
                     "    PROBE_ADD(1, p_w);\n", 1)
            wait = "        while (!mbar_try_wait(rg.empty + slot, phase ^ 1)) {\n        }\n"
            t = _sub(t, wait, "        long long p_e = clock64();\n" + wait
                     + "        if (blockIdx.x == 0) g_probe[2] += clock64() - p_e;\n", 1)
            # the layer products' k loops, their own wgmma waits, and the epilogues
            t = _sub(t, "  load(0, raw);\n", "  load(0, raw);\n  long long p_k = clock64();\n", 1)
            t = _sub(t, "    wgmma_wait<0>();\n", "    long long p_g = clock64();\n"
                     "    wgmma_wait<0>();\n    PROBE_ADD(4, p_g);\n", 1)
            t = _sub(t, "  pos += nsteps;\n", "  pos += nsteps;\n  PROBE_ADD(3, p_k);\n"
                     "  long long p_x = clock64();\n", 1)
            t = _sub(t, "    __syncwarp();\n    return pos;\n",
                     "    __syncwarp();\n    PROBE_ADD(5, p_x);\n    return pos;\n", 1)
            lines = t.split("\n")
            i = max(j for j, s in enumerate(lines[:t[:t.index("wg_layer_n")].count("\n")])
                    if s == "  return pos;")
            lines[i] = "  PROBE_ADD(5, p_x);\n  return pos;"
            return "\n".join(lines)

        edit("wg_tile.cuh", tile)

        def kern(t):
            t = _sub(t, "  int pos = 0;\n",
                     "  int pos = 0;\n  long long p_start = clock64();\n", 1)
            t = _sub(t, "  asm volatile(\"bar.sync 3, %0;\\n\"",
                     "  PROBE_ADD(0, p_start);\n  asm volatile(\"bar.sync 3, %0;\\n\"", 1)
            return t + _READER

        edit("train_render.cu", kern)
    elif variant != "base":
        raise ValueError(f"unknown variant {variant}")


def _use(_build, root: str, variant: str):
    """Point _build at a patched copy of root's sources and load its library."""
    base = os.path.join(root, "build", "tile_probe", variant)
    csrc = os.path.join(base, "csrc")
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(root, "nerfsos_torch", "csrc"), csrc)
    _patch(variant, csrc)
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, os.path.join(base, "kernels")
    _build.library.cache_clear()
    lib = _build.library()
    if variant.endswith("clock"):
        lib.probe_read.argtypes = [ctypes.c_void_p]
        lib.probe_read.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=32768)
    ap.add_argument("--samples", type=int, default=192)
    ap.add_argument("--variants", default="base,wgclock")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernel", default="k4", choices=("k4", "k9"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("tile_probe: no CUDA device visible", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    for m in [m for m in sys.modules if m == "chip_smoke" or m.startswith("nerfsos_torch")]:
        del sys.modules[m]  # the package and chip_smoke.py of root, not of this checkout
    from chip_smoke import (cuda_ms, mip_ray_inputs, ray_inputs, seeded_field,
                            seeded_mip_field, smi_line)
    from nerfsos_torch import _build
    from nerfsos_torch.ops import fused_render as fr

    if a.kernel == "k9":
        field = seeded_mip_field(5)
        odv, z = mip_ray_inputs(a.rays, a.samples, seed=11)
        run = lambda: fr.fused_mip_render(field, odv, z)  # noqa: E731
    else:
        field = seeded_field(3, net_depth=8, net_width=256, multires=10, multires_views=4,
                             use_semantics=True, sem_with_coord=True, sem_dim=2)
        odv, z = ray_inputs(a.rays, a.samples, seed=11)
        kw = dict(noise_std=1.0, seed=7654321, save_semin=True)
        run = lambda: fr.train_render(field, odv, z, **kw)  # noqa: E731
    for variant in a.variants.split(","):
        lib = _use(_build, root, variant)
        with torch.no_grad():
            ms = cuda_ms(run, reps=3, warmup=1)
            out = {"root": os.path.relpath(root, HERE), "variant": variant, "rays": a.rays,
                   "samples": a.samples, f"{a.kernel}_ms": ms}
            if variant.endswith("clock"):
                buf = (ctypes.c_ulonglong * 8)()
                _build.check(lib.probe_read(buf), "probe_read")  # drop the timed calls' sums
                run()
                torch.cuda.synchronize()
                _build.check(lib.probe_read(buf), "probe_read")
                total = max(buf[0], 1)
                names = (["load_stage", "mma_stage"] if variant == "l1clock"
                         else ["ring_full_wait", "producer_empty_wait", "k_loops",
                               "own_wgmma_wait", "epilogues"])
                out["cycles_cta0_thread0"] = buf[0]
                out.update({f"{n}_share": buf[i + 1] / total for i, n in enumerate(names)})
        print(json.dumps(out), flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
