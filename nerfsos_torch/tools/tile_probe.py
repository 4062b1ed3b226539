"""Where K4's, K3's, K6's, K5's, K9's, K10b's and the field forwards' time
goes on the card: builds patched copies of the kernel sources under
``<root>/build/tile_probe/<variant>/`` and times K4
(``ops.fused_render.train_render``), K6 (``train_render_grads``), K3
(``fused_rgb_train_grads``), K5 (``frozen_sem_grads``), K2
(``fused_render``), K1 (``fused_coarse_weights``), K9 (``fused_mip_render``),
K10a (``mip_train_render``), K10b (``mip_train_render_grads``), K8b
(``ops.fused_field.field_forward``), K8a (``fused_sigma_apply``), K11
(``fused_mip_field_apply``) or K8f/K8c (``field_grads``) with each, in one
process.

    python -m nerfsos_torch.tools.tile_probe [--root DIR] [--rays 32768]
        [--samples 192[,64...]] [--variants base,wgclock]
        [--kernel k4|k9|k10a|k10b|k6|k3|k5|k2|k1|k8b|k8a|k11|k8f|k8c]

``--root`` is the checkout whose package, kernels and ``chip_smoke.py`` are
used (default: this one). To A/B K9 against the parent's, unpack the
parent under ``build/`` and time both in one call:

    git archive <parent> | tar -x -C build/parent
    python -m nerfsos_torch.tools.tile_probe --root build/parent --kernel k9 \
        --samples 190,63 --variants base
    python -m nerfsos_torch.tools.tile_probe --kernel k9 --samples 190,63 \
        --variants base,wgclock

Variants (a copy of ``nerfsos_torch/csrc`` each; the sources themselves are
never edited):

- ``base``: the sources as they are;
- ``wgclock`` (the 128-point tile of ``csrc/wg_tile.cuh``: K4, K2, K1, K9,
  K10a, K3's, K6's, K10b's and K8f/K8c's forward, the field forwards
  K8a/K8b/K11):
  clock64 counters, thread 0 of CTA 0, around its waits for a full ring
  stage, the layers' k loops, the waits for its own wgmma inside them, the
  layers' epilogues, the point-list modes' copy-out of a warpgroup's rows
  (its barrier included) and the whole tile loop, and the producer thread
  of CTA 0 around its waits for an empty stage;
- ``fwdonly`` (K3, K6, K10b, K8c/K8f): ``train_grads`` and the field
  backward launch the forward kernel of each wave and the reduction but no
  reverse-sweep kernel, so the reverse sweep's time is ``base``'s less this;
- ``sweepclock`` (K3, K6): clock64 counters, thread 0 of CTA 0 over every
  wave, in ``train_reverse_kernel`` (``csrc/train_sweep.cuh``): the whole
  kernel; each ``wgrad`` (the dW products), its issue of the next tile's
  ``cp.async`` copies and its waits for them (``cp.async.wait_group`` and
  the barrier after it); each ``bwd_layer`` (the dX products), thread 0's
  fills of the backward ring (its turns as the producer: the bulk copies'
  issue and its waits for a free stage), its waits for a full stage and its
  epilogues;
- ``semclock`` (K5, ``frozen_sem_kernel`` in ``csrc/train_render.cu``):
  clock64 counters in CTA 0 over its run of tiles: thread 0 (the forward
  warpgroup F) around its whole tile loop, its waits for a full sem_in
  stage, its waits for a full W0 stage, its forward products (the W0 waits
  included), its waits for the dW0 warpgroups to free ds and its
  epilogues (ds, the small sums); thread 128 (dW0 warpgroup D0) around its
  waits for a full sem_in stage and for ds, and its whole tile loop;
- ``bwdstagesN`` (K3, K6): the reverse sweep's ring with N stages
  (``kBwdStages``; the shared memory grows with it);
- ``nostore``, ``nocomposite``, ``epistore`` (K3's and K6's forward on the
  128-point tile; results wrong but for ``epistore``): no workspace stores;
  no composite after the tiles; the layer-mode stores from the epilogue's
  registers (a warp's 8 points of two rows a store) in place of the
  warp's float4 copy of its points from h.

Variants join with ``+`` (``fwdonly+nostore``: one copy with both patches).

It prints one line per variant and sample count: the kernel's ms (CUDA
events) and the counters as shares of the counted span, then the card's
name and power limit. ``--kernel k9`` takes the mip eval pass (K4's kernel
in its mip mode, no noise) on the flagship mip field, ``--samples`` its
intervals a ray (190 and 63 on the eval path), ``--kernel k10a`` the same
with noise 1 (the mip train forward). ``--kernel k6`` takes the full SOS
finetune's backward at the flagship width with the semantic head and its
coordinates and seeded map and weight cotangents, ``--kernel k3`` the RGB
train pass with the semantic head, ``--kernel k5`` the frozen finetune's
semantic-head backward on K4's own ``sem_in`` and weights of those rays,
with seeded map cotangents, ``--kernel k2`` the eval fine render (K4's
kernel without noise or sem_in; ``--rays 32768`` is one ``--ray_chunk`` of
the eval path), ``--kernel k1`` the eval coarse pass, ``--kernel k10b``
the mip train backward (noise 1, seeded map and weight cotangents; its
forward is K6's on K4's tile in its mip mode). ``--kernel k8b`` takes the
field forward of the flagship field with the semantic head and its
coordinates on ``--rays`` x ``--samples`` points uniform in the x14
density grid's cube (4096 x 64: one 2^18-point export chunk) with random
unit directions, ``k8a`` the sigma forward of the same field, ``k11`` the
flagship mip field at random covariances below 1e-4; ``--kernel k8f``
the field backward of that field (chip_smoke's ``[K8_bwd]``: the points of
``--rays`` x ``--samples`` of ``ray_inputs``, a seeded cotangent), ``k8c``
the same with the points' and directions' gradients (``fwdonly``: the
forward alone). With ``--root``
unpacked from a parent commit, the kernels are timed through that tree's
wrappers (the same Python interface), ``base`` variant only, for an A/B
in one call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_NPROBE = 12
_COUNTERS = """
static __device__ unsigned long long g_probe[%d];
#define PROBE_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define PROBE_ADD(i, t0) do { if (PROBE_ON) g_probe[i] += clock64() - (t0); } while (0)
""" % _NPROBE

_READER = """
extern "C" int probe_read%s(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  unsigned long long zero[sizeof(g_probe) / 8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)e;
}
"""
READER = _READER % ""  # train_render.cu's counters
FIELD_READER = _READER % "_field"  # fused_field.cu's (a translation unit of its own)
FIELD_KERNELS = ("k8a", "k8b", "k11", "k8f", "k8c")


def _sub(text: str, old: str, new: str, count: int = 0) -> str:
    n = text.count(old)
    if n == 0 or (count and n != count):
        raise RuntimeError(f"probe patch: {old!r} found {n} times")
    return text.replace(old, new)


def _in_function(text: str, head: str, fn) -> str:
    """text with fn applied to the function that starts with head."""
    i = text.index(head)
    j = text.index("\n}\n", i) + 3
    return text[:i] + fn(text[i:j]) + text[j:]


def _sweep_clocks(t: str) -> str:
    """train_sweep.cuh with sweepclock's counters: 0 the reverse kernel;
    wgrad: 1 all of it, 2 thread 0's fills (bulk-copy issue and its waits
    for a free slot), 3 its waits for a full stage (with the fills made
    while waiting), 4 the dY conversion with the barrier after it, 5 its
    warpgroup's products (8 k steps a sub), 6 the partial dW's read and
    write (once a round); bwd_layer: 7 all of it, 8 thread 0's fills, 9 its
    waits for a full stage, 10 its epilogues."""
    t = _sub(t, "#include \"wgmma.cuh\"\n", "#include \"wgmma.cuh\"\n" + _COUNTERS, 1)

    def wgrad(body):
        body = _sub(body, "  constexpr int K = kWgrStages;\n",
                    "  constexpr int K = kWgrStages;\n  long long p_all = clock64();\n", 1)
        body = _sub(body, "  return pos;\n}\n", "  PROBE_ADD(1, p_all);\n  return pos;\n}\n", 1)
        body = _sub(body, "  auto pump = [&](int until) {  // fill every stage before `until`, "
                    "then those with a free slot\n",
                    "  auto pump = [&](int until) {\n    long long p_p = clock64();\n", 1)
        body = _sub(body, "    }\n  };\n  auto wait_full = [&](int q) {\n",
                    "    }\n    PROBE_ADD(2, p_p);\n  };\n  auto wait_full = [&](int q) {\n"
                    "    long long p_w = clock64();\n", 1)
        body = _sub(body, "    }\n  };\n  if (tid == 0) pump(0);\n",
                    "    }\n    PROBE_ADD(3, p_w);\n  };\n  if (tid == 0) pump(0);\n", 1)
        body = _sub(body, "      // dY row n, points 8 kk .. 8 kk + 7 into k-slice kk of B",
                    "      long long p_c = clock64();\n"
                    "      // dY row n, points 8 kk .. 8 kk + 7 into k-slice kk of B", 1)
        body = _sub(body, "      __syncthreads();  // B is whole\n",
                    "      __syncthreads();  // B is whole\n      PROBE_ADD(4, p_c);\n", 1)
        body = _sub(body, "        wait_full(q);\n",
                    "        wait_full(q);\n        long long p_k = clock64();\n", 1)
        body = _sub(body, "        if (lane == 0) mbar_arrive_n(wr.empty + q % K, 4);  "
                    "// the X stage is free\n",
                    "        if (lane == 0) mbar_arrive_n(wr.empty + q % K, 4);\n"
                    "        PROBE_ADD(5, p_k);\n", 1)
        body = _sub(body, "    if (live) {\n#pragma unroll\n      for (int i = 0; i < NP / 2; ++i) "
                    "asm volatile(\"\" : \"+f\"(acc[i])::\"memory\");\n      // accumulator i: row 64",
                    "    long long p_r = clock64();\n    if (live) {\n#pragma unroll\n      for "
                    "(int i = 0; i < NP / 2; ++i) asm volatile(\"\" : \"+f\"(acc[i])::\"memory\");\n"
                    "      // accumulator i: row 64", 1)
        return _sub(body, "    if (sums && tid < rd.nrow) db[rd.pc * NP + tid] += dbacc;\n",
                    "    PROBE_ADD(6, p_r);\n"
                    "    if (sums && tid < rd.nrow) db[rd.pc * NP + tid] += dbacc;\n", 1)

    def pieces(body):
        head = body.index("\n", body.index("  auto fill = [&]("))
        end = body.index("\n  };\n", head)
        body = (body[:head] + "\n    long long p_f = clock64();" + body[head:end]
                + "\n    PROBE_ADD(8, p_f);" + body[end:])
        wait = ("      while (!mbar_try_wait(br.full + slot, (at / kBwdStages) & 1)) {\n"
                "      }\n")
        body = _sub(body, wait, "      long long p_w = clock64();\n" + wait
                    + "      PROBE_ADD(9, p_w);\n", 1)
        body = _sub(body, "    if (!live) continue;\n",
                    "    if (!live) continue;\n    long long p_e = clock64();\n", 1)
        return _sub(body, "    }\n  }\n  return pos + total;\n",
                    "    }\n    PROBE_ADD(10, p_e);\n  }\n  return pos + total;\n", 1)

    def layer(body):
        body = _sub(body, "  const int nk = L.k / 8, ldn = pad8(L.n);\n",
                    "  long long p_all = clock64();\n  const int nk = L.k / 8, ldn = pad8(L.n);\n", 1)
        return _sub(body, "  return pos;\n}\n", "  PROBE_ADD(7, p_all);\n  return pos;\n}\n", 1)

    t = _in_function(t, "__device__ __forceinline__ int wgrad_rounds(", wgrad)
    t = _in_function(t, "__device__ __forceinline__ int bwd_pieces(", pieces)
    t = _in_function(t, "__device__ __forceinline__ int bwd_layer(", layer)
    t = _in_function(t, "    train_reverse_kernel(", lambda b: _sub(
        _sub(b, "  float* region = reinterpret_cast<float*>(rev_raw + kRevHead);\n",
             "  float* region = reinterpret_cast<float*>(rev_raw + kRevHead);\n"
             "  long long p_start = clock64();\n", 1),
        "  if (kInGrad) {\n    __syncthreads();", "  PROBE_ADD(0, p_start);\n"
        "  if (kInGrad) {\n    __syncthreads();", 1))
    return t


def _sem_clocks(t: str) -> str:
    """train_render.cu with semclock's counters: 0 F's tile loop, 1 its
    sem_in waits, 2 its W0 waits, 3 its forward products, 4 its ds waits,
    5 its epilogues (thread 0); 6 D0's sem_in and ds waits, 7 its tile loop
    (thread 128)."""
    t = _sub(t, '#include "wg_tile.cuh"\n', '#include "wg_tile.cuh"\n' + _COUNTERS
             + "#define SEM_PROBE(i, t0, tid) do { if (blockIdx.x == 0 && threadIdx.x == (tid)) "
               "g_probe[i] += clock64() - (t0); } while (0)\n", 1)
    t = _sub(t, "  int wpos = 0;\n  for (int i = 0; i < nt; ++i) {\n",
             "  int wpos = 0;\n  long long p_f = clock64();\n  for (int i = 0; i < nt; ++i) {\n", 1)
    t = _sub(t, "  // the four warps' sums in order", "  SEM_PROBE(0, p_f, 0);\n"
             "  // the four warps' sums in order", 1)
    t = _sub(t, "    mbar_wait(c.xfull + slot, (i / d.xstages) & 1);\n    const float* x = c.xs + "
                "(size_t)slot * kSemPts * C;\n    const float* xa",
             "    long long p_x = clock64();\n    mbar_wait(c.xfull + slot, (i / d.xstages) & 1);\n"
             "    SEM_PROBE(1, p_x, 0);\n    const float* x = c.xs + (size_t)slot * kSemPts * C;\n"
             "    const float* xa", 1)
    t = _sub(t, "      mbar_wait(c.wfull + wslot, (wpos / d.wstages) & 1);\n",
             "      long long p_w = clock64();\n      mbar_wait(c.wfull + wslot, (wpos / d.wstages) & 1);"
             "\n      SEM_PROBE(2, p_w, 0);\n", 1)
    t = _sub(t, "    for (int st = 0; st < nst; ++st, ++wpos) {\n",
             "    long long p_m = clock64();\n    for (int st = 0; st < nst; ++st, ++wpos) {\n", 1)
    t = _sub(t, "    sem_release_x(c, slot, rank);\n\n    // d_sem",
             "    SEM_PROBE(3, p_m, 0);\n    sem_release_x(c, slot, rank);\n\n    // d_sem", 1)
    t = _sub(t, "    mbar_wait(c.dsempty, (i & 1) ^ 1);",
             "    long long p_d = clock64();\n    mbar_wait(c.dsempty, (i & 1) ^ 1);\n"
             "    SEM_PROBE(4, p_d, 0);\n    long long p_e = clock64();", 1)
    t = _sub(t, "    if (lane == 0) mbar_arrive(c.dsfull);\n",
             "    if (lane == 0) mbar_arrive(c.dsfull);\n    SEM_PROBE(5, p_e, 0);\n", 1)
    t = _sub(t, "  for (int i = 0; i < nt; ++i) {\n    const int slot = i % d.xstages;\n"
                "    mbar_wait(c.xfull + slot, (i / d.xstages) & 1);\n    mbar_wait(c.dsfull, i & 1);\n",
             "  long long p_r = clock64();\n  for (int i = 0; i < nt; ++i) {\n"
             "    const int slot = i % d.xstages;\n    long long p_q = clock64();\n"
             "    mbar_wait(c.xfull + slot, (i / d.xstages) & 1);\n    mbar_wait(c.dsfull, i & 1);\n"
             "    SEM_PROBE(6, p_q, 128);\n", 1)
    return _sub(t, "  // accumulator e of block u: feature 64 (kSemMb dwg + u)",
                "  SEM_PROBE(7, p_r, 128);\n  // accumulator e of block u: feature 64 (kSemMb dwg + u)",
                1) + READER


def _patch(variant: str, csrc: str) -> None:
    """Apply each of a '+'-joined variant's patches to the copy at csrc."""
    for v in variant.split("+"):
        _patch_one(v, csrc)


def _patch_one(variant: str, csrc: str) -> None:
    def edit(name, fn):
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(fn(text))

    if variant == "wgclock":
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
            i = t.index("    return pos;\n", t.index("    __syncwarp();\n"))  # layer mode's
            t = t[:i] + "    PROBE_ADD(5, p_x);\n" + t[i:]
            lines = t.split("\n")
            i = max(j for j, s in enumerate(lines[:t[:t.index("wg_layer_n")].count("\n")])
                    if s == "  return pos;")
            lines[i] = "  PROBE_ADD(5, p_x);\n  return pos;"
            t = "\n".join(lines)
            # the point-list modes' copy-out of a warpgroup's rows
            t = _sub(t, "  if (kOut && !kSigma) {  // the warpgroup's rows of out",
                     "  long long p_o = clock64();\n"
                     "  if (kOut && !kSigma) {  // the warpgroup's rows of out", 1)
            return _sub(t, "      if (c != 3) out[e] = wstrip[p * cs + (c < 3 ? c : c - 1)];\n"
                        "    }\n  }\n", "      if (c != 3) out[e] = wstrip[p * cs + (c < 3 ? c : "
                        "c - 1)];\n    }\n  }\n  PROBE_ADD(6, p_o);\n", 1)

        edit("wg_tile.cuh", tile)

        def kern(t):
            # the tile loops of K4's kernel (each input mode) and of K3's and K6's forward
            t = _sub(t, "  int pos = 0;\n", "  int pos = 0;\n  long long p_start = clock64();\n")
            t = _sub(t, "  asm volatile(\"bar.sync 3, %0;\\n\"",
                     "  PROBE_ADD(0, p_start);\n  asm volatile(\"bar.sync 3, %0;\\n\"")
            return t + READER

        edit("train_render.cu", kern)

        def field(body):  # the field forwards' tile loop
            body = _sub(body, "  int pos = 0;\n", "  int pos = 0;\n  long long p_start = clock64();\n", 1)
            return _sub(body, "pl);\n}\n", "pl);\n  PROBE_ADD(0, p_start);\n}\n", 1)

        def bwd_field(body):  # the field backward's forward tile loop
            body = _sub(body, "  int pos = 0;\n", "  int pos = 0;\n  long long p_start = clock64();\n",
                        1)
            return _sub(body, "  // the consumers alone from here", "  PROBE_ADD(0, p_start);\n"
                        "  // the consumers alone from here", 1)

        edit("fused_field.cu", lambda t: _in_function(
            _in_function(t, "    field_wg_kernel(", field), "    field_bwd_forward_kernel(",
            bwd_field) + FIELD_READER)
    elif variant == "fwdonly":
        edit("train_render.cu", lambda t: _sub(
            t, "    if (err == 0)\n      err = (bf16 ? reverse_wave_bf16 : reverse_wave_f32)(sem, "
               "bring, d, brd, partial, workspace,\n"
               "                                                          R, S, grid, wave, group, "
               "st);\n", "", 1))
        edit("fused_field.cu", lambda t: _sub(
            t, "    train_reverse_kernel<kSem, kInGrad, kBf16><<<grid, kThreads, kReverseSmem, st>>>(\n"
               "        bring, iring, *d, *brd, *ird, partial, workspace, N, 1, wave, group, dpts, "
               "ddirs);\n", "", 1))
    elif variant == "sweepclock":
        edit("train_sweep.cuh", _sweep_clocks)
        edit("train_render.cu", lambda t: t + READER)
    elif variant == "semclock":
        edit("train_render.cu", _sem_clocks)
    elif variant.startswith("bwdstages"):
        edit("train_sweep.cuh", lambda t: _sub(t, "constexpr int kBwdStages = 4;",
                                               f"constexpr int kBwdStages = {variant[9:]};", 1))
    elif variant == "nostore":
        edit("wg_tile.cuh", lambda t: _sub(t, "const bool store = kStore && qw < nq;",
                                           "const bool store = false;", 1))
    elif variant == "nocomposite":
        edit("train_render.cu", lambda t: _sub(
            t, "  composite_chunk<kMode, kMip>(odv, zc, aux, dweights, d, ws, strip,",
            "  if (false) composite_chunk<kMode, kMip>(odv, zc, aux, dweights, d, ws, strip,", 1))
    elif variant == "epistore":
        def tile(t):
            start = t.index("    if (kStore && o.plane) {  // the warp's 16 points of each row")
            t = t[:start] + t[t.index("\n    }\n", start) + 7:]  # the copy from h goes
            return _sub(t, "      if (rb && n + 1 < o.hn) rb[n + 1] = v[3];\n", """\
      if (rb && n + 1 < o.hn) rb[n + 1] = v[3];
      if (kStore && o.plane && n < o.prow) {  // a warp's 8 points of rows n, n + 1
        float* r = o.plane + n * kLd;
        r[m0] = v[0];
        r[m0 + 8] = v[2];
        r[kLd + m0] = v[1];
        r[kLd + m0 + 8] = v[3];
      }
""", 1)

        edit("wg_tile.cuh", tile)
    elif variant != "base" and not variant.startswith("revpoints"):
        raise ValueError(f"unknown variant {variant}")


def _clock(variant: str) -> str:
    """The clock64 part of a '+'-joined variant, or ''."""
    return next((v for v in variant.split("+") if v.endswith("clock")), "")


def _sources(variant: str) -> str:
    """The '+'-joined source patches of a variant ('base' for none)."""
    parts = [v for v in variant.split("+") if not v.startswith("revpoints")]
    return "+".join(parts) or "base"


def prepare(_build, root: str, variant: str) -> str:
    """Point _build at a patched copy of root's sources (its build directory
    beside it); returns the variant's source patches."""
    variant = _sources(variant)
    base = os.path.join(root, "build", "tile_probe", variant)
    csrc = os.path.join(base, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(os.path.join(root, "nerfsos_torch", "csrc"), csrc)
    _patch(variant, csrc)
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, os.path.join(base, "kernels")
    _build.SPLIT = not _clock(variant)  # a clock variant's counters are one unit's
    _build.library.cache_clear()
    return variant


def _use(_build, root: str, variant: str):
    """Point _build at a patched copy of root's sources and load its library
    (built unless one for the same sources is there)."""
    variant = prepare(_build, root, variant)
    lib = _build.library()
    if _clock(variant):
        for fn in (lib.probe_read, *([lib.probe_read_field] if _clock(variant) == "wgclock"
                                     else [])):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


KERNELS = ("k4", "k9", "k10a", "k10b", "k6", "k3", "k5", "k2", "k1", "k8b", "k8a", "k11", "k8f",
           "k8c")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=32768)
    ap.add_argument("--samples", default="192", help="samples a ray, a comma-separated list")
    ap.add_argument("--variants", default="base,wgclock")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernel", default="k4", choices=KERNELS)
    return ap


def main() -> int:
    a = parser().parse_args()
    if not torch.cuda.is_available():
        print("tile_probe: no CUDA device visible", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    for m in [m for m in sys.modules if m == "chip_smoke" or m.startswith("nerfsos_torch")]:
        del sys.modules[m]  # the package and chip_smoke.py of root, not of this checkout
    from chip_smoke import (cuda_ms, grid_points, mip_ray_inputs, ray_inputs, seeded_field,
                            seeded_mip_field, smi_line, unit_dirs)
    from nerfsos_torch.core.sampling import points_along_rays
    from nerfsos_torch import _build
    from nerfsos_torch.ops import fused_field as ff
    from nerfsos_torch.ops import fused_render as fr

    def runner(S: int):
        """The call to time at S samples a ray."""
        if a.kernel in ("k8f", "k8c"):
            field = seeded_field(43, net_depth=8, net_width=256, multires=10, multires_views=4,
                                 use_semantics=True, sem_with_coord=True, sem_dim=2)
            odv, z = ray_inputs(a.rays, S, seed=44)
            pts = points_along_rays(odv[:, 0:3], odv[:, 3:6], z).reshape(-1, 3).contiguous()
            dirs = odv[:, None, 6:9].expand(a.rays, S, 3).reshape(-1, 3).contiguous()
            rng = np.random.default_rng(45)
            g = torch.from_numpy(rng.normal(size=(pts.shape[0], 6)).astype(np.float32)).cuda()
            return lambda: ff.field_grads(field, pts, dirs, g, input_grads=a.kernel == "k8c")
        if a.kernel in FIELD_KERNELS:
            n = a.rays * S
            pts, dirs = grid_points(n, 50), unit_dirs(n, 51)
            if a.kernel == "k11":
                mip = seeded_mip_field(42)
                g = torch.Generator().manual_seed(52)
                cov = (torch.rand(n, 3, generator=g) * 1e-4).cuda()
                return lambda: ff.fused_mip_field_apply(mip, pts, cov, dirs)
            field = seeded_field(40, net_depth=8, net_width=256, multires=10, multires_views=4,
                                 use_semantics=True, sem_with_coord=True, sem_dim=2)
            if a.kernel == "k8a":
                return lambda: ff.fused_sigma_apply(field, pts)
            return lambda: ff.field_forward(field, pts, dirs)
        if a.kernel in ("k9", "k10a", "k10b"):
            field = seeded_mip_field(5)
            odvr, z = mip_ray_inputs(a.rays, S, seed=11)
            if a.kernel == "k10b":
                rng = np.random.default_rng(S)
                dmaps = torch.from_numpy(rng.normal(size=(a.rays, 5)).astype(np.float32)).cuda()
                dw = torch.from_numpy(rng.normal(size=(a.rays, S)).astype(np.float32)).cuda()
                return lambda: fr.mip_train_render_grads(field, odvr, z, dmaps, dw, noise_std=1.0,
                                                         seed=7654321)
            if a.kernel == "k10a":
                return lambda: fr.mip_train_render(field, odvr, z, noise_std=1.0, seed=7654321)
            return lambda: fr.fused_mip_render(field, odvr, z)
        if a.kernel == "k1":
            field = seeded_field(0, net_depth=8, net_width=256, multires=10, multires_views=4)
            odv, z = ray_inputs(a.rays, S, seed=11)
            od = odv[:, :6].contiguous()
            return lambda: fr.fused_coarse_weights(field, od, z)
        field = seeded_field(3 if a.kernel != "k3" else 2, net_depth=8, net_width=256,
                             multires=10, multires_views=4, use_semantics=True,
                             sem_with_coord=a.kernel != "k3", sem_dim=2)
        odv, z = ray_inputs(a.rays, S, seed=11)
        rng = np.random.default_rng(S)
        if a.kernel == "k6":
            dmaps = torch.from_numpy(rng.normal(size=(a.rays, 7)).astype(np.float32)).cuda()
            dw = torch.from_numpy(rng.normal(size=(a.rays, S)).astype(np.float32)).cuda()
            return lambda: fr.train_render_grads(field, odv, z, dmaps, dw, noise_std=1.0,
                                                 seed=7654321)
        if a.kernel == "k3":
            gt = torch.from_numpy(rng.uniform(0, 1, (a.rays, 3)).astype(np.float32)).cuda()
            return lambda: fr.fused_rgb_train_grads(field, odv, z, gt, white_bkgd=False,
                                                    noise_std=1.0, seed=7654321)
        if a.kernel == "k2":
            return lambda: fr.fused_render(field, odv, z)
        kw = dict(noise_std=1.0, seed=7654321, save_semin=True)
        if a.kernel == "k5":
            with torch.no_grad():
                _, w, sem_in = fr.train_render(field, odv, z, **kw)
            dmaps = torch.from_numpy(rng.normal(size=(a.rays, 7)).astype(np.float32)).cuda()
            return lambda: fr.frozen_sem_grads(field, sem_in, w, dmaps)
        return lambda: fr.train_render(field, odv, z, **kw)

    names = {"wgclock": ["ring_full_wait", "producer_empty_wait", "k_loops", "own_wgmma_wait",
                         "epilogues", "copy_out"],
             "sweepclock": ["wgrad", "wgrad_fills", "wgrad_full_wait", "wgrad_convert",
                            "wgrad_products", "wgrad_partial_rmw", "bwd_layer",
                            "bwd_layer_fill_issue", "bwd_layer_full_wait", "bwd_layer_epilogue"],
             "semclock": ["f_x_wait", "f_w_wait", "f_products", "f_ds_wait", "f_epilogue",
                          "d0_waits", "d0_loop"]}
    runs = {int(S): runner(int(S)) for S in a.samples.split(",")}
    rev_points = getattr(fr, "_REV_POINTS", None)
    for variant in a.variants.split(","):
        lib = _use(_build, root, variant)
        rev = next((v for v in variant.split("+") if v.startswith("revpoints")), None)
        fr._REV_POINTS = int(rev[9:]) if rev else rev_points
        for S, run in runs.items():
            with torch.no_grad():
                ms = cuda_ms(run, reps=3, warmup=1)
                out = {"root": os.path.relpath(root, HERE), "variant": variant, "rays": a.rays,
                       "samples": S, f"{a.kernel}_ms": ms}
                if _clock(variant):
                    read = (lib.probe_read_field if a.kernel in FIELD_KERNELS
                            else lib.probe_read)
                    buf = (ctypes.c_ulonglong * _NPROBE)()
                    _build.check(read(buf), "probe_read")  # drop the timed calls' sums
                    run()
                    torch.cuda.synchronize()
                    _build.check(read(buf), "probe_read")
                    total = max(buf[0], 1)
                    out["cycles_cta0_thread0"] = buf[0]
                    out.update({f"{n}_share": buf[i + 1] / total
                                for i, n in enumerate(names[_clock(variant)])})
            print(json.dumps(out), flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
