// The forward tile of the SOS train forward K4 (train_render.cu
// train_render_wg_kernel), redesigned for Hopper: 128 points a tile, two
// consumer warpgroups of 64 points each and one producer thread that
// streams every layer's weights through a ring of shared-memory stages
// with bulk (TMA) copies, and the layer products on wgmma in 3xTF32.
//
// Replaces, with the kernel, nerfsos_tpu/ops/pallas/fused_render.py
// _train_render_fwd_impl -> _train_render_kernel; it took the place of a
// first design on mma.sync over 64-point tiles, whose last caller, the
// field backward's forward, now runs this tile too.
//
// What bounds it on the H100: the 3xTF32 products, ~1.27 MFLOP a flagship
// point (8 x 256 trunk, the semantic head with coordinates), 48.39 ms for
// the SOS step's 32768 x 192 fine pass at 165 TFLOP/s (495 TF32 / 3); its
// sem_in write (8.0 GB there) is 2.4 ms at 3.35 TB/s.
//
// What held the old tile back (clock64 counters and a variant with the
// weight rows held in L1, nerfsos_torch/tools/tile_probe.py, H100): 37% of
// the tile loop issuing each k step's loads (A from shared memory, the
// weights' TF32 parts with __ldg, 16 a thread), 32% in the m16n8k8 mma and
// their splits, 31% outside the products; the weights in L1 took the
// 32768 x 192 pass from 252 to 217 ms only. So the cost was the
// instructions each warp spent per k step more than the L2 bytes.
//
// What this design does about it:
//   * the host packs each layer's W^T once (ops/fused_render.pack_ring):
//     per k-slice of 8 input rows, the TF32 high parts then the low parts,
//     each in the K-major no-swizzle layout of a wgmma B operand (core
//     matrices of 8 outputs x 4 inputs, 128 B; the two k halves of an
//     8-output group side by side: LBO 128 B, SBO 256 B), so a ring stage
//     is one contiguous block that one cp.async.bulk fills, with no tensor
//     map. The producer thread walks the layers in the consumers' order,
//     tile after tile, on full/empty mbarriers; no consumer thread spends
//     an instruction on the weights, and each weight byte leaves L2 once a
//     128-point tile (39.7 KB a flagship point, against 158.7 KB);
//   * a consumer warpgroup's k step is three wgmma m64nNk8 (lo x hi,
//     hi x lo, hi x hi; N the layer's output width rounded up to 8, 16,
//     32, 64, 128 or 256) with A from registers: each thread loads its four
//     activations of the step from shared memory and splits them with
//     cvt.rna.tf32 as split() does. A step's A registers are rewritten
//     only after the last step's products are done (wait_group 0: an
//     in-flight wgmma's registers must not be touched; with wait_group 1
//     the N = 256 layers came out wrong), so the two warpgroups take turns
//     on the tensor cores;
//   * activations stay fp32, feature-major [row][64 points] a warpgroup,
//     rows XOR-swizzled (point p of row k at p ^ 8 (k & 3)) so the A loads
//     hit 32 banks; a layer's output is written over its input rows once
//     the warpgroup's last product of the layer is done: a warp reads and
//     writes only its own 16 points, so no barrier is needed between
//     layers;
//   * the semantic head's sem_1 and the rgb head are formed from the
//     accumulators of sem_0 and views in registers (a row of an m64
//     accumulator lies in one quad: two shuffles), so neither hidden layer
//     is written to shared memory; sem_in's h columns are written from the last trunk
//     layer's accumulators; the alpha head (one output) is a SIMT dot
//     product over h in shared memory.
// Shared memory (flagship): two warpgroup tiles of emb 64, demb 32 and
// h 256 rows x 64 points (176 KB), the composite strip (12 KB at S = 192,
// 16 KB at S = 64), two 16 KB ring stages (up to four where they fit),
// the barriers: 220-224 KB of 227 (ops/fused_render._wg_plan). Two stages
// keep the consumers waiting on the ring 5% of the tile loop (wgclock).
// Registers: a CTA of 384 threads (the producer's warpgroup is whole, as
// setmaxnreg works by warpgroups) gets 168 a thread at launch; setmaxnreg
// takes the producers to 40 and the consumers to 232, room for the 128
// accumulators of an N = 256 layer (at 168 ptxas serialised the wgmma and
// spilled 734 B).
// K1 runs it in a sigma-only mode (wg_forward_tile's kInSigma: od [R, 6],
// the trunk's layers alone through the ring, the alpha head), K9 and K10a
// in a mip mode (kInMip: odvr [R, 10] and fenceposts [R, S + 1]; each
// warpgroup builds its 64 intervals' cone-frustum Gaussians in six scratch
// rows of its h tile, which nothing reads before the first trunk layer
// overwrites them, and from them the integrated PE in emb, 6 multires rows
// in ipe_rows' order; the rest is K4's tile without the semantic head).
// K3's, K6's and K10b's forward (train_render.cu train_forward_wg_kernel;
// K10b's in the mip mode) run the same tile in its store mode
// (wg_forward_tile's kStore): every activation their reverse sweep reads
// also goes from the epilogues' registers to the CTA's workspace, in
// train_sweep.cuh's [row][kLd] planes of 64 points (sub 2 t + w for
// warpgroup w of tile t), and emb and demb are copied out unswizzled once a
// tile; K4's instantiation compiles none of it.
// The field kernels (fused_field.cu field_wg_kernel: K8a/K8e, K8b/K8d, K11)
// run it in its point-list modes (kInListSigma, kInList, kInListGauss):
// point q of the tile is row q of the point list's pts [n, 3] (K11: the
// Gaussian of row q of mean and cov [n, 3], straight into h's scratch rows
// as the mip mode's), seen from row q of dirs; there is no composite. The
// alpha thread writes each point's sigma straight to its column of the
// output rows, the other heads go to a strip of the tile's 128 points (3 +
// sem floats a point: rgb logits, semantics), and each warpgroup copies its
// 64 points' rows out after its last head (one warpgroup barrier). The
// field backward's forward (fused_field.cu field_bwd_forward_kernel: K8c/
// K8f) runs the store mode with the point-list input (kStore, kInList): the
// workspace planes of K6's forward, no alpha head and no output rows.
// Precision: fp32 activations, 3xTF32 products (both operands split into
// TF32 high and low parts), the PE phases with explicit round-to-nearest
// (no fast-math).
//
// The bf16 mode (--compute_dtype bfloat16; kBf16: K1, K2 and K4,
// train_render_wg_kernel<kInSigma | kInPoint, true>, K9 and K10a,
// train_render_wg_kernel<kInMip, true>, K3's, K6's and K10b's storing
// forward, train_forward_wg_kernel<kLoss | kCotangent, kInPoint | kInMip,
// true>, the field forwards, fused_field.cu field_wg_kernel<kInListSigma |
// kInList | kInListGauss, true>, and K8c/K8f's storing forward,
// field_bwd_forward_kernel<kSem, kInGrad, true>) computes what the JAX
// kernels compute at bf16 (nerfsos_tpu/ops/pallas/fused_render.py
// _render_kernel, _sigma_weights_kernel, _train_render_kernel,
// _train_render_bwd_kernel's forward, _mip_render_kernel, _mip_train_kernel
// and _mip_train_bwd_kernel's forward; fused_field.py's six field kernels
// and _field_kernel_pl with ipe, with compute_dtype bfloat16): every
// product's operands rounded to bf16 (to nearest even), the product
// accumulated in fp32, the fp32 bias added; the storing forward keeps the
// rounded activations (h and the workspace planes hold bf16 values in
// fp32). The field forward's twins differ at bf16: K8d (_field_kernel_pl)
// rounds the heads' hidden activations s and hv before sem_1 and rgb, K8b
// (_field_kernel) keeps them in fp32 (an fp32 x bf16 dot promotes to fp32),
// so field_wg_kernel<kInList, true> takes the rule as kHeadF32.
//   * the host packs each layer's W^T in bf16 (ops/fused_render.pack_ring
//     with bf16): a k step is 16 input rows, one k16 slice of 32 N bytes
//     (half a TF32 stage) in wgmma's K-major no-swizzle layout with
//     TF32's LBO and SBO, and one wgmma m64nNk16 bf16 takes the place of
//     the three m64nNk8 TF32 products;
//   * the activations stay fp32 in shared memory, as in fp32 mode, and each
//     thread rounds its A operands as it loads them (cvt.rn.bf16x2.f32):
//     the PE, computed in fp32, is rounded after its sin, as JAX rounds
//     emb (the mip modes' integrated PE after its exact fp32 exp and sin,
//     as JAX rounds _ipe_in_kernel_pl's rows), and a relu output, feat and
//     the view PE before the product that reads them, so the rounding lands
//     where JAX's .astype(bf16) does. The mip modes' 60-row embedding pads
//     to 64 rows (zeroed by wg_cta) and the skip layer's 60 + 256 inputs to
//     64 + 256, both whole k16 steps, as K2's 63-row one does.
//     Within a k step, k position 2 t + e + 8 h holds input row 8 h + t +
//     4 e (pack_ring's row order), so a thread's loads are fp32 mode's four
//     bank-free loads of two 8-row steps;
//   * the heads formed in registers round sem_0's relu output before sem_1,
//     views' before rgb (not under kHeadF32), and their weights; the alpha
//     head (SIMT) reads h and W_alpha rounded; sem_in is stored in bf16
//     (K4).
#pragma once

#include <type_traits>

#include "train_sweep.cuh"

constexpr int kMaxRingStages = 4;

namespace {

constexpr int kWgPts = 64;               // points a consumer warpgroup
constexpr int kWgTile = 2 * kWgPts;      // points a tile
constexpr int kWgConsumers = 256;        // threads of the two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup

// wg_forward_tile's inputs: kInPoint (K4, K2, K3's and K6's forward) the
// points o + d z of odv [R, 9] and z [R, S] and their PE; kInSigma (K1) the
// same points of od [R, 6], the trunk and the alpha head alone; kInMip (K9,
// K10a, K10b's forward) the intervals between the fenceposts z [R, S + 1]
// of odvr [R, 10] as Gaussians and their integrated PE. The point-list
// modes (the field kernels, PointList): kInList (K8b/K8d) rows of pts and
// dirs [n, 3], kInListSigma (K8a/K8e) rows of pts alone, the trunk and the
// alpha head; kInListGauss (K11) the Gaussians of rows of mean and cov
// [n, 3] and their integrated PE, seen from rows of dirs.
enum InMode { kInPoint, kInSigma, kInMip, kInList, kInListSigma, kInListGauss };

// A point-list mode's rows (each pointer at the CTA's first point): point
// q's inputs are row q of pts (kInListGauss: the means) and cov [n, 3] (the
// diagonal covariances) and of dirs [n, 3] (kInListSigma: not read); its
// outputs go to row q of out [n, C]: sigma [n] (C = 1, kInListSigma) or raw
// [n, 4 + sem] (rgb logits 0-2, sigma 3, semantics 4..).
struct PointList {
  const float* pts;
  const float* cov;
  const float* dirs;
  float* out;
  int C;
};

// row k, point p of a warpgroup tile
__device__ __forceinline__ int swz(int k, int p) { return k * kWgPts + (p ^ ((k & 3) << 3)); }

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Rows [k][64 points] of a warpgroup tile that a layer reads, k a multiple of 8.
struct ASeg {
  const float* a;
  int k;
};

// The consumers' view of the ring: stage pos (counted over the whole CTA's
// run) lies in slot pos % nst, and its fill completes phase (pos / nst) & 1
// of that slot's full barrier.
struct WgRing {
  float* stages;
  uint64_t* full;
  uint64_t* empty;
  int nst, stage_floats;
};

// Where a layer's output goes. Layer mode (h set): rows n < N of h get
// act(acc + b) (relu or not) and, with semin set (the last trunk layer),
// sem_in's h columns of each valid point, semin + (point - qw) * C + n for
// n < hn. Head mode (h null): head's outputs over relu(acc + b) go to
// strip[(q - qw) * cs + col0 ..] for the valid points q of the warpgroup
// (strip: the row of the warpgroup's first point qw). With
// plane set (wg_layer's kStore: the train kernels' storing forward), the
// layer's output of all 64 points also goes to plane[n * kLd + point],
// rows n < prow, a workspace tile in the layout train_reverse_kernel
// reads: in layer mode each warp copies its 16 points of each row from h
// once its epilogue is done (float4 copies: 152.3 against 178.5 ms for
// K6's forward at 32768 x 192 with the epilogue's scalar stores, H100,
// tools/tile_probe.py); in head mode, where nothing is written to h, the
// epilogue writes the hidden activation relu(acc + b) itself.
struct WgOut {
  float* h;
  bool relu;
  void* semin;  // float, or bf16 in the bf16 mode
  int C, hn;
  LayerDesc head;
  float* strip;
  int cs, col0, qw, nq;
  float* plane;
  int prow;
};

// One layer for a consumer warpgroup: acc[point][n] = sum over the
// segments' rows k (in order) of a[k][point] W^T[k][n], k step by k step as
// the ring delivers W^T's k-slices, then the epilogue of o. Returns the
// ring position after the layer's stages. kStore: o.plane may be set.
// kBf16: the bf16 mode, a k step of 16 rows (two 8-row steps of the
// segments, the second zero past their last row) on one bf16 wgmma, the
// heads' hidden activations and weights rounded to bf16, sem_in in bf16;
// with kStore the layer mode's outputs rounded to bf16 in h and the plane.
// kHeadF32 (K8b's rule, the bf16 forward alone): the heads' hidden
// activation enters the head's product unrounded, its weights rounded (the
// row-major JAX kernel multiplies its fp32 s and hv by bf16 weights).
template <int N, bool kStore, bool kBf16 = false, bool kHeadF32 = false>
__device__ __forceinline__ int wg_layer(const float* __restrict__ params, const LayerDesc L,
                                        ASeg s0, ASeg s1, ASeg s2, const WgRing rg, int pos,
                                        const WgOut o) {
  static_assert(!kHeadF32 || (kBf16 && !kStore), "K8b's head rule is the bf16 forward's");
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * w + g;  // the thread's accumulator rows: points m0 and m0 + 8
  // A fragment: a0 (point m0, k t), a1 (m0 + 8, t), a2 (m0, t + 4), a3 (m0 + 8, t + 4)
  const int o0 = t * kWgPts + (m0 ^ (t << 3)), o1 = t * kWgPts + ((m0 + 8) ^ (t << 3));
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int n1 = s0.k / 8, n2 = n1 + s1.k / 8, n8 = n2 + s2.k / 8;
  const int nsteps = kBf16 ? (n8 + 1) / 2 : n8;
  auto load = [&](int ks, float (&v)[4]) {
    const float* a = ks < n1   ? s0.a + ks * 8 * kWgPts
                     : ks < n2 ? s1.a + (ks - n1) * 8 * kWgPts
                               : s2.a + (ks - n2) * 8 * kWgPts;
    v[0] = a[o0];
    v[1] = a[o1];
    v[2] = a[o0 + 4 * kWgPts];
    v[3] = a[o1 + 4 * kWgPts];
  };
  int slot = pos % rg.nst;
  uint32_t phase = (pos / rg.nst) & 1;
  // kBf16: k position 2 t + e + 8 h of a k step is row 8 h + t + 4 e of its
  // 16, so raw and raw2 hold 8-row steps 2 ks and 2 ks + 1 as fp32 mode
  // loads them (raw2 zero past the segments' last row)
  float raw[4], raw2[4] = {0.f, 0.f, 0.f, 0.f};
  load(0, raw);
  if (kBf16 && n8 > 1) load(1, raw2);
  for (int ks = 0; ks < nsteps; ++ks) {
    // the A operands are written only once the last step's products are
    // done (reading an in-flight wgmma's registers is undefined); the next
    // step's activations are loaded as plain floats meanwhile
    uint32_t ahi[4], alo[4];
    if constexpr (kBf16) {  // ahi: the bf16 pairs, point m0 (rows t, t + 4), point m0 + 8
      ahi[0] = bf16x2(raw[0], raw[2]);
      ahi[1] = bf16x2(raw[1], raw[3]);
      ahi[2] = bf16x2(raw2[0], raw2[2]);
      ahi[3] = bf16x2(raw2[1], raw2[3]);
      if (ks + 1 < nsteps) {
        load(2 * ks + 2, raw);
        if (2 * ks + 3 < n8) {
          load(2 * ks + 3, raw2);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) raw2[i] = 0.f;
        }
      }
    } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(raw[i], ahi[i], alo[i]);
    if (ks + 1 < nsteps) load(ks + 1, raw);
    }
    while (!mbar_try_wait(rg.full + slot, phase)) {
    }
    const float* b = rg.stages + (size_t)slot * rg.stage_floats;
    const uint64_t bhi = b_desc(b), blo = b_desc(b + N * 8);
    wgmma_fence();
    if constexpr (kBf16) {
      WgmmaBf16<N>::mma(acc, ahi, bhi);
    } else {
    Wgmma<N>::mma(acc, alo, bhi);
    Wgmma<N>::mma(acc, ahi, blo);
    Wgmma<N>::mma(acc, ahi, bhi);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(rg.empty + slot);  // the stage is free
    if (++slot == rg.nst) {
      slot = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  pos += nsteps;

  // accumulator i: point m0 + 8 ((i >> 1) & 1), output 8 (i >> 2) + 2 t + (i & 1)
  const float* __restrict__ bias = params + L.b;
  const int ldn = pad8(L.n);
  if (o.h) {
    // sem_in's type: bf16 in the bf16 mode (a float stored to it rounds to nearest even)
    using SemT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
    SemT* semin = static_cast<SemT*>(o.semin);
    SemT* ra = semin && o.qw + m0 < o.nq ? semin + (size_t)m0 * o.C : nullptr;
    SemT* rb = semin && o.qw + m0 + 8 < o.nq ? semin + (size_t)(m0 + 8) * o.C : nullptr;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = n < ldn ? __ldg(bias + n) : 0.f, b1 = n < ldn ? __ldg(bias + n + 1) : 0.f;
      float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
      if (o.relu) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
      }
      if (kStore && kBf16) {  // h and the workspace hold the bf16 activations JAX keeps
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = bf16r(v[i]);
      }
      o.h[swz(n, m0)] = v[0];
      o.h[swz(n + 1, m0)] = v[1];
      o.h[swz(n, m0 + 8)] = v[2];
      o.h[swz(n + 1, m0 + 8)] = v[3];
      if (ra && n < o.hn) ra[n] = v[0];
      if (ra && n + 1 < o.hn) ra[n + 1] = v[1];
      if (rb && n < o.hn) rb[n] = v[2];
      if (rb && n + 1 < o.hn) rb[n + 1] = v[3];
    }
    __syncwarp();
    if (kStore && o.plane) {  // the warp's 16 points of each row, unswizzled from h
      for (int i = lane; i < o.prow * 4; i += 32) {
        const int k = i >> 2, p = 16 * w + 4 * (i & 3);
        *reinterpret_cast<float4*>(o.plane + k * kLd + p) =
            *reinterpret_cast<const float4*>(o.h + swz(k, p));
      }
    }
    return pos;
  }
  const LayerDesc H = o.head;  // W^T [ldn][pad8(H.n)] fp32, H.n <= kMaxSem
  const float* __restrict__ wt = params + H.w;
  const int ldo = pad8(H.n);
  float s[kMaxSem][2];
#pragma unroll
  for (int c = 0; c < kMaxSem; ++c) s[c][0] = s[c][1] = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      if (n < ldn) {
        const float b = __ldg(bias + n);
        float va = fmaxf(acc[4 * j + e] + b, 0.f), vb = fmaxf(acc[4 * j + 2 + e] + b, 0.f);
        if (kBf16 && !kHeadF32) {  // JAX rounds the hidden activation before the head's product
          va = bf16r(va);
          vb = bf16r(vb);
        }
        if (kStore && o.plane) {
          o.plane[n * kLd + m0] = va;
          o.plane[n * kLd + m0 + 8] = vb;
        }
#pragma unroll
        for (int c = 0; c < kMaxSem; ++c)
          if (c < H.n) {
            const float wv = kBf16 ? bf16r(__ldg(wt + n * ldo + c)) : __ldg(wt + n * ldo + c);
            s[c][0] = fmaf(va, wv, s[c][0]);
            s[c][1] = fmaf(vb, wv, s[c][1]);
          }
      }
    }
#pragma unroll
  for (int c = 0; c < kMaxSem; ++c)
    if (c < H.n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[c][r] += __shfl_xor_sync(0xffffffffu, s[c][r], 1);
        s[c][r] += __shfl_xor_sync(0xffffffffu, s[c][r], 2);
      }
    }
  if (t == 0) {
    const bool va = o.qw + m0 < o.nq, vb = o.qw + m0 + 8 < o.nq;
    for (int c = 0; c < H.n; ++c) {
      const float bc = __ldg(params + H.b + c);
      if (va) o.strip[m0 * o.cs + o.col0 + c] = s[c][0] + bc;
      if (vb) o.strip[(m0 + 8) * o.cs + o.col0 + c] = s[c][1] + bc;
    }
  }
  return pos;
}

// wg_layer at the layer's ring width N (pack_ring's: 8, 16, 32, 64, 128 or 256)
template <bool kStore, bool kBf16 = false, bool kHeadF32 = false>
__device__ __forceinline__ int wg_layer_n(int N, const float* __restrict__ params,
                                          const LayerDesc L, ASeg s0, ASeg s1, ASeg s2,
                                          const WgRing rg, int pos, const WgOut& o) {
  switch (N) {
    case 256: return wg_layer<256, kStore, kBf16, kHeadF32>(params, L, s0, s1, s2, rg, pos, o);
    case 128: return wg_layer<128, kStore, kBf16, kHeadF32>(params, L, s0, s1, s2, rg, pos, o);
    case 64: return wg_layer<64, kStore, kBf16, kHeadF32>(params, L, s0, s1, s2, rg, pos, o);
    case 32: return wg_layer<32, kStore, kBf16, kHeadF32>(params, L, s0, s1, s2, rg, pos, o);
    case 16: return wg_layer<16, kStore, kBf16, kHeadF32>(params, L, s0, s1, s2, rg, pos, o);
    default: return wg_layer<8, kStore, kBf16, kHeadF32>(params, L, s0, s1, s2, rg, pos, o);
  }
}

// The ring's layers in the consumers' order: the trunk, then with heads
// sem_0 (with the semantic head), feature, views. Returns their count.
__device__ __forceinline__ int ring_order(const MLPDesc& f, int (&order)[kMaxLayers],
                                          bool heads) {
  int nl = 0;
  for (int i = 0; i < f.depth; ++i) order[nl++] = i;
  if (!heads) return nl;
  if (f.sem_dim) order[nl++] = f.depth + 4;
  order[nl++] = f.depth + 1;
  order[nl++] = f.depth + 2;
  return nl;
}

// The producer (one thread): every k-slice of every ring layer (heads:
// ring_order's), tile after tile, each into the next free stage by one bulk
// copy. kBf16: a slice is 16 rows of bf16 (32 n bytes, 8 n words of ring).
template <bool kBf16 = false>
__device__ __forceinline__ void ring_producer(const float* __restrict__ ring, const MLPDesc& f,
                                              const RingDesc& rd, const WgRing rg, int ntiles,
                                              bool heads) {
  int order[kMaxLayers];
  const int nl = ring_order(f, order, heads);
  int slot = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    for (int l = 0; l < nl; ++l) {
      const int li = order[l], n = rd.ncols[li];
      const int nsl = kBf16 ? (f.layer[li].k / 8 + 1) / 2 : f.layer[li].k / 8;
      // 8 rows x n outputs x {hi, lo} x 4 B; bf16: 16 rows x n outputs x 2 B
      const uint32_t bytes = kBf16 ? n * 32 : n * 64;
      const float* src = ring + rd.off[li];
      for (int s = 0; s < nsl; ++s) {
        while (!mbar_try_wait(rg.empty + slot, phase ^ 1)) {
        }
        mbar_expect_tx(rg.full + slot, bytes);
        bulk_g2s(rg.stages + (size_t)slot * rg.stage_floats, src + (size_t)s * (bytes / 4), bytes,
                 rg.full + slot);
        if (++slot == rg.nst) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
}

// A CTA of the 128-point tile (K4's kernel, K3's, K6's and K10b's forward,
// the field kernels): its dynamic shared memory holds the ring's barriers
// (128 B), rd.stages ring stages, the two warpgroups' emb, demb and h tiles
// and the composite strip (a point-list mode's: the tile's heads).
struct WgCta {
  WgRing rg;
  float* tiles;  // warpgroup w's emb, demb and h at tiles + w * per_wg
  float* strip;
  int per_wg;
};

// Lays out raw, initialises the ring's barriers and zeroes the padding rows
// of emb and demb, which nothing else writes; the caller synchronises.
__device__ __forceinline__ WgCta wg_cta(unsigned char* raw, const MLPDesc& f,
                                        const RingDesc& rd) {
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);
  uint64_t* empty = full + kMaxRingStages;
  float* stages = reinterpret_cast<float*>(raw + 128);
  const int Ep = pad8(f.emb_dim), Edp = pad8(f.demb_dim);
  const int per_wg = (Ep + Edp + rd.hrows) * kWgPts;
  float* tiles = stages + (size_t)rd.stages * rd.stage_floats;
  if (threadIdx.x == 0) {
    for (int i = 0; i < rd.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWgConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 2 * kWgPts) {
    float* mine = tiles + (threadIdx.x / kWgPts) * per_wg;
    const int p = threadIdx.x % kWgPts;
    for (int k = f.emb_dim; k < Ep; ++k) mine[swz(k, p)] = 0.f;
    for (int k = f.demb_dim; k < Edp; ++k) mine[Ep * kWgPts + swz(k, p)] = 0.f;
  }
  return WgCta{WgRing{stages, full, empty, rd.stages, rd.stage_floats}, tiles,
               tiles + 2 * per_wg, per_wg};
}

// After the CTA's barrier: warps 8-11, the producer warpgroup, give up
// their registers (setmaxnreg 40) and one thread streams ntiles tiles'
// weights (ring_producer; heads false: the trunk's alone), and get false;
// warps 0-7, the two consumer warpgroups, take 232 registers a thread (the
// 128 accumulators of an N = 256 layer) and get true. kBf16: the ring's
// bf16 slices (ring_producer<true>).
template <bool kBf16 = false>
__device__ __forceinline__ bool wg_consumer(const float* __restrict__ ring, const MLPDesc& f,
                                            const RingDesc& rd, const WgRing rg, int ntiles,
                                            bool heads = true) {
  if (threadIdx.x >= kWgConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kWgConsumers) ring_producer<kBf16>(ring, f, rd, rg, ntiles, heads);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  return true;
}

// Rows 3.. of a warpgroup's PE buffer whose rows 0-2 hold x: sin(2^b x_c +
// h pi/2) in row 3 + 6 b + 3 h + c (core/encoding.py's column order), the
// phase rounded once an operation (train_sweep.cuh pe_grads rounds it
// alike), in a swizzled tile.
__device__ __forceinline__ void pe_rows_wg(float* buf, int rows) {
  for (int i = threadIdx.x & 127; i < (rows - 3) * kWgPts; i += 128) {
    const int f = i / kWgPts, p = i % kWgPts;
    const int band = f / 6, r = f % 6, c = r % 3;
    const float phase = (r >= 3) ? 1.57079632679489661923f : 0.f;
    const float freq = ldexpf(1.f, band);
    buf[swz(3 + f, p)] = sinf(__fadd_rn(__fmul_rn(freq, buf[swz(c, p)]), phase));
  }
}

// Rows 0 .. rows - 1 (rows = 6 multires) of a warpgroup's integrated-PE
// tile from the Gaussians' means (rows 0-2 of the tile g) and variances
// (rows 3-5): ipe_rows's values, row order and rounding in swizzled tiles.
__device__ __forceinline__ void ipe_rows_wg(float* buf, const float* g, int rows) {
  const int half = rows / 2;
  for (int i = threadIdx.x & 127; i < rows * kWgPts; i += 128) {
    const int f = i / kWgPts, p = i % kWgPts;
    const int k = f % half, c = k % 3;
    const float freq = ldexpf(1.f, k / 3);
    const float y = __fmul_rn(freq, g[swz(c, p)]);
    const float yv = __fmul_rn(__fmul_rn(freq, freq), g[swz(3 + c, p)]);
    const float s = sinf(f >= half ? __fadd_rn(y, 1.57079632679489661923f) : y);
    buf[swz(f, p)] = __fmul_rn(expf(__fmul_rn(-0.5f, yv)), s);
  }
}

// Rows [0, rows) of a warpgroup tile, unswizzled, to a workspace tile
// [rows][kLd] (kBf16: each value rounded to bf16, as JAX keeps emb and the
// view PE).
template <bool kBf16>
__device__ __forceinline__ void wg_store_rows(const float* src, float* dst, int rows) {
  for (int i = threadIdx.x & 127; i < rows * (kWgPts / 4); i += 128) {
    const int k = i / (kWgPts / 4), p = (i % (kWgPts / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(src + swz(k, p));
    if (kBf16) v = make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
    *reinterpret_cast<float4*>(dst + k * kLd + p) = v;
  }
}

// The forward of tile `tile` of a chunk (rays r0.., S samples a ray, nq
// points; z of the chunk at zc) for the calling consumer warpgroup, its
// points qw .. qw + 63 (qw = 128 tile + 64 warpgroup): their inputs and
// PE, the trunk, alpha, sem_0 and sem_1, feature, views and rgb on the
// warpgroup's emb, demb and h tiles at `mine`; sigma, the rgb logits and
// the semantics of point q go to strip[q * (6 + sem) + 0, 2.., 5..].
// K4 (kStore false): with semin, [h; emb] (the semantic head's input row) to
// semin row base + q. K3/K6 (kStore): every activation the reverse sweep
// reads goes to the workspace slice ws, as sub qw / 64 of its planes
// (train_desc's layout: P_EMB, P_DEMB, P_ACT0 + i, P_FEAT, P_HV, and with
// kSemAct the semantic head's hidden activation at P_ACT0 + depth); a
// warpgroup whose points all lie past nq has no sub and stores nothing.
// kIn (InMode): kInSigma (K1): odv is od [R, 6] (no view direction), and
// the tile runs the trunk and the alpha head alone (sigma to the strip),
// nothing else. kInMip (K9, K10a): odv is odvr [R, 10] and zc the chunk's
// fenceposts [nr][S + 1]; point q is the interval (zc[r][s], zc[r][s + 1])
// of ray r0 + r (r = q / S, s = q % S), its Gaussian (frustum_gauss)
// in rows 0-5 of h, then its integrated PE in emb's rows 0 .. E - 1.
// The point-list modes (kInList, kInListSigma, kInListGauss; odv, zc and
// semin null, nq the CTA's points): point q's inputs are row q of pl's
// lists, its sigma goes straight to its column of out (kInListSigma: the
// only output), its rgb logits and semantics to strip[(q - 128 tile) (3 +
// sem) + 0.., 3..], and after the last head each warpgroup copies its
// points' rows out (rgb logits, sigma, semantics: raw's column order).
// With kStore (the field backward's forward, kInList alone) a point-list
// mode writes no outputs: the alpha head is skipped, pl.out is not read.
// kBf16 (K1, K2, K4, K9, K10a at --compute_dtype bfloat16: kInPoint, kInSigma
// or kInMip; K3's, K6's and K10b's storing forward: kStore, kInPoint or
// kInMip; the field forwards: kInListSigma, kInList, kInListGauss; K8c/K8f's
// storing forward: kStore, kInList): the bf16 mode (wg_layer's),
// the alpha head on h and W_alpha rounded to bf16, sem_in a bf16 array; in
// the store mode every stored activation is its bf16 value (JAX's ins[i],
// acts[i], feat, hv, s_act, emb and the view PE), but for the point-list
// store mode's emb and view PE, kept in fp32: the reverse sweep's products
// round them as they read them, and K8c's chain rule (pe_grads) reads the
// exact points and directions in their rows 0-2, as JAX forms its phases
// from the fp32 inputs. kHeadF32 (kInList's bf16 forward alone): K8b's head
// rule (wg_layer's). Returns the ring position after the tile.
template <bool kStore, bool kSemAct, int kIn = kInPoint, bool kBf16 = false,
          bool kHeadF32 = false>
__device__ __forceinline__ int wg_forward_tile(
    const float* __restrict__ odv, const float* zc, int r0, int S, int nq, int tile,
    const float* __restrict__ params, const TrainDesc& d, const RingDesc& rd, const WgRing rg,
    int pos, float* mine, float* strip,
    typename std::conditional<kBf16, __nv_bfloat16, float>::type* __restrict__ semin,
    long long base, float* ws, const PointList pl = PointList{}) {
  static_assert(!kBf16 || !kStore || kIn == kInPoint || kIn == kInMip || kIn == kInList,
                "the storing forward's bf16 mode is K3's, K6's, K10b's and K8c/K8f's");
  static_assert(!kHeadF32 || (kBf16 && !kStore && kIn == kInList),
                "K8b's head rule is the bf16 field forward's");
  constexpr bool kSigma = kIn == kInSigma || kIn == kInListSigma;
  constexpr bool kGauss = kIn == kInMip || kIn == kInListGauss;
  constexpr bool kList = kIn >= kInList;
  constexpr bool kOut = kList && !kStore;  // a point-list mode's output rows
  const MLPDesc& f = d.f;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, bar = 1 + wg;
  const int depth = f.depth, E = f.emb_dim, Ep = pad8(E), Ed = f.demb_dim, Edp = pad8(Ed);
  const int sem = f.sem_dim, cs = kList ? 3 + sem : 6 + sem;
  float* emb = mine;
  float* demb = emb + Ep * kWgPts;
  float* h = demb + Edp * kWgPts;
  const int qw = tile * kWgTile + wg * kWgPts;
  float* wstrip = strip + (size_t)(kList ? wg * kWgPts : qw) * cs;  // the warpgroup's first point
  const LayerDesc* head = f.layer + depth;  // alpha, feature, views, rgb, sem_0, sem_1
  const bool store = kStore && qw < nq;
  const int sub = qw / kWgPts;

  wg_bar(bar);  // the last tile's reads of emb, demb and h are done
  for (int i = tid; i < 3 * kWgPts; i += 128) {
    const int ch = i / kWgPts, p = i % kWgPts, q = qw + p;
    float x = 0.f, var = 0.f, v = 0.f;
    if (q < nq) {
      if (kList) {
        const size_t e = (size_t)q * 3 + ch;
        x = pl.pts[e];
        if (kGauss) var = pl.cov[e];
        if (!kSigma) v = pl.dirs[e];
      } else if (kIn == kInMip) {
        const int r = q / S, s = q % S;
        const float* ray = odv + (size_t)(r0 + r) * 10;
        const float* zr = zc + (size_t)r * (S + 1);
        frustum_gauss(ray, zr[s], zr[s + 1], ch, x, var);
        v = ray[6 + ch];
      } else {
        const float* ray = odv + (size_t)(r0 + q / S) * (kSigma ? 6 : 9);
        x = __fadd_rn(ray[ch], __fmul_rn(ray[3 + ch], zc[q]));
        if (!kSigma) v = ray[6 + ch];
      }
    }
    if (kGauss) {  // the Gaussian in h's scratch rows: means 0-2, variances 3-5
      h[swz(ch, p)] = x;
      h[swz(3 + ch, p)] = var;
    } else {
      emb[swz(ch, p)] = x;
    }
    if (!kSigma) demb[swz(ch, p)] = v;
  }
  wg_bar(bar);
  if (kGauss) {
    ipe_rows_wg(emb, h, E);
  } else {
    pe_rows_wg(emb, E);
  }
  if (!kSigma) pe_rows_wg(demb, Ed);
  wg_bar(bar);  // emb is whole (and h's scratch rows read) before layer 0
  if (store) {
    wg_store_rows<kBf16 && !kList>(emb, plane(ws, d, P_EMB, sub), Ep);
    wg_store_rows<kBf16 && !kList>(demb, plane(ws, d, P_DEMB, sub), Edp);
  }

  // the ring's layers in order (ring_order): the trunk, each output over h;
  // sem_0 on [h; emb] with sem_1 from its accumulators; feature over h;
  // views with rgb from its accumulators. One call site, so the whole tile
  // is one function and ptxas keeps the wgmma pipeline.
  const ASeg none{nullptr, 0};
  const int hn = f.layer[depth - 1].n, hoff = f.skip == depth - 1 ? E : 0;
  const int C = hoff + hn + (f.sem_with_coord ? E : 0);
  int order[kMaxLayers];
  const int nl = ring_order(f, order, !kSigma);
  ASeg in0{emb, Ep}, in1 = none;
  for (int l = 0; l <= nl; ++l) {
    if (l == depth) {
      wg_bar(bar);  // h is whole: the reads below cross warps
      // sem_in's emb columns, then the alpha head (a thread a point)
      if (!kStore && semin != nullptr) {
        const int np = min(kWgPts, nq - qw);
        for (int part = 0; part < 2; ++part) {
          if (part == 0 ? hoff == 0 : !f.sem_with_coord) continue;
          const int off = part == 0 ? 0 : hoff + hn;
          for (int e = tid; e < np * E; e += 128) {
            const int p = e / E, c = e % E;
            semin[(base + qw + p) * C + off + c] = emb[swz(c, p)];  // bf16: rounded
          }
        }
      }
      if (!(kList && kStore) && tid < kWgPts && qw + tid < nq) {
        const ASeg segs[2] = {in0, in1};
        const float* __restrict__ wcol = params + head[0].w;
        float acc = 0.f;
#pragma unroll
        for (int sg = 0; sg < 2; ++sg)
          for (int k = 0; k < segs[sg].k; ++k, wcol += 8) {
            if (kBf16) {
              acc = fmaf(bf16r(segs[sg].a[swz(k, tid)]), bf16r(__ldg(wcol)), acc);
            } else {
              acc = fmaf(segs[sg].a[swz(k, tid)], __ldg(wcol), acc);
            }
          }
        acc += __ldg(params + head[0].b);
        if (kOut) {
          pl.out[(size_t)(qw + tid) * pl.C + (kSigma ? 0 : 3)] = acc;
        } else {
          wstrip[tid * cs] = acc;
        }
      }
      wg_bar(bar);  // before feature's output overwrites h
    }
    if (l == nl) break;
    const int li = order[l];
    WgOut o{};
    o.strip = wstrip;
    o.cs = cs;
    o.qw = qw;
    o.nq = nq;
    ASeg a0 = in0, a1 = in1, a2 = none;
    int out = -1;  // the layer's workspace plane (kStore)
    if (l < depth || li == depth + 1) {  // trunk, feature
      o.h = h;
      o.relu = l < depth;
      out = l < depth ? P_ACT0 + l : P_FEAT;
      if (!kStore && l == depth - 1 && semin != nullptr) {
        o.semin = semin + (base + qw) * C + hoff;
        o.C = C;
        o.hn = hn;
      }
    } else if (li == depth + 4) {  // sem_0
      a2 = f.sem_with_coord ? ASeg{emb, Ep} : none;
      o.head = head[5];
      o.col0 = kList ? 3 : 5;
      if (kSemAct) out = P_ACT0 + depth;
    } else {  // views
      a0 = ASeg{h, pad8(head[1].n)};
      a1 = ASeg{demb, Edp};
      o.head = head[3];
      o.col0 = kList ? 0 : 2;
      out = P_HV;
    }
    if (store && out >= 0) {
      o.plane = plane(ws, d, out, sub);
      o.prow = d.rows[out];
    }
    pos = wg_layer_n<kStore, kBf16, kHeadF32>(rd.ncols[li], params, f.layer[li], a0, a1, a2, rg,
                                              pos, o);
    if (l < depth) {
      const ASeg hs{h, pad8(f.layer[l].n)};
      in0 = l == f.skip ? ASeg{emb, Ep} : hs;
      in1 = l == f.skip ? hs : none;
    }
  }
  if (kOut && !kSigma) {  // the warpgroup's rows of out, but sigma, from its strip
    wg_bar(bar);  // every warp's heads are in the strip
    const int C = pl.C, np = min(kWgPts, nq - qw);
    float* out = pl.out + (size_t)qw * C;
    for (int e = tid; e < np * C; e += 128) {
      const int p = e / C, c = e - p * C;
      if (c != 3) out[e] = wstrip[p * cs + (c < 3 ? c : c - 1)];
    }
  }
  return pos;
}

}  // namespace
