// Fused train kernels for Hopper (sm_90a): forward recompute, composite,
// the img2mse cotangent (or given map cotangents) and the full reverse sweep
// of the field MLP, for one pass of rays, plus a deterministic reduction of
// the per-CTA gradients; the SOS finetune's forward and frozen backward; and
// mip-NeRF's eval render, train forward and backward.
//
// Replaces K3 of nerfsos_tpu/ops/pallas/fused_render.py:
//   fused_rgb_train_grads -> _train_render_bwd_kernel with rgb_loss=True.
// From odv [R, 9], z [R, S], gt [R, 3] and a noise seed it writes the
// UNSCALED gradients of sum((rgb_map - gt)^2) for every layer (the caller
// scales by rgb_w / (R * 3)), the maps [R, 5 + sem] and the weights [R, S].
//
// What bounds it on the H100: arithmetic. Per point it does the forward
// (~1.27 MFLOP at the flagship fine shape), the input-gradient products and
// the weight-gradient products (~3x the forward in all); the only traffic
// the function needs is the rays, z and gt in, the maps and weights out and
// one read of the weights and one write of the gradients (~5 MB a field).
//
// What the design does about it (a first version: right before fast):
//   * a grid of about one CTA per SM (512 threads) takes chunks of whole
//     rays (rays_per_chunk = max(1, 512 / S), so ~512 points) in waves of
//     one chunk per CTA, so the composite and its reverse scan stay inside
//     the CTA; per wave a forward kernel and a reverse-sweep kernel run in
//     turn (as one kernel, the layer products of both spilled registers and
//     the whole ran 1.6x slower: H100, 4096 rays x 192 samples, 190 ms vs
//     120 ms);
//   * the activations of a chunk do not fit in shared memory (~3,400 rows
//     of 64-point tiles, ~7.9 MB a CTA at the flagship shape, ~1 GB for the
//     grid), so each CTA keeps them in its own slice of a global workspace,
//     in the same feature-major [row][kLd] tiles the render kernels keep in
//     shared memory, from its forward to its reverse sweep;
//   * the forward and the input-gradient products dX = W dY run on the
//     tensor cores in the 3xTF32 scheme of the render kernels (dense() of
//     tile_mlp.cuh; the weight slices of the reverse sweep are packed on the
//     host, and the relu derivative is applied in the epilogue as a gate on
//     the stored activation). The forward keeps a tile's activations in
//     shared memory as K2 does and stores each to the workspace; the reverse
//     sweep copies each dY tile into shared memory first (cp.async, two
//     stages). The emb rows of the skip
//     input, the view encoding and layer 0 need no input gradient and get
//     none;
//   * dW = X^T dY contracts over the chunk's points: 128 x 128 macro tiles
//     whose X and dY rows stream through two shared-memory stages
//     (cp.async), each warp a 32 x 32 block with m16n8k8 3xTF32 mma, added
//     into the CTA's partial dW in global memory once a chunk. A third
//     kernel sums the partials in a fixed order, so the gradients are
//     deterministic (no atomics);
//   * the semantic head runs forward only: in this loss its cotangent is
//     identically zero, so its gradients are exact zeros (the wrapper writes
//     them) and it adds nothing to dh;
//   * the sigma noise is the TPU kernel's hash: SplitMix-style avalanche of
//     (global point index + seed) in uint32 arithmetic, Box-Muller with
//     log1pf and cosf, so kernel and plain version draw the same values.
// Where the time goes (H100, 4096 rays x 192 samples, clock64 per section):
// the forward and composite ~35%, the input-gradient products ~32%, the dW
// products ~33%; every 64-point tile re-reads each layer's weights from L2.
// Precision: fp32 throughout; the points and the PE phases as in the render
// kernels (explicit round-to-nearest, accurate sinf), no fast-math.
//
// The same file holds the frozen-backbone SOS finetune's two kernels:
//
// K4 (replaces _train_render_fwd_impl -> _train_render_kernel): the train
// forward, K3's forward tile and composite without the loss and without the
// workspace: maps [R, 5 + sem] and weights [R, S] with the hash noise and,
// on request, sem_in [R * S, C] = [h; emb] per point (C = 319 at the
// flagship), written from the activations the tile already holds. It is
// bound by its arithmetic (the forward, ~1.27 MFLOP a fine point); sem_in
// adds C * 4 bytes a point of writes (8.0 GB for the 32768 x 192 fine pass,
// ~2.4 ms at 3.35 TB/s). The JAX package recomputes above an 8 GiB residual
// for a 16 GB TPU; on an 80 GB card sem_in is always stored.
//
// K5 (replaces _train_render_frozen_bwd_impl -> _train_frozen_bwd_kernel):
// the gradients of the semantic head alone, with the composite weights held
// constant, from sem_in, w and the maps' cotangent. Per 64-point tile:
// s_act = relu(sem_in W0 + b0) (3xTF32), d_sem = dmaps[ray, 5:] w,
// ds = (W1^T d_sem) [s_act > 0], and dW1 += s_act^T d_sem, db1, db0, and
// dW0 += sem_in^T ds (m16n8k8 3xTF32, k = points). A CTA takes one block of
// 64 of sem_0's 128 outputs over a run of tiles, so its share of dW0
// (320 x 64) stays in 40 registers a thread; each CTA x writes its share of
// a partial gradient buffer and reduce_partials sums the buffers in CTA
// order: two calls give bitwise-equal gradients. The CTA keeps its block of
// W0^T (320 x 64, fp32) and W1 in shared memory for its whole run of tiles
// and splits them into TF32 parts as it multiplies (sem0_forward): the
// shared tile layer dense(), which reads each k step's W fragments from L2,
// left one n8 tile a warp waiting on those reads most of the time in a
// first version (clock64 counters, H100). Each tile's rows of sem_in are copied by
// cp.async straight into the feature-major tile (4-byte copies, lane =
// column). Bound: reading sem_in (8.0 GB at the fine pass) and the two
// 320 x 128 products (~164 KFLOP a point), about equal on the H100; the two
// blocks each read sem_in once. Shared memory: 230 KB at the flagship's
// 320 padded sem_in rows, the most that fits.
//
// K6 (replaces _train_render_bwd -> _train_render_bwd_kernel with map
// cotangents): the full-backbone SOS finetune's backward, a third mode of
// K3's two kernels. The forward kernel recomputes the chunk as K3 does and
// also stores the semantic head's hidden activation s_act; its composite
// reads the maps' cotangent dmaps [R, 5 + sem] and the weights' cotangent
// dweights [R, S] (null: zero) instead of gt, and forms per point
//   dw = sum_j dmaps[j] rgb_j + dmaps[3] z + dmaps[4] + sum_c dmaps[5 + c] sem_c
//        + dweights,
// then K3's reverse composite for dsigma, d_rgb = dmaps[0:3] w rgb (1 - rgb)
// and d_sem = dmaps[5:] w (a plane of its own). The reverse kernel sweeps
// the semantic head between alpha/feature and the trunk: dW of sem_1 from
// (s_act, d_sem), ds = (W1^T d_sem) [s_act > 0], dW of sem_0 from
// ([h; emb], ds), and W0[:, h]^T ds added into the last trunk layer's
// cotangent before its gate (dense's kAccum). K3's mode runs the sweep it
// ran before. Bound: arithmetic, K3's work plus the semantic head's
// backward (~3.8 MFLOP a flagship point); the extra planes (s_act, d_sem,
// ds: 264 rows a tile) add ~8% to the per-CTA workspace.
//
// mip-NeRF's three kernels are a fourth mode (kMip) of the same kernels:
//   K9   fused_mip_render_planar -> _mip_render_kernel: K4's kernel without
//        noise on odvr [R, 10] (o, d, viewdirs, radius) and fenceposts
//        z [R, S + 1] -> maps [R, 5] (w·rgb x3, w·mid, w) and w [R, S];
//   K10a _mip_train_fwd_impl -> _mip_train_kernel: the same with the noise;
//   K10b _mip_train_bwd -> _mip_train_bwd_kernel: K6's two kernels without
//        the semantic head, from dmaps [R, 5] and dweights [R, S].
// A point is an interval (t0, t1) of its ray. The tile's prologue builds
// the cone frustum's diagonal Gaussian per point (tile_mlp.cuh
// frustum_gauss, the stable closed forms, one rounding per operation so
// the means are the plain version's bit for bit: the integrated PE
// multiplies them by up to 2^9) and its integrated PE (ipe_rows: 60 rows
// at multires 10, padded to 64, no raw-input rows) in place of the point
// PE; the composite takes D = (t1 - t0)·‖d‖ with no far pad and the
// midpoint as the depth, and K10b's cotangent mode reads the midpoint in
// dw. Everything else (the trunk with its [emb, h] skip, the heads, the
// reverse sweep, the CTA-ordered reduction) is K4's and K6's. Bound: the
// same arithmetic as K4 and K6 without the semantic head (~1.18 MFLOP a
// point forward, ~3x that for K10b); the Gaussian and the 60 sin/exp of a
// point are ~1% of it.

#include "tile_mlp.cuh"

constexpr int kMaxPlanes = 10 + kMaxLayers;

// Host-visible: the C entry point takes a TrainDesc*.
struct TrainDesc {
  MLPDesc f;                    // the forward layers (ops/fused_render.pack_field)
  LayerDesc bwd[kMaxLayers];    // dX matrices in bparams, by forward layer index:
                                //   trunk i >= 1: W_i restricted to its h input,
                                //   depth (alpha's slot): [W_feature; W_alpha] on h,
                                //   depth + 2: W_views on the feature input, depth + 3: W_rgb
  long long gw[kMaxLayers];     // offset of dW [k][pad8(n)] in a gradient buffer
  long long gb[kMaxLayers];     // offset of db [pad8(n)]
  long long grad_size;          // floats of one gradient buffer
  long long plane[kMaxPlanes];  // offset of each workspace plane in a CTA's slice
  int rows[kMaxPlanes];         // padded rows of each plane (one [rows][kLd] tile per 64 points)
  long long ws_size;            // floats of a CTA's workspace slice
  int rays_per_chunk;
};

namespace {

// workspace planes
enum Plane { P_EMB, P_DEMB, P_FEAT, P_HV, P_DRGB, P_DSIG, P_DPV, P_DFEAT, P_DA, P_DB, P_ACT0 };

__device__ __forceinline__ float* plane(float* ws, const TrainDesc& d, int p, int sub) {
  return ws + d.plane[p] + (size_t)sub * d.rows[p] * kLd;
}

__device__ __noinline__ void dense_call(const float* __restrict__ params, const LayerDesc L,
                                        Seg s0, Seg s1, Seg s2, float* out, bool relu) {
  dense(params, L, s0, s1, s2, out, relu);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x84ECE28Bu;
  x ^= x >> 16;
  return x;
}

// N(0, std) for global point index idx (= ray * S + sample): the TPU
// kernel's _noise_lanes, bit for bit up to the last ulp of log1pf/cosf.
__device__ __forceinline__ float hash_noise(uint32_t seed, uint32_t idx, float std) {
  const uint32_t h1 = mix32((idx + seed) * 0x9E3779B9u);
  const uint32_t h2 = mix32(h1 + 0x7E3779B9u);
  const float u1 = (float)(h1 >> 8) * 5.9604644775390625e-8f;  // 2^-24
  const float u2 = (float)(h2 >> 8) * 5.9604644775390625e-8f;
  const float r = sqrtf(-2.f * log1pf(-u1));
  return (std * r) * cosf(6.28318530717958f * u2);
}

// One input of a weight-gradient product: up to two planes, in row order.
struct XSegs {
  int p[3];
  int n;
};

constexpr int kWgM = 128, kWgN = 128;  // dW macro tile: 4 x 4 warps of 32 x 32
constexpr int kLdS = 68;               // staged row stride (floats), = 4 mod 32
constexpr int kStageFloats = (kWgM + kWgN) * kLdS;
constexpr int kBwdRows = 256 + 8;      // the most dY rows an input-gradient product reads
constexpr int kBwdStageFloats = kBwdRows * kLd;
// shared memory after the composite strip: two dW stages or two dX stages
constexpr int kStagingFloats =
    2 * (kStageFloats > kBwdStageFloats ? kStageFloats : kBwdStageFloats);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy one 64-point tile of X rows [m0, m0 + 128) and dY rows [n0, n0 + 128)
// into a stage ([256][kLdS]: X rows, then dY rows; rows past kpad / ldn are
// zero), as one cp.async group.
__device__ void stage_tiles(float* stage, float* ws, const TrainDesc& d, XSegs X, int kpad,
                            int dy, int ldn, int m0, int n0, int sub) {
  for (int c = threadIdx.x; c < (kWgM + kWgN) * (kPts / 4); c += kThreads) {
    const int r = c / (kPts / 4), q = (c % (kPts / 4)) * 4;
    float* dst = stage + r * kLdS + q;
    const float* src = nullptr;
    if (r < kWgM) {
      int m = m0 + r;
      if (m < kpad) {
        for (int s = 0; s < X.n; ++s) {
          const int rows = d.rows[X.p[s]];
          if (m < rows) {
            src = ws + d.plane[X.p[s]] + ((size_t)sub * rows + m) * kLd + q;
            break;
          }
          m -= rows;
        }
      }
    } else if (n0 + r - kWgM < ldn) {
      src = ws + d.plane[dy] + ((size_t)sub * d.rows[dy] + n0 + r - kWgM) * kLd + q;
    }
    if (src) {
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out(sub) = W dY(sub) for every 64-point tile of the chunk, gated by the
// relu derivative of gate(sub) when gate >= 0: the input-gradient product
// of one layer. dY is up to two planes of rows (k0 then k1); each tile of
// them is copied into shared memory with cp.async (the next tile in flight
// while this one is multiplied) and dense() reads it from there. kAccum:
// the product is added to what out holds (before the gate).
template <bool kAccum = false>
__device__ __noinline__ void bwd_layer(const float* __restrict__ bparams, const LayerDesc L,
                                       float* ws, const TrainDesc& d, int p0, int p1, int out,
                                       int gate, int nsub, float* stages) {
  const int k0 = d.rows[p0], k1 = p1 >= 0 ? d.rows[p1] : 0;
  auto stage = [&](int sub) {
    float* dst = stages + (sub & 1) * kBwdStageFloats;
    for (int c = threadIdx.x; c < (k0 + k1) * (kPts / 4); c += kThreads) {
      const int r = c / (kPts / 4), q = (c % (kPts / 4)) * 4;
      const float* src = r < k0 ? plane(ws, d, p0, sub) + r * kLd + q
                                : plane(ws, d, p1, sub) + (r - k0) * kLd + q;
      cp_async16(dst + r * kLd + q, src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  for (int sub = 0; sub < nsub; ++sub) {
    if (sub + 1 < nsub) {
      stage(sub + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* a = stages + (sub & 1) * kBwdStageFloats;
    const Seg s1 = k1 ? Seg{a + k0 * kLd, k1} : none();
    if (gate >= 0) {
      dense<true, kAccum>(bparams, L, Seg{a, k0}, s1, none(), plane(ws, d, out, sub), false,
                          plane(ws, d, gate, sub));
    } else {
      dense<false, kAccum>(bparams, L, Seg{a, k0}, s1, none(), plane(ws, d, out, sub), false);
    }
    __syncthreads();
  }
}

// dW[m][n] += sum over the chunk's points of X[m][p] * dY[n][p] and
// db[n] += sum_p dY[n][p], for m < sum of the segments' rows and n < ldn.
// The CTA walks 128 x 128 macro tiles of dW; for each it streams the chunk's
// 64-point tiles of the X and dY rows it needs through two shared-memory
// stages (cp.async, the next tile in flight while this one is multiplied),
// and warp (wm, wn) accumulates its 32 x 32 block with m16n8k8 3xTF32 mma
// (A = X rows, B = dY rows, k = points), then adds it into the CTA's
// partial dW in global memory.
__device__ __noinline__ void wgrad(float* ws, const TrainDesc& d, XSegs X, int dy, int ldn,
                                   float* __restrict__ dW, float* __restrict__ db, int nsub,
                                   float* stages) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  int kpad = 0;
  for (int s = 0; s < X.n; ++s) kpad += d.rows[X.p[s]];
  for (int m0 = 0; m0 < kpad; m0 += kWgM) {
    for (int n0 = 0; n0 < ldn; n0 += kWgN) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
      float dbacc = 0.f;
      const bool warp_live = m0 + wm * 32 < kpad && n0 + wn * 32 < ldn;
      stage_tiles(stages, ws, d, X, kpad, dy, ldn, m0, n0, 0);
      for (int sub = 0; sub < nsub; ++sub) {
        if (sub + 1 < nsub) {
          stage_tiles(stages + ((sub + 1) & 1) * kStageFloats, ws, d, X, kpad, dy, ldn, m0, n0,
                      sub + 1);
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();
        const float* xs = stages + (sub & 1) * kStageFloats;
        const float* ys = xs + kWgM * kLdS;
        if (warp_live) {
          const float* xa = xs + (wm * 32 + g) * kLdS + t;
          const float* yb = ys + (wn * 32 + g) * kLdS + t;
#pragma unroll 2
          for (int kk = 0; kk < kPts; kk += 8) {
            uint32_t ahi[2][4], alo[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              // a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (g + 8, t + 4)
              const float* p = xa + mt * 16 * kLdS + kk;
              split(p[0], ahi[mt][0], alo[mt][0]);
              split(p[8 * kLdS], ahi[mt][1], alo[mt][1]);
              split(p[4], ahi[mt][2], alo[mt][2]);
              split(p[8 * kLdS + 4], ahi[mt][3], alo[mt][3]);
            }
uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float* p = yb + j * 8 * kLdS + kk;
              split(p[0], bh[j][0], bl[j][0]);
              split(p[4], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][j], alo[mt], bh[j][0], bh[j][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][j], ahi[mt], bl[j][0], bl[j][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][j], ahi[mt], bh[j][0], bh[j][1]);
          }
        }
        if (m0 == 0 && threadIdx.x < kWgN) {
          const float* row = ys + threadIdx.x * kLdS;
          for (int p = 0; p < kPts; ++p) dbacc += row[p];
        }
        __syncthreads();
      }
      if (m0 == 0 && threadIdx.x < kWgN && n0 + (int)threadIdx.x < ldn)
        db[n0 + threadIdx.x] += dbacc;
      if (!warp_live) continue;
      // add into the partial dW: every load first, then every store, so the
      // 32 round trips to memory overlap instead of following one another
      float old[2][4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + 8 * j + 2 * t;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m = m0 + wm * 32 + 16 * mt + g;
          const bool lo = n < ldn && m < kpad, hi = n < ldn && m + 8 < kpad;
          old[mt][j][0] = lo ? dW[(size_t)m * ldn + n] : 0.f;
          old[mt][j][1] = lo ? dW[(size_t)m * ldn + n + 1] : 0.f;
          old[mt][j][2] = hi ? dW[(size_t)(m + 8) * ldn + n] : 0.f;
          old[mt][j][3] = hi ? dW[(size_t)(m + 8) * ldn + n + 1] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + 8 * j + 2 * t;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m = m0 + wm * 32 + 16 * mt + g;
          if (n < ldn && m < kpad) {
            dW[(size_t)m * ldn + n] = old[mt][j][0] + acc[mt][j][0];
            dW[(size_t)m * ldn + n + 1] = old[mt][j][1] + acc[mt][j][1];
          }
          if (n < ldn && m + 8 < kpad) {
            dW[(size_t)(m + 8) * ldn + n] = old[mt][j][2] + acc[mt][j][2];
            dW[(size_t)(m + 8) * ldn + n + 1] = old[mt][j][3] + acc[mt][j][3];
          }
        }
      }
    }
  }
}

// Copy a [rows][kLd] tile (64 points a row) from shared memory to the workspace.
__device__ __forceinline__ void store_tile(const float* src, float* dst, int rows) {
  for (int c = threadIdx.x; c < rows * (kPts / 4); c += kThreads) {
    const int r = c / (kPts / 4), q = (c % (kPts / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * kLd + q) =
        *reinterpret_cast<const float4*>(src + r * kLd + q);
  }
}

// Forward of one 64-point tile of the chunk (rays r0.., nq points), as the
// render kernel K2 computes it: the points, their PE, the trunk and the
// heads on activations in shared memory (emb, demb and two layer buffers at
// `tile`); sigma / rgb logits / semantics go to the strip. kStore (K3, K6):
// every activation the reverse sweep reads is also stored to the workspace;
// kSemAct (K6): the semantic head's hidden activation too (plane
// P_ACT0 + depth). semin (K4, may be null): the semantic head's input
// [h; emb] of each point is written as a row of semin [R * S][C] (C its
// unpadded width). kMip (K9, K10a, K10b): odv is odvr [R, 10] and zc the
// chunk's fenceposts [nr][S + 1]; each point is the interval (t0, t1) of
// its ray, whose cone-frustum Gaussian (frustum_gauss) goes through the
// integrated PE (ipe_rows) in place of the point's PE.
template <bool kStore, bool kSemAct = false, bool kMip = false>
__device__ __forceinline__ void forward_tile(const float* __restrict__ odv, const float* zc,
                                             const float* __restrict__ params,
                                             const TrainDesc& d, float* ws, float* strip,
                                             float* tile, int r0, int nq, int S, int sub,
                                             float* __restrict__ semin) {
  const MLPDesc& f = d.f;
  const int depth = f.depth, E = f.emb_dim, Ep = pad8(E), Ed = f.demb_dim, Edp = pad8(Ed);
  const int sem = f.sem_dim, cs = 6 + sem;
  const LayerDesc* head = f.layer + depth;  // alpha, feature, views, rgb, sem_0, sem_1
  const int q0 = sub * kPts;
  float* emb = tile;
  float* demb = emb + Ep * kLd;
  float* hA = demb + Edp * kLd;
  float* hB = hA + f.hrows * kLd;
  if (kMip) {
    // the Gaussians' means and variances in rows 0-5 of hA (layer 0
    // overwrites them), the viewdirs in rows 0-2 of demb
    for (int t = threadIdx.x; t < 3 * kPts; t += kThreads) {
      const int ch = t / kPts, p = t % kPts, q = q0 + p;
      float m = 0.f, cv = 0.f, v = 0.f;
      if (q < nq) {
        const int r = q / S, s = q % S;
        const float* ray = odv + (size_t)(r0 + r) * 10;
        const float* zr = zc + (size_t)r * (S + 1);
        frustum_gauss(ray, zr[s], zr[s + 1], ch, m, cv);
        v = ray[6 + ch];
      }
      hA[ch * kLd + p] = m;
      hA[(3 + ch) * kLd + p] = cv;
      demb[ch * kLd + p] = v;
    }
    __syncthreads();
    ipe_rows(emb, hA, E);
  } else {
    for (int t = threadIdx.x; t < 3 * kPts; t += kThreads) {
      const int ch = t / kPts, p = t % kPts, q = q0 + p;
      float x = 0.f, v = 0.f;
      if (q < nq) {
        const float* ray = odv + (size_t)(r0 + q / S) * 9;
        x = __fadd_rn(ray[ch], __fmul_rn(ray[3 + ch], zc[q]));
        v = ray[6 + ch];
      }
      emb[ch * kLd + p] = x;
      demb[ch * kLd + p] = v;
    }
    __syncthreads();
    pe_rows(emb, E);
  }
  pe_rows(demb, Ed);
  __syncthreads();
  if (kStore) {
    store_tile(emb, plane(ws, d, P_EMB, sub), Ep);
    store_tile(demb, plane(ws, d, P_DEMB, sub), Edp);
  }

  // trunk: layer i reads `in0, in1` and writes the buffer not holding h
  Seg in0{emb, Ep}, in1 = none();
  float* cur = hB;
  for (int i = 0; i < depth; ++i) {
    float* nxt = (cur == hA) ? hB : hA;
    dense_call(params, f.layer[i], in0, in1, none(), nxt, true);
    __syncthreads();
    if (kStore) store_tile(nxt, plane(ws, d, P_ACT0 + i, sub), pad8(f.layer[i].n));
    cur = nxt;
    if (i == f.skip) {
      in0 = Seg{emb, Ep};
      in1 = Seg{cur, pad8(f.layer[i].n)};
    } else {
      in0 = Seg{cur, pad8(f.layer[i].n)};
      in1 = none();
    }
  }
  float* spare = (cur == hA) ? hB : hA;
  if (semin != nullptr) {
    // the rows of in0 and in1 (h, or [emb, h] when the skip follows the last
    // layer) and of emb, unpadded: one contiguous [np][C] block of semin.
    // The sem head's __syncthreads below orders these reads before the
    // views layer overwrites h.
    const int hn = f.layer[depth - 1].n;
    const int k0 = (in1.k > 0) ? E : hn, k1 = (in1.k > 0) ? hn : 0;
    const int C = k0 + k1 + (f.sem_with_coord ? E : 0);
    const int np = min(kPts, nq - q0);
    float* dst = semin + ((size_t)r0 * S + q0) * C;
    for (int e = threadIdx.x; e < np * C; e += kThreads) {
      const int p = e / C, col = e % C;
      dst[e] = col < k0 ? in0.a[col * kLd + p]
             : col < k0 + k1 ? in1.a[(col - k0) * kLd + p]
                             : emb[(col - k0 - k1) * kLd + p];
    }
  }
  dense_small(params, head[0], in0, in1, none(), strip, q0, nq, cs, 0);  // sigma
  if (sem) {
    const Seg coord = f.sem_with_coord ? Seg{emb, Ep} : none();
    dense_call(params, head[4], in0, in1, coord, spare, true);
    __syncthreads();
    if (kSemAct) store_tile(spare, plane(ws, d, P_ACT0 + depth, sub), pad8(head[4].n));
    dense_small(params, head[5], Seg{spare, pad8(head[4].n)}, none(), none(), strip, q0, nq, cs,
                5);
    __syncthreads();
  }
  dense_call(params, head[1], in0, in1, none(), spare, false);  // feature
  __syncthreads();
  if (kStore) store_tile(spare, plane(ws, d, P_FEAT, sub), pad8(head[1].n));
  dense_call(params, head[2], Seg{spare, pad8(head[1].n)}, Seg{demb, Edp}, none(), cur,
             true);  // views (h is no longer needed)
  __syncthreads();
  if (kStore) store_tile(cur, plane(ws, d, P_HV, sub), pad8(head[2].n));
  dense_small(params, head[3], Seg{cur, pad8(head[2].n)}, none(), none(), strip, q0, nq, cs, 2);
  __syncthreads();
}

// What the composite does after the maps: kForward (K4) nothing; kLoss
// (K3) the img2mse cotangent from gt and its reverse; kCotangent (K6) the
// reverse of the given map and weight cotangents.
enum Mode { kForward, kLoss, kCotangent };

// The composite of the chunk's rays (one thread a ray): sigma noise, alpha,
// transmittance, weights and maps out (each when its pointer is not null);
// then, but for kForward, the maps' cotangent (kLoss: 2 (rgb_map - gt) from
// aux = gt [R, 3]; kCotangent: aux = dmaps [R, 5 + sem], with dweights
// [R, S] or null) and its reverse through the composite into dsigma, drgb
// (pre-sigmoid) and, for kCotangent, d_sem per point. kMip: odv is odvr
// [R, 10] and zc fenceposts [nr][S + 1]; an interval's distance is
// (t1 - t0)·‖d‖ with no far pad and its depth the midpoint (t0 + t1) / 2.
template <int kMode, bool kMip = false>
__device__ __forceinline__ void composite_chunk(const float* __restrict__ odv, const float* zc,
                                                const float* __restrict__ aux,
                                                const float* __restrict__ dweights,
                                                const TrainDesc& d, float* ws, float* strip,
                                                float* __restrict__ maps,
                                                float* __restrict__ weights, int r0, int nr,
                                                int S, int nsub, unsigned seed,
                                                float noise_std, int white_bkgd) {
  const int sem = d.f.sem_dim, cs = 6 + sem, nmaps = 5 + sem, nq = nr * S;
  const int p_dsem = P_ACT0 + d.f.depth + 1;
  for (int rl = threadIdx.x; rl < nr; rl += kThreads) {
    const float* ray = odv + (size_t)(r0 + rl) * (kMip ? 10 : 9);
    const float nd = sqrtf(ray[3] * ray[3] + ray[4] * ray[4] + ray[5] * ray[5]);
    const float* zr = zc + (size_t)rl * (kMip ? S + 1 : S);
    auto gap = [&](int s) {
      return kMip ? zr[s + 1] - zr[s] : (s == S - 1) ? 1e10f : zr[s + 1] - zr[s];
    };
    auto depth_of = [&](int s) { return kMip ? (zr[s] + zr[s + 1]) * 0.5f : zr[s]; };
    float m[5 + kMaxSem];
#pragma unroll
    for (int j = 0; j < 5 + kMaxSem; ++j) m[j] = 0.f;
    float T = 1.f;
    for (int s = 0; s < S; ++s) {
      float* cq = strip + (rl * S + s) * cs;
      float sig = cq[0];
      if (noise_std > 0.f) sig += hash_noise(seed, (uint32_t)((r0 + rl) * S + s), noise_std);
      cq[0] = sig;
      const float e = expf(-fmaxf(sig, 0.f) * (gap(s) * nd));
      const float w = (1.f - e) * T;
      cq[1] = T;
      cq[5 + sem] = w;
      if (weights) weights[(size_t)(r0 + rl) * S + s] = w;
#pragma unroll
      for (int j = 0; j < 3; ++j) m[j] += w * (1.f / (1.f + expf(-cq[2 + j])));
      m[3] += w * depth_of(s);
      m[4] += w;
#pragma unroll
      for (int j = 0; j < kMaxSem; ++j)
        if (j < sem) m[5 + j] += w * cq[5 + j];
      T *= e + 1e-10f;
    }
    if (maps) {
#pragma unroll
      for (int j = 0; j < 5 + kMaxSem; ++j)
        if (j < nmaps) maps[(size_t)(r0 + rl) * nmaps + j] = m[j];
    }
    if (kMode == kForward) continue;

    // g: the cotangent of each map column (kLoss: the rgb columns' and the
    // white background's acc term)
    float g[5 + kMaxSem];
#pragma unroll
    for (int j = 0; j < 5 + kMaxSem; ++j) g[j] = 0.f;
    if (kMode == kLoss) {
      const float* gr = aux + (size_t)(r0 + rl) * 3;
      const float bg = white_bkgd ? 1.f - m[4] : 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = 2.f * (m[j] + bg - gr[j]);
      g[4] = white_bkgd ? -(g[0] + g[1] + g[2]) : 0.f;
    } else {
      const float* dm = aux + (size_t)(r0 + rl) * nmaps;
#pragma unroll
      for (int j = 0; j < 5 + kMaxSem; ++j)
        if (j < nmaps) g[j] = dm[j];
    }
    float suffix = 0.f;  // sum over later samples of dw * alpha * T
    for (int s = S - 1; s >= 0; --s) {
      const float* cq = strip + (rl * S + s) * cs;
      const float sig = cq[0], Ts = cq[1], w = cq[5 + sem];
      const float D = gap(s) * nd;
      const float e = expf(-fmaxf(sig, 0.f) * D);
      const float alpha = 1.f - e, y = e + 1e-10f;
      float rgb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) rgb[j] = 1.f / (1.f + expf(-cq[2 + j]));
      float dw;
      if (kMode == kLoss) {
        dw = g[0] * rgb[0] + g[1] * rgb[1] + g[2] * rgb[2] + g[4];
      } else {
        dw = g[0] * rgb[0] + g[1] * rgb[1] + g[2] * rgb[2] + g[3] * depth_of(s) + g[4];
#pragma unroll
        for (int j = 0; j < kMaxSem; ++j)
          if (j < sem) dw += g[5 + j] * cq[5 + j];
        if (dweights) dw += dweights[(size_t)(r0 + rl) * S + s];
      }
      const float dalpha = dw * Ts - suffix / y;
      suffix += (dw * alpha) * Ts;
      const int q = rl * S + s, sub = q / kPts, p = q % kPts;
      plane(ws, d, P_DSIG, sub)[p] = sig > 0.f ? dalpha * e * D : 0.f;
      float* dr = plane(ws, d, P_DRGB, sub);
#pragma unroll
      for (int j = 0; j < 3; ++j) dr[j * kLd + p] = (g[j] * w) * (rgb[j] * (1.f - rgb[j]));
      if (kMode == kCotangent) {
        float* dsm = plane(ws, d, p_dsem, sub);
#pragma unroll
        for (int j = 0; j < kMaxSem; ++j)
          if (j < sem) dsm[j * kLd + p] = g[5 + j] * w;
      }
    }
  }
  for (int q = nq + threadIdx.x; kMode != kForward && q < nsub * kPts; q += kThreads) {
    const int sub = q / kPts, p = q % kPts;  // the last tile's tail
    plane(ws, d, P_DSIG, sub)[p] = 0.f;
    float* dr = plane(ws, d, P_DRGB, sub);
    for (int j = 0; j < 3; ++j) dr[j * kLd + p] = 0.f;
    if (kMode == kCotangent)
      for (int j = 0; j < sem; ++j) plane(ws, d, p_dsem, sub)[j * kLd + p] = 0.f;
  }
  __syncthreads();
}

// Wave `wave` of the forward: CTA b takes chunk wave * gridDim.x + b into its
// workspace slice b: every activation of the reverse sweep, then the
// composite (kLoss: maps, weights, dsigma and drgb from gt = aux;
// kCotangent: dsigma, drgb and d_sem from dmaps = aux and dweights).
// kMip: odv is odvr [R, 10] and z fenceposts [R, S + 1] (K10b).
template <int kMode, bool kMip = false>
__global__ void __launch_bounds__(kThreads, 1)
    train_forward_kernel(const float* __restrict__ odv, const float* __restrict__ z,
                         const float* __restrict__ aux, const float* __restrict__ dweights,
                         const float* __restrict__ params, const __grid_constant__ TrainDesc d,
                         float* __restrict__ maps, float* __restrict__ weights,
                         float* __restrict__ workspace, int R, int S, int wave, unsigned seed,
                         float noise_std, int white_bkgd) {
  extern __shared__ float4 smem4[];
  const int rpc = d.rays_per_chunk;
  const int c = wave * gridDim.x + blockIdx.x;
  if (c * rpc >= R) return;
  float* strip = reinterpret_cast<float*>(smem4);
  float* tile = strip + ((rpc * S * (6 + d.f.sem_dim) + 3) & ~3);  // emb, demb, hA, hB
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  const int E = d.f.emb_dim, Ep = pad8(E), Ed = d.f.demb_dim, Edp = pad8(Ed);
  for (int i = threadIdx.x; i < (Ep - E) * kLd; i += kThreads) tile[E * kLd + i] = 0.f;
  for (int i = threadIdx.x; i < (Edp - Ed) * kLd; i += kThreads)
    tile[(Ep + Ed) * kLd + i] = 0.f;
  if (wave == 0) {  // padding rows of the cotangent planes that nothing writes
    for (int sub = 0; sub < (rpc * S + kPts - 1) / kPts; ++sub) {
      float* r = plane(ws, d, P_DRGB, sub);
      float* s = plane(ws, d, P_DSIG, sub);
      for (int i = threadIdx.x; i < 5 * kLd; i += kThreads) r[3 * kLd + i] = 0.f;
      for (int i = threadIdx.x; i < 7 * kLd; i += kThreads) s[kLd + i] = 0.f;
      if (kMode == kCotangent && d.f.sem_dim > 0) {
        float* m = plane(ws, d, P_ACT0 + d.f.depth + 1, sub);
        for (int i = threadIdx.x; i < (8 - d.f.sem_dim) * kLd; i += kThreads)
          m[d.f.sem_dim * kLd + i] = 0.f;
      }
    }
  }
  __syncthreads();
  const int r0 = c * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int nsub = (nq + kPts - 1) / kPts;
  const float* zc = z + (size_t)r0 * (kMip ? S + 1 : S);

  // ---- forward, storing every activation the reverse sweep reads
  for (int sub = 0; sub < nsub; ++sub)
    forward_tile<true, kMode == kCotangent, kMip>(odv, zc, params, d, ws, strip, tile, r0, nq, S,
                                                  sub, nullptr);

  // ---- composite, maps, the cotangent and its reverse: one thread a ray
  composite_chunk<kMode, kMip>(odv, zc, aux, dweights, d, ws, strip, maps, weights, r0, nr, S,
                               nsub, seed, noise_std, white_bkgd);
}

// K4: CTA b takes chunk b (d.rays_per_chunk rays): the forward of each
// 64-point tile (with the sem_in rows when semin is not null), then the
// composite with the sigma noise into maps and weights. Nothing is stored
// for a reverse sweep. kMip: K9 (noise_std 0) and K10a, on odvr [R, 10] and
// fenceposts [R, S + 1]; maps [R, 5]; semin is null.
template <bool kMip = false>
__global__ void __launch_bounds__(kThreads, 1)
    train_render_kernel(const float* __restrict__ odv, const float* __restrict__ z,
                        const float* __restrict__ params, const __grid_constant__ TrainDesc d,
                        float* __restrict__ maps, float* __restrict__ weights,
                        float* __restrict__ semin, int R, int S, unsigned seed,
                        float noise_std) {
  extern __shared__ float4 smem4[];
  const int rpc = d.rays_per_chunk;
  float* strip = reinterpret_cast<float*>(smem4);
  float* tile = strip + ((rpc * S * (6 + d.f.sem_dim) + 3) & ~3);  // emb, demb, hA, hB
  const int E = d.f.emb_dim, Ep = pad8(E), Ed = d.f.demb_dim, Edp = pad8(Ed);
  for (int i = threadIdx.x; i < (Ep - E) * kLd; i += kThreads) tile[E * kLd + i] = 0.f;
  for (int i = threadIdx.x; i < (Edp - Ed) * kLd; i += kThreads)
    tile[(Ep + Ed) * kLd + i] = 0.f;
  __syncthreads();
  const int r0 = blockIdx.x * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int nsub = (nq + kPts - 1) / kPts;
  const float* zc = z + (size_t)r0 * (kMip ? S + 1 : S);
  for (int sub = 0; sub < nsub; ++sub)
    forward_tile<false, false, kMip>(odv, zc, params, d, nullptr, strip, tile, r0, nq, S, sub,
                                     semin);
  composite_chunk<kForward, kMip>(odv, zc, nullptr, nullptr, d, nullptr, strip, maps, weights, r0,
                                  nr, S, nsub, seed, noise_std, 0);
}

// K5: the semantic head's weight gradients for a frozen backbone.
// sem_0's outputs are cut into blocks of kSemBlk; CTA (x, blk) takes block
// blk of a run of 64-point tiles and keeps its share of dW0 in registers.
constexpr int kSemBlk = 64;
constexpr int kMaxSemRows = 384;                    // padded sem_in rows
constexpr int kSemMt = kMaxSemRows / 16 / 4;        // m16 tiles of dW0 a warp row
}  // namespace

constexpr int kMaxSemBlocks = 4;

// Host-visible: the C entry point takes a FrozenDesc* (ops/fused_render.pack_frozen).
struct FrozenDesc {
  LayerDesc blk[kMaxSemBlocks];  // sem_0 outputs [64 c, 64 c + n) as a packed layer
  long long w1;                  // sem_1's weight [sem_dim][hidden] (torch layout)
  long long gw0, gb0, gw1, gb1;  // gradient buffer: dW0^T [kpad][hidden], db0 [hidden],
                                 //   dW1^T [hidden][sem_dim], db1 [sem_dim]
  long long grad_size;
  int seg[3];                    // unpadded widths of sem_in's segments, in order
  int kpad;                      // sem_in rows with each segment padded to 8
  int hidden, sem_dim, nblk, n_maps;
};

namespace {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// One 64-point tile of sem_in [P][C] (point-major), copied with cp.async
// straight into the feature-major [kpad][kLd] tile xin (lane = column, so
// the global reads are coalesced; padding rows were zeroed once and are
// never written; points past np are zeroed), and its weights and its rays'
// map cotangents into rw [kPts] and rw + kPts [kMaxSem][kPts]; one group.
__device__ __forceinline__ void load_frozen_tile(const float* __restrict__ semin,
                                                 const float* __restrict__ weights,
                                                 const float* __restrict__ dmaps,
                                                 const FrozenDesc& d, float* xin, float* rw,
                                                 int C, long long q0, int np, int S) {
  const int k0 = d.seg[0], k1 = d.seg[1];
  const int o1 = pad8(k0), o2 = o1 + pad8(k1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = semin + q0 * C;
  for (int p = warp; p < kPts; p += kThreads / 32)
    for (int col = lane; col < C; col += 32) {
      const int row = col < k0 ? col : col < k0 + k1 ? o1 + col - k0 : o2 + col - k0 - k1;
      if (p < np) {
        cp_async4(xin + row * kLd + p, src + (size_t)p * C + col);
      } else {
        xin[row * kLd + p] = 0.f;
      }
    }
  for (int e = threadIdx.x; e < np * (1 + d.sem_dim); e += kThreads) {
    const int j = e / np, p = e % np;
    const long long q = q0 + p;
    cp_async4(rw + j * kPts + p, j == 0 ? weights + q : dmaps + (q / S) * d.n_maps + 4 + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// sact [64][kLd] = relu(x W0 + b0) of the tile for this CTA's block of
// outputs, with the block's W0^T [kpad][kLd] (fp32) in shared memory and
// split into TF32 parts here: m16n8k8 3xTF32, warp w on points
// 32 (w & 1) .. +32 and outputs 8 (w >> 1) .. +8.
__device__ __forceinline__ void sem0_forward(const float* xin, const float* w0s,
                                             const float* __restrict__ bias, float* sact,
                                             int kpad, int nbp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 8;
  if (n0 >= nbp) return;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int k = 0; k < kpad; k += 8) {
    const float* a = xin + (k + t) * kLd + m0 + g;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      split(a[mt * 16], ahi[mt][0], alo[mt][0]);
      split(a[mt * 16 + 8], ahi[mt][1], alo[mt][1]);
      split(a[4 * kLd + mt * 16], ahi[mt][2], alo[mt][2]);
      split(a[4 * kLd + mt * 16 + 8], ahi[mt][3], alo[mt][3]);
    }
    const float* b = w0s + (k + t) * kLd + n0 + g;
    uint32_t bh0, bl0, bh1, bl1;
    split(b[0], bh0, bl0);
    split(b[4 * kLd], bh1, bl1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt], alo[mt], bh0, bh1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt], ahi[mt], bl0, bl1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt], ahi[mt], bh0, bh1);
  }
  const int n = n0 + 2 * t;
  const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = m0 + mt * 16 + g;
    sact[n * kLd + p] = fmaxf(acc[mt][0] + b0, 0.f);
    sact[(n + 1) * kLd + p] = fmaxf(acc[mt][1] + b1, 0.f);
    sact[n * kLd + p + 8] = fmaxf(acc[mt][2] + b0, 0.f);
    sact[(n + 1) * kLd + p + 8] = fmaxf(acc[mt][3] + b1, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    frozen_sem_kernel(const float* __restrict__ semin, const float* __restrict__ weights,
                      const float* __restrict__ dmaps, const float* __restrict__ params,
                      const __grid_constant__ FrozenDesc d, float* __restrict__ partial,
                      long long P, int S, long long tiles_per_cta) {
  extern __shared__ float4 smem4[];
  float* xin = reinterpret_cast<float*>(smem4);  // [kpad][kLd] sem_in, feature-major
  float* sact = xin + d.kpad * kLd;               // [64][kLd] relu(sem_in W0 + b0), this block
  float* ds = sact + kSemBlk * kLd;               // [64][kLd] its cotangent
  float* dsem = ds + kSemBlk * kLd;               // [8][kLd] d_sem = dmaps[ray, 5 + j] * w
  float* w0s = dsem + 8 * kLd;                    // [kpad][kLd] this block's W0^T
  float* acc1 = w0s + d.kpad * kLd;               // dW1 [64][kMaxSem], then db0 [64], db1 [8]
  float* w1s = acc1 + kSemBlk * kMaxSem + kSemBlk + 8;  // [kMaxSem][64] this block's W1
  float* rw = w1s + kMaxSem * kSemBlk;            // the tile's w [64], dmaps[:, 5:] [8][64]
  const int blk = blockIdx.y, n0 = blk * kSemBlk;
  const LayerDesc L = d.blk[blk];
  const int nb = L.n, nbp = pad8(nb), sem = d.sem_dim, hidden = d.hidden;
  const int C = d.seg[0] + d.seg[1] + d.seg[2];
  for (int i = threadIdx.x; i < d.kpad * kLd; i += kThreads) {
    const int k = i / kLd, n = i % kLd;
    xin[i] = 0.f;
    w0s[i] = n < nbp ? params[L.w + (size_t)k * nbp + n] : 0.f;
  }
  for (int i = threadIdx.x; i < kSemBlk * kMaxSem + kSemBlk + 8; i += kThreads) acc1[i] = 0.f;
  for (int i = threadIdx.x; i < kMaxSem * kSemBlk; i += kThreads) {
    const int j = i / kSemBlk, n = i % kSemBlk;
    w1s[i] = (j < sem && n < nb) ? params[d.w1 + (size_t)j * hidden + n0 + n] : 0.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // m16 tiles wm + 4 i; n8 tiles 2 wn, 2 wn + 1
  const int mtiles = d.kpad / 16 + (d.kpad % 16 ? 1 : 0);
  float acc[kSemMt][2][4];
#pragma unroll
  for (int i = 0; i < kSemMt; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const long long ntiles = (P + kPts - 1) / kPts;
  const long long t0 = blockIdx.x * tiles_per_cta;
  const long long t1 = min(ntiles, t0 + tiles_per_cta);
  for (long long tile = t0; tile < t1; ++tile) {
    const long long q0 = tile * kPts;
    const int np = (int)min((long long)kPts, P - q0);
    __syncthreads();  // the previous tile's readers of xin are done
    load_frozen_tile(semin, weights, dmaps, d, xin, rw, C, q0, np, S);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int e = threadIdx.x; e < 8 * kPts; e += kThreads) {
      const int j = e / kPts, p = e % kPts;
      dsem[j * kLd + p] = (j < sem && p < np) ? rw[(j + 1) * kPts + p] * rw[p] : 0.f;
    }
    sem0_forward(xin, w0s, params + L.b, sact, d.kpad, nbp);
    __syncthreads();
    // ds = (W1^T d_sem) where sact > 0
    for (int e = threadIdx.x; e < nbp * kPts; e += kThreads) {
      const int n = e / kPts, p = e % kPts;
      float v = 0.f;
      if (n < nb) {
        for (int j = 0; j < sem; ++j) v += w1s[j * kSemBlk + n] * dsem[j * kLd + p];
        v = sact[n * kLd + p] > 0.f ? v : 0.f;
      }
      ds[n * kLd + p] = v;
    }
    __syncthreads();
    // the small sums, each by one thread in point order: dW1[n][j] of
    // sact[n] . d_sem[j], db0[n] of ds[n], and (block 0) db1[j] of d_sem[j]
    for (int i = threadIdx.x; i < nb * sem + nb + (blk == 0 ? sem : 0); i += kThreads) {
      const float *x, *y = nullptr;
      int slot;
      if (i < nb * sem) {
        x = sact + (i / sem) * kLd;
        y = dsem + (i % sem) * kLd;
        slot = (i / sem) * kMaxSem + i % sem;
      } else if (i < nb * sem + nb) {
        x = ds + (i - nb * sem) * kLd;
        slot = kSemBlk * kMaxSem + i - nb * sem;
      } else {
        x = dsem + (i - nb * sem - nb) * kLd;
        slot = kSemBlk * kMaxSem + kSemBlk + i - nb * sem - nb;
      }
      float s = 0.f;
      for (int p = 0; p < kPts; ++p) s += y ? x[p] * y[p] : x[p];
      acc1[slot] += s;
    }
    // dW0[m][n] += sum_p sem_in[m][p] ds[n][p]: m16n8k8 3xTF32, k = points;
    // the two n8 tiles' products interleaved, so no mma waits on the one
    // just before it
#pragma unroll 2
    for (int kk = 0; kk < kPts; kk += 8) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* b = ds + (16 * wn + 8 * j + g) * kLd + kk + t;
        split(b[0], bh[j][0], bl[j][0]);
        split(b[4], bh[j][1], bl[j][1]);
      }
      const bool two = 16 * wn + 8 < nbp;
#pragma unroll
      for (int i = 0; i < kSemMt; ++i) {
        const int mt = wm + 4 * i;
        if (mt >= mtiles || 16 * wn >= nbp) continue;
        const float* a = xin + (16 * mt + g) * kLd + kk + t;
        uint32_t ahi[4], alo[4];
        split(a[0], ahi[0], alo[0]);
        split(a[8 * kLd], ahi[1], alo[1]);
        split(a[4], ahi[2], alo[2]);
        split(a[8 * kLd + 4], ahi[3], alo[3]);
        mma_tf32(acc[i][0], alo, bh[0][0], bh[0][1]);
        if (two) mma_tf32(acc[i][1], alo, bh[1][0], bh[1][1]);
        mma_tf32(acc[i][0], ahi, bl[0][0], bl[0][1]);
        if (two) mma_tf32(acc[i][1], ahi, bl[1][0], bl[1][1]);
        mma_tf32(acc[i][0], ahi, bh[0][0], bh[0][1]);
        if (two) mma_tf32(acc[i][1], ahi, bh[1][0], bh[1][1]);
      }
    }
  }
  __syncthreads();

  // this CTA's share of the partial gradient buffer x (every entry of the
  // buffer is written by exactly one CTA (x, blk))
  float* gp = partial + (size_t)blockIdx.x * d.grad_size;
#pragma unroll
  for (int i = 0; i < kSemMt; ++i) {
    const int mt = wm + 4 * i;
    if (mt >= mtiles) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 16 * wn + 8 * j + 2 * t;
      const int m = 16 * mt + g;
      if (n >= nb) continue;
      float* o = gp + d.gw0 + (size_t)m * hidden + n0 + n;
      const bool two = n + 1 < nb;  // nb is a multiple of 8 but for the last block
      if (m < d.kpad) {
        o[0] = acc[i][j][0];
        if (two) o[1] = acc[i][j][1];
      }
      if (m + 8 < d.kpad) {
        o[8 * (size_t)hidden] = acc[i][j][2];
        if (two) o[8 * (size_t)hidden + 1] = acc[i][j][3];
      }
    }
  }
  for (int i = threadIdx.x; i < nb * sem; i += kThreads)
    gp[d.gw1 + (size_t)(n0 + i / sem) * sem + i % sem] = acc1[(i / sem) * kMaxSem + i % sem];
  for (int i = threadIdx.x; i < nb; i += kThreads)
    gp[d.gb0 + n0 + i] = acc1[kSemBlk * kMaxSem + i];
  if (blk == 0)
    for (int i = threadIdx.x; i < sem; i += kThreads)
      gp[d.gb1 + i] = acc1[kSemBlk * kMaxSem + kSemBlk + i];
}

// Wave `wave` of the reverse sweep, on the chunk the forward left in
// workspace slice b: rgb, views, feature + alpha, with kSem (K6) the
// semantic head, then the trunk; dW/db add into CTA b's partial gradients
// (zeroed in wave 0).
template <bool kSem>
__global__ void __launch_bounds__(kThreads, 1)
    train_reverse_kernel(const float* __restrict__ bparams, const __grid_constant__ TrainDesc d,
                         float* __restrict__ partial, float* __restrict__ workspace, int R, int S,
                         int wave) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  const MLPDesc& f = d.f;
  const int rpc = d.rays_per_chunk;
  const int c = wave * gridDim.x + blockIdx.x;
  float* gpart = partial + (size_t)blockIdx.x * d.grad_size;
  if (wave == 0) {
    for (size_t i = threadIdx.x; i < (size_t)d.grad_size; i += kThreads) gpart[i] = 0.f;
    __syncthreads();
  }
  if (c * rpc >= R) return;
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  const int depth = f.depth, ldw = pad8(f.layer[0].n);
  const int nsub = (min(rpc, R - c * rpc) * S + kPts - 1) / kPts;
  const int k_alpha = depth, k_feat = depth + 1, k_views = depth + 2, k_rgb = depth + 3;

  // ---- reverse sweep: rgb, views, feature + alpha, trunk
  wgrad(ws, d, XSegs{{P_HV, 0}, 1}, P_DRGB, pad8(3), gpart + d.gw[k_rgb], gpart + d.gb[k_rgb],
        nsub, stages);
  bwd_layer(bparams, d.bwd[k_rgb], ws, d, P_DRGB, -1, P_DPV, P_HV, nsub, stages);
  wgrad(ws, d, XSegs{{P_FEAT, P_DEMB}, 2}, P_DPV, pad8(f.layer[k_views].n),
        gpart + d.gw[k_views], gpart + d.gb[k_views], nsub, stages);
  bwd_layer(bparams, d.bwd[k_views], ws, d, P_DPV, -1, P_DFEAT, -1, nsub, stages);
  const int last = P_ACT0 + depth - 1;
  const XSegs h = (f.skip == depth - 1) ? XSegs{{P_EMB, last}, 2} : XSegs{{last, 0}, 1};
  wgrad(ws, d, h, P_DFEAT, ldw, gpart + d.gw[k_feat], gpart + d.gb[k_feat], nsub, stages);
  wgrad(ws, d, h, P_DSIG, 8, gpart + d.gw[k_alpha], gpart + d.gb[k_alpha], nsub, stages);
  bwd_layer(bparams, d.bwd[k_alpha], ws, d, P_DFEAT, P_DSIG, P_DA, last, nsub, stages);
  if (kSem) {  // sem_1, ds, sem_0, and sem_0's input gradient on h added into P_DA
    const int k_s0 = depth + 4, k_s1 = depth + 5;
    const int p_sact = P_ACT0 + depth, p_dsem = p_sact + 1, p_ds = p_sact + 2;
    wgrad(ws, d, XSegs{{p_sact, 0, 0}, 1}, p_dsem, pad8(f.layer[k_s1].n), gpart + d.gw[k_s1],
          gpart + d.gb[k_s1], nsub, stages);
    bwd_layer(bparams, d.bwd[k_s1], ws, d, p_dsem, -1, p_ds, p_sact, nsub, stages);
    XSegs in = h;
    if (f.sem_with_coord) in.p[in.n++] = P_EMB;
    wgrad(ws, d, in, p_ds, pad8(f.layer[k_s0].n), gpart + d.gw[k_s0], gpart + d.gb[k_s0], nsub,
          stages);
    bwd_layer<true>(bparams, d.bwd[k_s0], ws, d, p_ds, -1, P_DA, last, nsub, stages);
  }
  int cur = P_DA;
  for (int i = depth - 1; i >= 0; --i) {
    const XSegs in = (i == 0) ? XSegs{{P_EMB, 0}, 1}
                     : (i - 1 == f.skip) ? XSegs{{P_EMB, P_ACT0 + i - 1}, 2}
                                         : XSegs{{P_ACT0 + i - 1, 0}, 1};
    wgrad(ws, d, in, cur, ldw, gpart + d.gw[i], gpart + d.gb[i], nsub, stages);
    const int nxt = (cur == P_DA) ? P_DB : P_DA;
    if (i > 0) bwd_layer(bparams, d.bwd[i], ws, d, cur, -1, nxt, P_ACT0 + i - 1, nsub, stages);
    cur = nxt;
  }
}

// out[i] = sum over the CTAs, in CTA order, of their partial gradients
__global__ void reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                                long long n, int parts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < parts; ++c) s += partial[(size_t)c * n + i];
    out[i] = s;
  }
}

// shared memory of the forward kernels (K3's and K4): the chunk's composite
// strip, then emb, demb and two layer tiles
int forward_smem(const TrainDesc* d, int S) {
  const int Ep = (d->f.emb_dim + 7) / 8 * 8, Edp = (d->f.demb_dim + 7) / 8 * 8;
  return (int)((((size_t)d->rays_per_chunk * S * (6 + d->f.sem_dim) + 3) / 4 * 4 +
                (size_t)(Ep + Edp + 2 * d->f.hrows) * kLd) *
               sizeof(float));
}

}  // namespace

// K4: one launch, a CTA a chunk of d->rays_per_chunk rays; semin may be null.
namespace {

template <bool kMip>
int train_render_launch(const float* odv, const float* z, const float* params,
                        const TrainDesc* d, float* maps, float* weights, float* semin, int R,
                        int S, unsigned seed, float noise_std, cudaStream_t st) {
  const int smem = forward_smem(d, S);
  cudaError_t err = cudaFuncSetAttribute(train_render_kernel<kMip>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  train_render_kernel<kMip><<<nchunks, kThreads, smem, st>>>(odv, z, params, *d, maps, weights,
                                                             semin, R, S, seed, noise_std);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nerf_train_render(const float* odv, const float* z, const float* params,
                                 const TrainDesc* d, float* maps, float* weights, float* semin,
                                 int R, int S, unsigned seed, float noise_std, void* stream) {
  return train_render_launch<false>(odv, z, params, d, maps, weights, semin, R, S, seed,
                                    noise_std, (cudaStream_t)stream);
}

// K9 (noise_std 0) and K10a: the mip render pass, odvr [R, 10] and
// fenceposts z [R, S + 1] -> maps [R, 5] and weights [R, S], with the sigma
// noise of seed; one launch, a CTA a chunk of d->rays_per_chunk rays. The
// two TPU kernels differ by the noise alone, so they are one kernel here.
extern "C" int nerf_mip_render(const float* odvr, const float* z, const float* params,
                               const TrainDesc* d, float* maps, float* weights, int R, int S,
                               unsigned seed, float noise_std, void* stream) {
  return train_render_launch<true>(odvr, z, params, d, maps, weights, nullptr, R, S, seed,
                                   noise_std, (cudaStream_t)stream);
}

// K5: grid x d->nblk CTAs over P = R * S points, each CTA x with a
// d->grad_size partial buffer, then the partials summed in CTA order into
// grads [d->grad_size].
extern "C" int nerf_frozen_sem_grads(const float* semin, const float* weights,
                                     const float* dmaps, const float* params,
                                     const FrozenDesc* d, float* partial, float* grads,
                                     long long P, int S, int grid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)(((size_t)(2 * d->kpad + 2 * kSemBlk + 8) * kLd +
                          kSemBlk * (2 * kMaxSem + 1) + 8 + kPts * (1 + kMaxSem)) *
                         sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(frozen_sem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (P + kPts - 1) / kPts;
  const long long per_cta = (ntiles + grid - 1) / grid;
  frozen_sem_kernel<<<dim3(grid, d->nblk), kThreads, smem, st>>>(semin, weights, dmaps, params,
                                                                 *d, partial, P, S, per_cta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((d->grad_size + 255) / 256 < 1024 ? (d->grad_size + 255) / 256 : 1024);
  reduce_partials<<<blocks, 256, 0, st>>>(partial, grads, d->grad_size, grid);
  return (int)cudaGetLastError();
}

namespace {

// grid CTAs (each with a d->ws_size workspace slice and a d->grad_size partial
// gradient buffer) take the chunks of rays in waves of grid: per wave the
// forward kernel, then the reverse-sweep kernel; then the partials are summed
// into grads [d->grad_size]. Returns the first CUDA error of the launches.
template <int kMode, bool kSem, bool kMip = false>
int train_grads(const float* odv, const float* z, const float* aux, const float* dweights,
                const float* params, const float* bparams, const TrainDesc* d, float* maps,
                float* weights, float* partial, float* workspace, float* grads, int R, int S,
                int grid, unsigned seed, float noise_std, int white_bkgd, cudaStream_t st) {
  const int fwd_smem = forward_smem(d, S);
  const int stage_smem = (int)(kStagingFloats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(train_forward_kernel<kMode, kMip>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(train_reverse_kernel<kSem>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, stage_smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  for (int wave = 0; wave * grid < nchunks; ++wave) {
    train_forward_kernel<kMode, kMip><<<grid, kThreads, fwd_smem, st>>>(
        odv, z, aux, dweights, params, *d, maps, weights, workspace, R, S, wave, seed,
        noise_std, white_bkgd);
    train_reverse_kernel<kSem><<<grid, kThreads, stage_smem, st>>>(bparams, *d, partial,
                                                                  workspace, R, S, wave);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((d->grad_size + 255) / 256 < 1024 ? (d->grad_size + 255) / 256 : 1024);
  reduce_partials<<<blocks, 256, 0, st>>>(partial, grads, d->grad_size, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: the RGB train pass; see train_grads.
extern "C" int nerf_rgb_train_grads(const float* odv, const float* z, const float* gt,
                                    const float* params, const float* bparams,
                                    const TrainDesc* d, float* maps, float* weights,
                                    float* partial, float* workspace, float* grads, int R, int S,
                                    int grid, unsigned seed, float noise_std, int white_bkgd,
                                    void* stream) {
  return train_grads<kLoss, false>(odv, z, gt, nullptr, params, bparams, d, maps, weights,
                                   partial, workspace, grads, R, S, grid, seed, noise_std,
                                   white_bkgd, (cudaStream_t)stream);
}

// K6: the train render's backward from the maps' cotangent dmaps [R, 5 + sem]
// and the weights' dweights [R, S] (null: zero); d describes the semantic
// head's planes and gradients when d->f.sem_dim > 0; see train_grads.
extern "C" int nerf_train_render_grads(const float* odv, const float* z, const float* dmaps,
                                       const float* dweights, const float* params,
                                       const float* bparams, const TrainDesc* d, float* partial,
                                       float* workspace, float* grads, int R, int S, int grid,
                                       unsigned seed, float noise_std, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (d->f.sem_dim > 0)
    return train_grads<kCotangent, true>(odv, z, dmaps, dweights, params, bparams, d, nullptr,
                                         nullptr, partial, workspace, grads, R, S, grid, seed,
                                         noise_std, 0, st);
  return train_grads<kCotangent, false>(odv, z, dmaps, dweights, params, bparams, d, nullptr,
                                        nullptr, partial, workspace, grads, R, S, grid, seed,
                                        noise_std, 0, st);
}

// K10b: the mip train render's backward from the maps' cotangent dmaps
// [R, 5] and the weights' dweights [R, S] (null: zero), on odvr [R, 10] and
// fenceposts z [R, S + 1]: K6's kernels without the semantic head in their
// mip mode (the Gaussian and integrated-PE prologue, the mip composite);
// see train_grads.
extern "C" int nerf_mip_train_render_grads(const float* odvr, const float* z, const float* dmaps,
                                           const float* dweights, const float* params,
                                           const float* bparams, const TrainDesc* d,
                                           float* partial, float* workspace, float* grads, int R,
                                           int S, int grid, unsigned seed, float noise_std,
                                           void* stream) {
  return train_grads<kCotangent, false, true>(odvr, z, dmaps, dweights, params, bparams, d,
                                              nullptr, nullptr, partial, workspace, grads, R, S,
                                              grid, seed, noise_std, 0, (cudaStream_t)stream);
}
