// Device building blocks of the train kernels' reverse sweep, shared by the
// fused train kernels (train_render.cu: K3, K6, K9, K10a, K10b; K4's tile
// is wg_tile.cuh) and the
// field kernels (fused_field.cu: K8a-K8f, K11): the train descriptor and
// its workspace planes, the forward of one 64-point tile (storing what the
// reverse sweep reads), the input-gradient product of a layer (bwd_layer:
// wgmma 3xTF32, its matrix and dY through a ring of shared-memory stages
// filled by bulk copies), the weight-gradient product (wgrad), the reverse
// sweep of the field MLP from the per-point cotangents of its outputs, and
// the CTA-ordered reduction of the partial gradients.
#pragma once

#include "tile_mlp.cuh"
#include "wgmma.cuh"

constexpr int kMaxPlanes = 10 + kMaxLayers;

// Host-visible: the C entry point takes a TrainDesc*.
struct TrainDesc {
  MLPDesc f;                    // the forward layers (ops/fused_render.pack_field)
  LayerDesc bwd[kMaxLayers];    // dX matrices (pack_train_bwd), by forward layer index:
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
  LayerDesc ibwd[kMaxLayers];   // K8c: the emb (views: view-PE) columns of each layer that
                                //   reads them (pack_input_bwd), by forward layer index
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

// One input of a weight-gradient product: up to two planes, in row order.
struct XSegs {
  int p[3];
  int n;
};

constexpr int kWgM = 128, kWgN = 128;  // dW macro tile: 4 x 4 warps of 32 x 32
constexpr int kLdS = 68;               // staged row stride (floats), = 4 mod 32
constexpr int kStageFloats = (kWgM + kWgN) * kLdS;
// The backward ring of bwd_layer: kBwdStages stages, each one k step s of a
// product: the k-slice of its matrix (16 N floats: the TF32 high parts, then
// the low parts, N <= kBwdMaxN), in slot j the 8 dY rows of that k step of
// the round's j-th 64-point sub ([8][kLd], as the plane holds them), and in
// gate slot j that sub's rows 8 s .. 8 s + 7 of the gate plane (when the
// product has a k-slice for every 8 outputs: the trunk, alpha's slot).
constexpr int kBwdMaxN = 256;
constexpr int kBwdSlot = 8 * kLd;
constexpr int kBwdGate = 16 * kBwdMaxN + 4 * kBwdSlot;  // the gate slots' offset
constexpr int kBwdStageFloats = kBwdGate + 4 * kBwdSlot;
constexpr int kBwdStages = 4;
// The reverse kernel's shared memory: the ring's barriers (128 B), then the
// stages that wgrad (two of kStageFloats) and the ring take in turn.
constexpr int kStagingFloats = kBwdStages * kBwdStageFloats > 2 * kStageFloats
                                   ? kBwdStages * kBwdStageFloats
                                   : 2 * kStageFloats;
constexpr int kReverseSmem = 128 + kStagingFloats * (int)sizeof(float);

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

// The reverse kernel's view of the backward ring: stage pos (counted over
// the kernel's run) lies in slot pos % kBwdStages, and its fill completes
// phase (pos / kBwdStages) & 1 of that slot's full barrier; each of the
// CTA's 16 warps arrives on the slot's empty barrier once it is done with
// the stage.
struct BwdRing {
  uint64_t* full;
  uint64_t* empty;
  float* stages;
};

// bwd_layer at a piece width NP (N / NP pieces of N, 1 or 2): the CTA's
// four warpgroups take units (sub, piece) in rounds, warpgroup w unit
// 4 r + w of round r (sub 4 r / np + w / np, piece w % np), and every
// warpgroup walks each round's nk k steps, whether it has a unit or not.
// The first thread of each warpgroup is also a producer, in turns (step s
// is warpgroup s % 4's): each k step one of them fills the stage
// kBwdStages - 1 steps ahead (once every warp has released it) with the
// matrix's k-slice, the dY rows of the round's subs and their gate rows,
// one bulk copy each; the copies' issue is spread over the four
// warpgroups rather than delaying one of them every step. A gate that comes
// through the ring is read once, as 4 bits a thread a k step (the relu
// signs of its accumulators' outputs of that step's rows), so the epilogue
// waits on no load of it: an epilogue that loads no gate took K6 at
// 32768 x 192 from 567 to 528 ms (results wrong; H100,
// nerfsos_torch/tools/tile_probe.py).
template <int NP, bool kAccum>
__device__ __forceinline__ int bwd_pieces(const float* __restrict__ src, int N, int nk,
                                          int ldn, float* ws, const TrainDesc& d, int p0,
                                          int p1, int out, int gate, int nsub,
                                          const BwdRing& br, int pos) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * w + g;  // the thread's accumulator rows: points m0 and m0 + 8
  const int np = N / NP, per = 4 / np;  // pieces of N; subs a round
  const int rounds = (nsub + per - 1) / per, total = rounds * nk, k0 = d.rows[p0];
  const bool ring_gate = gate >= 0 && nk * 8 >= ldn;
  auto fill = [&](int f) {  // step f of the call
    const int r = f / nk, s = f - r * nk, at = pos + f, slot = at % kBwdStages;
    while (!mbar_try_wait(br.empty + slot, ((at / kBwdStages) & 1) ^ 1)) {
    }
    const int nlive = min(per, nsub - r * per), row = 8 * s;
    const int p = row < k0 ? p0 : p1, rr = row < k0 ? row : row - k0;
    const bool gr = ring_gate && row < ldn;
    float* st = br.stages + (size_t)slot * kBwdStageFloats;
    mbar_expect_tx(br.full + slot, (uint32_t)(N * 64 + nlive * kBwdSlot * (gr ? 8 : 4)));
    bulk_g2s(st, src + (size_t)s * 16 * N, N * 64, br.full + slot);
    for (int u = 0; u < nlive; ++u) {
      const int sub = r * per + u;
      bulk_g2s(st + 16 * kBwdMaxN + u * kBwdSlot, plane(ws, d, p, sub) + rr * kLd,
               kBwdSlot * 4, br.full + slot);
      if (gr)
        bulk_g2s(st + kBwdGate + u * kBwdSlot, plane(ws, d, gate, sub) + row * kLd,
                 kBwdSlot * 4, br.full + slot);
    }
  };
  if (tid == 0)
    for (int f = 0; f < min(kBwdStages - 1, total); ++f) fill(f);
  __syncwarp();
  const int j = wg / np, n0 = (wg % np) * NP;
  int step = 0;
  for (int r = 0; r < rounds; ++r) {
    const int sub = r * per + j;
    const bool live = sub < nsub;
    uint32_t mlo = 0u, mhi = 0u;  // ring_gate: bit 4 q + e of output group q, accumulator e
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < nk; ++s, ++step) {
      if (tid == 128 * (step & 3) && step + kBwdStages - 1 < total) fill(step + kBwdStages - 1);
      __syncwarp();
      const int at = pos + step, slot = at % kBwdStages;
      while (!mbar_try_wait(br.full + slot, (at / kBwdStages) & 1)) {
      }
      if (live) {
        // A fragment: a0 (point m0, k t), a1 (m0 + 8, t), a2 (m0, t + 4), a3 (m0 + 8, t + 4),
        // split as split() does; its registers are rewritten only after the
        // last step's products are done (wait_group 0)
        const float* st = br.stages + (size_t)slot * kBwdStageFloats;
        const float* a = st + 16 * kBwdMaxN + j * kBwdSlot + t * kLd + m0;
        uint32_t ahi[4], alo[4];
        split(a[0], ahi[0], alo[0]);
        split(a[8], ahi[1], alo[1]);
        split(a[4 * kLd], ahi[2], alo[2]);
        split(a[4 * kLd + 8], ahi[3], alo[3]);
        const uint64_t bhi = b_desc(st + n0 * 8), blo = b_desc(st + (N + n0) * 8);
        wgmma_fence();
        Wgmma<NP>::mma(acc, alo, bhi);
        Wgmma<NP>::mma(acc, ahi, blo);
        Wgmma<NP>::mma(acc, ahi, bhi);
        wgmma_commit();
        const int q = s - n0 / 8;  // the output group whose gate rows this step holds
        if (ring_gate && q >= 0 && q < NP / 8 && 8 * s < ldn) {
          const float* gt = st + kBwdGate + j * kBwdSlot + 2 * t * kLd + m0;
          const uint32_t bits = (gt[0] > 0.f) | (gt[kLd] > 0.f) << 1 | (gt[8] > 0.f) << 2 |
                                (gt[kLd + 8] > 0.f) << 3;
          if (q < 8) {
            mlo |= bits << (4 * q);
          } else {
            mhi |= bits << (4 * (q - 8));
          }
        }
        wgmma_wait<0>();
      }
      if (lane == 0) mbar_arrive(br.empty + slot);  // the stage is free
    }
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    // accumulator i: point m0 + 8 ((i >> 1) & 1), output n0 + 8 (i >> 2) + 2 t + (i & 1);
    // dense()'s epilogue: kAccum adds out's value, then the gate (the
    // ring's bits, or loaded), then the store of the plane's rows n < ldn
    // (the matrices' bias is zero)
    float* o = plane(ws, d, out, sub) + (size_t)n0 * kLd + m0;
    const float* gp =
        gate >= 0 && !ring_gate ? plane(ws, d, gate, sub) + (size_t)n0 * kLd + m0 : nullptr;
#pragma unroll
    for (int q = 0; q < NP / 8; ++q) {
      if (n0 + 8 * q >= ldn) break;
      const int n = 8 * q + 2 * t;
      float* r0 = o + n * kLd;
      float* r1 = r0 + kLd;
      float v[4] = {acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]};
      if (kAccum) {
        v[0] += r0[0];
        v[1] += r1[0];
        v[2] += r0[8];
        v[3] += r1[8];
      }
      if (gp) {
        const float* g0 = gp + n * kLd;
        v[0] = g0[0] > 0.f ? v[0] : 0.f;
        v[1] = g0[kLd] > 0.f ? v[1] : 0.f;
        v[2] = g0[8] > 0.f ? v[2] : 0.f;
        v[3] = g0[kLd + 8] > 0.f ? v[3] : 0.f;
      }
      if (ring_gate) {
        const uint32_t bits = (q < 8 ? mlo : mhi) >> (4 * (q & 7));
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (bits >> e) & 1u ? v[e] : 0.f;
      }
      r0[0] = v[0];
      r1[0] = v[1];
      r0[8] = v[2];
      r1[8] = v[3];
    }
  }
  return pos + total;
}

// out(sub) = W dY(sub) for every 64-point sub of the chunk, gated by the
// relu derivative of gate(sub) when gate >= 0: the input-gradient product
// of one layer, L's matrix W^T [k = dY rows][n] (pack_train_bwd) as the
// ring buffer holds it from src (pack_bwd_ring: per k-slice of 8 rows, the
// TF32 high then low parts in wgmma's K-major B layout, N = its wgmma
// width). dY is up to two planes of rows (p0 then p1). On wgmma m64nNPk8
// in 3xTF32 (lo x hi, hi x lo, hi x hi), A = a sub's dY from the stage in
// registers, B = the stage's slice, in pieces of NP = min(N, 128) outputs
// (64 accumulators a thread under the kernel's 128 registers). kAccum:
// the product is added to what out holds (before the gate). Returns the
// ring position after the layer's stages. One function with no calls, so
// ptxas keeps the wgmma pipeline.
template <bool kAccum = false>
__device__ __noinline__ int bwd_layer(const float* __restrict__ src, int N, const LayerDesc L,
                                      float* ws, const TrainDesc& d, int p0, int p1, int out,
                                      int gate, int nsub, const BwdRing br, int pos) {
  // the planes' stores and wgrad's use of the stages before the bulk copies
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  const int nk = L.k / 8, ldn = pad8(L.n);
  switch (N) {
    case 256:
    case 128:
      pos = bwd_pieces<128, kAccum>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos);
      break;
    case 64:
      pos = bwd_pieces<64, kAccum>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos);
      break;
    case 32:
      pos = bwd_pieces<32, kAccum>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos);
      break;
    case 16:
      pos = bwd_pieces<16, kAccum>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos);
      break;
    default:
      pos = bwd_pieces<8, kAccum>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos);
  }
  __syncthreads();  // out is whole before wgrad or the next product reads it
  return pos;
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

// Zero the padding rows of a tile's emb and demb buffers, which nothing else writes.
__device__ __forceinline__ void zero_pad_rows(float* tile, const MLPDesc& f) {
  const int E = f.emb_dim, Ep = pad8(E), Ed = f.demb_dim, Edp = pad8(Ed);
  for (int i = threadIdx.x; i < (Ep - E) * kLd; i += kThreads) tile[E * kLd + i] = 0.f;
  for (int i = threadIdx.x; i < (Edp - Ed) * kLd; i += kThreads) tile[(Ep + Ed) * kLd + i] = 0.f;
}

// Copy a [rows][kLd] tile (64 points a row) from shared memory to the workspace.
__device__ __forceinline__ void store_tile(const float* src, float* dst, int rows) {
  for (int c = threadIdx.x; c < rows * (kPts / 4); c += kThreads) {
    const int r = c / (kPts / 4), q = (c % (kPts / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * kLd + q) =
        *reinterpret_cast<const float4*>(src + r * kLd + q);
  }
}


// Where the per-point outputs of a tile go: point q's sigma at
// out[q * cs + sig], its rgb logits at out[q * cs + rgb ..] and its
// semantics at out[q * cs + sem ..].
struct OutCols {
  int cs, sig, rgb, sem;
};

// Forward of one 64-point tile (points sub * 64 .. of a chunk of nq points),
// as the render kernel K2 computes it. fill(emb, demb, g, q0) writes the raw
// inputs of points q0 .. q0 + 63 of the chunk, zero past nq: emb rows 0-2
// the point and demb rows 0-2 its view direction, or with kIpe the
// Gaussian's means and variances in rows 0-5 of g (the first layer buffer,
// which layer 0 overwrites) and the view direction. Then their PE (kIpe:
// the integrated PE, ipe_rows), the trunk and the heads run on activations
// in shared memory (emb, demb and two layer buffers at `tile`); point q's
// outputs go to out (OutCols; out null: none are written). kHeads = false:
// the trunk and the alpha head alone, with no view encoding. kStore (K3,
// K6, K8c/K8f): every activation the reverse sweep reads is also stored to
// the workspace; kSemAct (K6, K8c/K8f): the semantic head's hidden
// activation too (plane P_ACT0 + depth). semin (may be null, as every
// caller's is since K4 has its own tile, wg_tile.cuh): the semantic head's
// input [h; emb] of each point is written as a row of semin [P][C] (C its
// unpadded width), point q of the chunk at row base + q.
template <bool kStore, bool kSemAct, bool kIpe, bool kHeads, class Fill>
__device__ __forceinline__ void forward_tile(const Fill& fill, const float* __restrict__ params,
                                             const TrainDesc& d, float* ws, float* out,
                                             OutCols oc, float* tile, int nq, int sub,
                                             float* __restrict__ semin, long long base) {
  const MLPDesc& f = d.f;
  const int depth = f.depth, E = f.emb_dim, Ep = pad8(E), Ed = f.demb_dim, Edp = pad8(Ed);
  const int sem = f.sem_dim;
  const LayerDesc* head = f.layer + depth;  // alpha, feature, views, rgb, sem_0, sem_1
  const int q0 = sub * kPts;
  float* emb = tile;
  float* demb = emb + Ep * kLd;
  float* hA = demb + Edp * kLd;
  float* hB = hA + f.hrows * kLd;
  fill(emb, demb, hA, q0);
  __syncthreads();
  if (kIpe) {
    ipe_rows(emb, hA, E);
  } else {
    pe_rows(emb, E);
  }
  if (kHeads) pe_rows(demb, Ed);
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
    float* dst = semin + (base + q0) * C;
    for (int e = threadIdx.x; e < np * C; e += kThreads) {
      const int p = e / C, col = e % C;
      dst[e] = col < k0 ? in0.a[col * kLd + p]
             : col < k0 + k1 ? in1.a[(col - k0) * kLd + p]
                             : emb[(col - k0 - k1) * kLd + p];
    }
  }
  if (out) dense_small(params, head[0], in0, in1, none(), out, q0, nq, oc.cs, oc.sig);  // sigma
  if (!kHeads) {
    __syncthreads();
    return;
  }
  if (sem) {
    const Seg coord = f.sem_with_coord ? Seg{emb, Ep} : none();
    dense_call(params, head[4], in0, in1, coord, spare, true);
    __syncthreads();
    if (kSemAct) store_tile(spare, plane(ws, d, P_ACT0 + depth, sub), pad8(head[4].n));
    if (out)
      dense_small(params, head[5], Seg{spare, pad8(head[4].n)}, none(), none(), out, q0, nq,
                  oc.cs, oc.sem);
    __syncthreads();
  }
  dense_call(params, head[1], in0, in1, none(), spare, false);  // feature
  __syncthreads();
  if (kStore) store_tile(spare, plane(ws, d, P_FEAT, sub), pad8(head[1].n));
  dense_call(params, head[2], Seg{spare, pad8(head[1].n)}, Seg{demb, Edp}, none(), cur,
             true);  // views (h is no longer needed)
  __syncthreads();
  if (kStore) store_tile(cur, plane(ws, d, P_HV, sub), pad8(head[2].n));
  if (out)
    dense_small(params, head[3], Seg{cur, pad8(head[2].n)}, none(), none(), out, q0, nq, oc.cs,
                oc.rgb);
  __syncthreads();
}

// The chain rule of the PE for the chunk's nq points: from the cotangent
// of a PE buffer (plane pg: rows 3 + 6 b + 3 h + c of sin(2^b x_c + h pi/2),
// rows 0-2 of x itself) and the stored x (rows 0-2 of plane pe),
// out[base + q][c] = g[c] + sum over b, h of (g[3 + 6 b + 3 h + c]
// cos(2^b x_c + h pi/2)) 2^b, the phase rounded as pe_rows rounds it.
__device__ void pe_grads(float* ws, const TrainDesc& d, int pe, int pg, int rows,
                         float* __restrict__ out, long long base, int nq) {
  const int F = (rows - 3) / 6;
  for (int e = threadIdx.x; e < nq * 3; e += kThreads) {
    const int q = e / 3, c = e % 3, sub = q / kPts, p = q % kPts;
    const float* g = plane(ws, d, pg, sub) + p;
    const float x = plane(ws, d, pe, sub)[c * kLd + p];
    float acc = 0.f;
    for (int b = 0; b < F; ++b) {
      const float freq = ldexpf(1.f, b);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float phase = __fadd_rn(__fmul_rn(freq, x), h ? 1.57079632679489661923f : 0.f);
        acc += (g[(3 + 6 * b + 3 * h + c) * kLd] * cosf(phase)) * freq;
      }
    }
    out[(base + q) * 3 + c] = g[c * kLd] + acc;
  }
}

// Wave `wave` of the reverse sweep, on the chunk the forward left in
// workspace slice b: rgb, views, feature + alpha, with kSem (K6, K8c/K8f)
// the semantic head, then the trunk; dW/db add into CTA b's partial
// gradients (zeroed in wave 0). Every input-gradient product is bwd_layer's,
// its matrix from bring as br describes (pack_bwd_ring, by forward layer
// index). kInGrad (K8c): the cotangent of the point PE is gathered in plane
// P_ACT0 + depth + 3 (zeroed by the forward) from every layer that reads emb
// (layer 0, the layer after the skip, sem_0's coordinates, and feature and
// alpha when the skip follows the last layer; their emb columns in iring as
// bi describes, d.ibwd by forward layer index), the view PE's from the views
// layer's (plane P_ACT0 + depth + 4), and both run back through the PE's
// chain rule into dpts and ddirs [R * S, 3].
template <bool kSem, bool kInGrad = false>
__global__ void __launch_bounds__(kThreads, 1)
    train_reverse_kernel(const float* __restrict__ bring, const float* __restrict__ iring,
                         const __grid_constant__ TrainDesc d, const __grid_constant__ RingDesc br,
                         const __grid_constant__ RingDesc bi, float* __restrict__ partial,
                         float* __restrict__ workspace, int R, int S, int wave,
                         float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ __align__(128) unsigned char rev_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(rev_raw);
  float* stages = reinterpret_cast<float*>(rev_raw + 128);
  const BwdRing ring{full, full + kBwdStages, stages};
  const MLPDesc& f = d.f;
  const int rpc = d.rays_per_chunk;
  const int c = wave * gridDim.x + blockIdx.x;
  float* gpart = partial + (size_t)blockIdx.x * d.grad_size;
  if (wave == 0) {
    for (size_t i = threadIdx.x; i < (size_t)d.grad_size; i += kThreads) gpart[i] = 0.f;
    __syncthreads();
  }
  if (c * rpc >= R) return;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwdStages; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, kThreads / 32);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  const int depth = f.depth, ldw = pad8(f.layer[0].n);
  const int nq = min(rpc, R - c * rpc) * S, nsub = (nq + kPts - 1) / kPts;
  const int k_alpha = depth, k_feat = depth + 1, k_views = depth + 2, k_rgb = depth + 3;
  const int p_gemb = P_ACT0 + depth + 3, p_gdemb = p_gemb + 1;
  int pos = 0;  // the ring's stages so far
  // layer i's input-gradient product (in: its emb columns, K8c), added into
  // out's values with add
  auto dx = [&](bool add, bool in, int i, int p0, int p1, int out, int gate) {
    const float* src = in ? iring + bi.off[i] : bring + br.off[i];
    const int N = in ? bi.ncols[i] : br.ncols[i];
    const LayerDesc L = in ? d.ibwd[i] : d.bwd[i];
    pos = add ? bwd_layer<true>(src, N, L, ws, d, p0, p1, out, gate, nsub, ring, pos)
              : bwd_layer<false>(src, N, L, ws, d, p0, p1, out, gate, nsub, ring, pos);
  };

  // ---- reverse sweep: rgb, views, feature + alpha, trunk
  wgrad(ws, d, XSegs{{P_HV, 0}, 1}, P_DRGB, pad8(3), gpart + d.gw[k_rgb], gpart + d.gb[k_rgb],
        nsub, stages);
  dx(false, false, k_rgb, P_DRGB, -1, P_DPV, P_HV);
  wgrad(ws, d, XSegs{{P_FEAT, P_DEMB}, 2}, P_DPV, pad8(f.layer[k_views].n),
        gpart + d.gw[k_views], gpart + d.gb[k_views], nsub, stages);
  dx(false, false, k_views, P_DPV, -1, P_DFEAT, -1);
  if (kInGrad) dx(false, true, k_views, P_DPV, -1, p_gdemb, -1);
  const int last = P_ACT0 + depth - 1;
  const XSegs h = (f.skip == depth - 1) ? XSegs{{P_EMB, last}, 2} : XSegs{{last, 0}, 1};
  wgrad(ws, d, h, P_DFEAT, ldw, gpart + d.gw[k_feat], gpart + d.gb[k_feat], nsub, stages);
  wgrad(ws, d, h, P_DSIG, 8, gpart + d.gw[k_alpha], gpart + d.gb[k_alpha], nsub, stages);
  dx(false, false, k_alpha, P_DFEAT, P_DSIG, P_DA, last);
  if (kInGrad && d.ibwd[k_alpha].k > 0) dx(true, true, k_alpha, P_DFEAT, P_DSIG, p_gemb, -1);
  if (kSem) {  // sem_1, ds, sem_0, and sem_0's input gradient on h added into P_DA
    const int k_s0 = depth + 4, k_s1 = depth + 5;
    const int p_sact = P_ACT0 + depth, p_dsem = p_sact + 1, p_ds = p_sact + 2;
    wgrad(ws, d, XSegs{{p_sact, 0, 0}, 1}, p_dsem, pad8(f.layer[k_s1].n), gpart + d.gw[k_s1],
          gpart + d.gb[k_s1], nsub, stages);
    dx(false, false, k_s1, p_dsem, -1, p_ds, p_sact);
    XSegs in = h;
    if (f.sem_with_coord) in.p[in.n++] = P_EMB;
    wgrad(ws, d, in, p_ds, pad8(f.layer[k_s0].n), gpart + d.gw[k_s0], gpart + d.gb[k_s0], nsub,
          stages);
    dx(true, false, k_s0, p_ds, -1, P_DA, last);
    if (kInGrad && d.ibwd[k_s0].k > 0) dx(true, true, k_s0, p_ds, -1, p_gemb, -1);
  }
  int cur = P_DA;
  for (int i = depth - 1; i >= 0; --i) {
    const XSegs in = (i == 0) ? XSegs{{P_EMB, 0}, 1}
                     : (i - 1 == f.skip) ? XSegs{{P_EMB, P_ACT0 + i - 1}, 2}
                                         : XSegs{{P_ACT0 + i - 1, 0}, 1};
    wgrad(ws, d, in, cur, ldw, gpart + d.gw[i], gpart + d.gb[i], nsub, stages);
    if (kInGrad && (i == 0 || i - 1 == f.skip)) dx(true, true, i, cur, -1, p_gemb, -1);
    const int nxt = (cur == P_DA) ? P_DB : P_DA;
    if (i > 0) dx(false, false, i, cur, -1, nxt, P_ACT0 + i - 1);
    cur = nxt;
  }
  if (kInGrad) {
    const long long base = (long long)c * rpc * S;
    pe_grads(ws, d, P_EMB, p_gemb, f.emb_dim, dpts, base, nq);
    pe_grads(ws, d, P_DEMB, p_gdemb, f.demb_dim, ddirs, base, nq);
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

// shared memory of a forward tile: emb, demb and two layer buffers
inline int tile_smem(const MLPDesc& f) {
  return (int)((size_t)((f.emb_dim + 7) / 8 * 8 + (f.demb_dim + 7) / 8 * 8 + 2 * f.hrows) * kLd *
               sizeof(float));
}

// Launch configuration of reduce_partials over n floats.
inline int reduce_blocks(long long n) {
  return (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
}

}  // namespace
