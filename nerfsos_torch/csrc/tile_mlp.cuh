// Device building blocks shared by the train kernels (train_render.cu) and
// the field kernels (fused_field.cu): the packed-layer descriptor, the
// 3xTF32 tensor-core dense layer over a 64-point tile on mma.sync (dense();
// its last user is the field backward's forward, train_sweep.cuh
// forward_tile), the in-kernel positional encoding of such a tile and
// mip-NeRF's cone-frustum Gaussians (frustum_gauss, which K4's tile builds
// in its mip mode).
//
// Activations are feature-major tiles: [feature][point], row stride kLd
// floats, 64 points a tile. A layer reads up to three input segments in
// order (a concatenation that is never materialised); every segment and
// every output width is padded to a multiple of 8 rows (zero rows here,
// zero rows/columns in the packed W^T), so the mma loop has no masks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxLayers = 16;

// Host-visible (external linkage): the C entry points take an MLPDesc*.
struct LayerDesc {
  long long w;  // offset of W^T [k][pad8(n)] (row-major, segments padded) in the buffer,
                // followed by its TF32 high parts and TF32 low parts, same shape
  long long b;  // offset of the bias [pad8(n)]
  int k;        // input rows including the segment padding
  int n;        // outputs
};

struct MLPDesc {
  LayerDesc layer[kMaxLayers];  // trunk 0..depth-1, alpha, feature, views, rgb, sem_0, sem_1
  int depth;
  int skip;            // trunk index after which [emb, h] is concatenated
  int hrows;           // rows of each activation buffer (max padded layer width)
  int emb_dim;         // 3 + 6 * multires (mip-NeRF's integrated PE: 6 * multires)
  int demb_dim;        // 3 + 6 * multires_views
  int sem_dim;         // 0 without the semantic head
  int sem_with_coord;
};

namespace {

constexpr int kPts = 64;          // points per tile
constexpr int kLd = 72;           // tile row stride (floats), = 8 mod 32
constexpr int kThreads = 512;
constexpr int kWarpsN = kThreads / 64;  // warps along the outputs (two along the points)
constexpr int kTilesN = 32 / kWarpsN;   // n8 tiles per warp (N <= 256)
constexpr int kMaxSem = 8;

struct Seg {
  const float* a;  // [k][kLd] feature-major activations
  int k;
};

__device__ __forceinline__ Seg none() { return Seg{nullptr, 0}; }

__device__ __forceinline__ int pad8(int x) { return (x + 7) & ~7; }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ~= hi + lo with both parts TF32: the 3xTF32 operand split
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One pipeline stage of dense(): raw A values (2 m16 tiles x 4) and the
// pre-split B fragments (kTilesN n8 tiles x {b0 hi, b1 hi, b0 lo, b1 lo}).
struct Stage {
  float a[8];
  float b[kTilesN][4];
};

__device__ __forceinline__ void load_stage(Stage& st, int ks, Seg s0, Seg s1, Seg s2, int n1,
                                           int n2, const float* __restrict__ whi,
                                           const float* __restrict__ wlo, int ldn, int ntiles,
                                           int m0, int wn, int g, int t) {
  const float* a;
  int k0;
  if (ks < n1) {
    a = s0.a, k0 = ks * 8;
  } else if (ks < n2) {
    a = s1.a, k0 = (ks - n1) * 8;
  } else {
    a = s2.a, k0 = (ks - n2) * 8;
  }
  const float* ap = a + (k0 + t) * kLd + m0 + g;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    st.a[mt * 4 + 0] = ap[mt * 16];
    st.a[mt * 4 + 1] = ap[mt * 16 + 8];
    st.a[mt * 4 + 2] = ap[4 * kLd + mt * 16];
    st.a[mt * 4 + 3] = ap[4 * kLd + mt * 16 + 8];
  }
  const size_t row = (size_t)(ks * 8 + t) * ldn + g;  // segments are padded to 8 rows
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) {
    const int tile = wn + kWarpsN * j;
    if (tile < ntiles) {
      const size_t o = row + tile * 8;
      st.b[j][0] = __ldg(whi + o);
      st.b[j][1] = __ldg(whi + o + 4 * ldn);
      st.b[j][2] = __ldg(wlo + o);
      st.b[j][3] = __ldg(wlo + o + 4 * ldn);
    }
  }
}

// The three products of each tile (lo*hi, hi*lo, hi*hi) go out in three
// passes over the tiles, so no mma waits on the one just before it (H100,
// 8192 rays x 192 samples: K2 66.8 -> 62.0 ms against one tile at a time).
__device__ __forceinline__ void mma_stage(float (&acc)[2][kTilesN][4], const Stage& st,
                                          int ntiles, int wn) {
  uint32_t ahi[2][4], alo[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(st.a[mt * 4 + i], ahi[mt][i], alo[mt][i]);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int j = 0; j < kTilesN; ++j) {
      if (wn + kWarpsN * j < ntiles) {
        const int hi0 = pass == 1 ? 2 : 0;
        const uint32_t b0 = __float_as_uint(st.b[j][hi0]), b1 = __float_as_uint(st.b[j][hi0 + 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][j], pass == 0 ? alo[mt] : ahi[mt], b0, b1);
      }
    }
}

// out[n][p] = act(sum over the segments, in order, of a[k][p] * W^T[k][n] + b[n])
// for all n < pad8(N) (padded columns come out 0). Tensor cores, 3xTF32, with
// the TF32 high/low parts of W^T split on the host. Warp w owns points
// 32 (w & 1) .. +32 and the n8 tiles w/2 + kWarpsN j; k steps of 8 are
// pipelined two deep (the next step's loads are in flight during this
// step's mma).
__device__ __forceinline__ void dense(const float* __restrict__ params, const LayerDesc L,
                                      Seg s0, Seg s1, Seg s2, float* out, bool relu) {
  const int ldn = pad8(L.n), ntiles = ldn / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 32, wn = warp >> 1;
  const size_t wsz = (size_t)L.k * ldn;
  const float* __restrict__ whi = params + L.w + wsz;
  const float* __restrict__ wlo = whi + wsz;
  const int n1 = s0.k / 8, n2 = n1 + s1.k / 8, nsteps = n2 + s2.k / 8;
  float acc[2][kTilesN][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kTilesN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  Stage st0, st1;
  load_stage(st0, 0, s0, s1, s2, n1, n2, whi, wlo, ldn, ntiles, m0, wn, g, t);
  for (int ks = 0; ks < nsteps; ks += 2) {
    if (ks + 1 < nsteps)
      load_stage(st1, ks + 1, s0, s1, s2, n1, n2, whi, wlo, ldn, ntiles, m0, wn, g, t);
    mma_stage(acc, st0, ntiles, wn);
    if (ks + 1 >= nsteps) break;
    if (ks + 2 < nsteps)
      load_stage(st0, ks + 2, s0, s1, s2, n1, n2, whi, wlo, ldn, ntiles, m0, wn, g, t);
    mma_stage(acc, st1, ntiles, wn);
  }
  // epilogue in two passes: bias and relu in registers, then the stores
  const float* __restrict__ bias = params + L.b;
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) {
    const int tile = wn + kWarpsN * j;
    if (tile < ntiles) {
      const int n = tile * 8 + 2 * t;
      const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = m0 + mt * 16 + g;
        float* v = acc[mt][j];
        v[0] += b0;
        v[1] += b1;
        v[2] += b0;
        v[3] += b1;
        if (relu) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) {
    const int tile = wn + kWarpsN * j;
    if (tile < ntiles) {
      const int n = tile * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = m0 + mt * 16 + g;
        out[n * kLd + p] = acc[mt][j][0];
        out[(n + 1) * kLd + p] = acc[mt][j][1];
        out[n * kLd + p + 8] = acc[mt][j][2];
        out[(n + 1) * kLd + p + 8] = acc[mt][j][3];
      }
    }
  }
}

// Rows 3.. of a PE buffer whose rows 0-2 hold x: row 3 + 6 b + 3 h + c holds
// sin(2^b * x_c + h * pi/2), the column order of core/encoding.py.
__device__ void pe_rows(float* buf, int rows) {
  for (int t = threadIdx.x; t < (rows - 3) * kPts; t += kThreads) {
    const int f = t / kPts, p = t % kPts;
    const int band = f / 6, r = f % 6, c = r % 3;
    const float phase = (r >= 3) ? 1.57079632679489661923f : 0.f;
    const float freq = ldexpf(1.f, band);
    buf[(3 + f) * kLd + p] = sinf(__fadd_rn(__fmul_rn(freq, buf[c * kLd + p]), phase));
  }
}

// The cone frustum between t0 and t1 of ray = (o, d, viewdirs, radius) as
// a diagonal Gaussian, channel c: the mean o_c + d_c t_mean and the
// variance t_var d_c^2 + r_var (1 - d_c^2 / max(1e-10, |d|^2)), with
// models/mip.py's stable closed forms (frustum_moments, lift_gaussian,
// cast_rays) in their op order, one rounding each (no FMA contraction), so
// the means the integrated PE multiplies by up to 2^9 are bit-identical to
// the plain version's.
__device__ __forceinline__ void frustum_gauss(const float* ray, float t0, float t1, int c,
                                              float& mean, float& var) {
  const float k4_15 = (float)(4.0 / 15.0), k5_12 = (float)(5.0 / 12.0);
  const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
  const float hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
  const float hw2 = __fmul_rn(hw, hw), hw4 = __fmul_rn(hw2, hw2);
  const float denom = __fadd_rn(__fmul_rn(__fmul_rn(3.f, mu), mu), hw2);
  const float t_mean =
      __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, mu), hw), hw), denom));
  const float t_var = __fsub_rn(
      __fdiv_rn(hw2, 3.f),
      __fmul_rn(k4_15, __fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(__fmul_rn(12.f, mu), mu), hw2)),
                                 __fmul_rn(denom, denom))));
  const float rad = ray[9];
  const float r_var = __fmul_rn(
      __fmul_rn(rad, rad),
      __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(mu, mu), 4.f), __fmul_rn(__fmul_rn(k5_12, hw), hw)),
                __fdiv_rn(__fmul_rn(k4_15, hw4), denom)));
  const float d_mag_sq = fmaxf(1e-10f, __fadd_rn(__fadd_rn(__fmul_rn(ray[3], ray[3]),
                                                           __fmul_rn(ray[4], ray[4])),
                                                 __fmul_rn(ray[5], ray[5])));
  const float dd = __fmul_rn(ray[3 + c], ray[3 + c]);
  mean = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], t_mean));
  var = __fadd_rn(__fmul_rn(t_var, dd), __fmul_rn(r_var, __fsub_rn(1.f, __fdiv_rn(dd, d_mag_sq))));
}

}  // namespace
