// Device building blocks shared by the train kernels (train_render.cu) and
// the field kernels (fused_field.cu): the packed-layer descriptor, the
// workspace tiles' geometry, the 3xTF32 operand split and mip-NeRF's
// cone-frustum Gaussians (frustum_gauss, which K4's tile builds in its mip
// mode). The layer products themselves are wgmma's (wg_tile.cuh for the
// forwards, train_sweep.cuh for the reverse sweep).
//
// The reverse sweep's activations are feature-major tiles: [feature][point],
// row stride kLd floats, 64 points a tile. Every input segment and every
// output width is padded to a multiple of 8 rows (zero rows here, zero
// rows/columns in the packed W^T), so the products have no masks.
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
  int bf16;            // 1: the bf16 mode (--compute_dtype bfloat16) of K4's tile (K1,
                       //   K2, K4) and of K3's and K6's kernels, the rings in
                       //   pack_ring's and pack_bwd_ring's bf16 layouts
};

namespace {

constexpr int kPts = 64;          // points per workspace tile
constexpr int kLd = 72;           // tile row stride (floats), = 8 mod 32
constexpr int kThreads = 512;     // a CTA of the reverse sweep
constexpr int kMaxSem = 8;

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
