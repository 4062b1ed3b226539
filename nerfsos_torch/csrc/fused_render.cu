// The coarse eval render kernel for Hopper (sm_90a): the density trunk and
// the volumetric composite in one kernel.
//
// Replaces K1 of nerfsos_tpu/ops/pallas/fused_render.py:
//   fused_coarse_weights_planar -> _sigma_weights_kernel (coarse pass:
//   points o + d*z, PE, depth x W skip trunk, alpha head, composite ->
//   weights [R, S]).
// K2 (fused_render_planar -> _render_kernel, the fine pass) is K4's kernel
// without noise or sem_in (train_render.cu train_render_wg_kernel on
// wg_tile.cuh's 128-point tile), launched by ops/fused_render.fused_render.
//
// What bounds it on the H100: arithmetic. At the flagship shape (8 x 256
// trunk, multires 10) a coarse point costs ~1 MFLOP; the only device-memory
// traffic is od and z in and the weights out, so the kernel is compute
// bound by three orders of magnitude. Every 64-point tile re-reads the layer
// weights (3 x ~2.4 MB fp32: W, its TF32 high and low parts) from L2/L1;
// that load latency, the in-kernel operand splits and register pressure
// (128 a thread at 512 threads) are what keep this version far from the
// tensor-core peak.
//
// What the design does about it (a first version, fp32 accuracy only):
//   * one CTA of 512 threads takes `rays_per_cta` rays and walks their
//     points in tiles of 64; activations stay in shared memory feature-major
//     ([feature][point], row stride 72: fragment loads are conflict-free);
//   * each trunk layer runs on the tensor cores as mma.sync m16n8k8 TF32 in
//     the 3xTF32 scheme: every fp32 operand is split into a TF32 high part
//     and a TF32 low part and the product is hi*hi + hi*lo + lo*hi,
//     accumulated in fp32, which keeps the result at fp32 accuracy (plain
//     TF32 would keep ~3 digits). The weights' parts are split once on the
//     host; the activations' in the kernel. A warp owns 32 points x up to 32
//     outputs; weights come from L2/L1 with __ldg, two k steps in flight;
//   * the alpha head uses one thread per point and plain fp32 FMAs;
//   * the skip concatenation [emb, h] is never materialised: a layer reads
//     up to three input segments in order. Every segment, and every layer's
//     output, is padded to a multiple of 8 rows (zero rows here, zero
//     rows/columns in the packed W^T), so the mma loop has no masks;
//   * per-point sigma goes to a per-CTA strip, and the composite runs from
//     shared memory in fp32 (exclusive product of e + 1e-10 per ray,
//     sequential).
// Precision: the points and the PE phases use explicit round-to-nearest
// multiplies and adds (no FMA contraction) and accurate sinf/expf; phases
// reach |x| * 2^9 radians, so no fast-math or tensor-core product touches
// them. No single-pass TF32 anywhere.

#include "tile_mlp.cuh"

namespace {

// K1: rays = od [R, 6]; writes the weights.
__global__ void __launch_bounds__(kThreads, 1)
    coarse_weights_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                          const float* __restrict__ params, const MLPDesc d,
                          float* __restrict__ weights, int R, int S, int rays_per_cta) {
  extern __shared__ float smem[];
  const int E = d.emb_dim, Ep = pad8(E);
  const int cs = 2;  // strip: sigma->alpha->w, y->T
  float* emb = smem;
  float* hA = emb + Ep * kLd;
  float* hB = hA + d.hrows * kLd;
  float* strip = hB + d.hrows * kLd;
  for (int t = threadIdx.x; t < (Ep - E) * kLd; t += kThreads) emb[E * kLd + t] = 0.f;

  const int r0 = blockIdx.x * rays_per_cta;
  const int nr = min(rays_per_cta, R - r0);
  const int nq = nr * S;
  const float* zc = z + (size_t)r0 * S;

  for (int q0 = 0; q0 < nq; q0 += kPts) {
    for (int t = threadIdx.x; t < 3 * kPts; t += kThreads) {
      const int c = t / kPts, p = t % kPts, q = q0 + p;
      float x = 0.f;
      if (q < nq) {
        const float* ray = rays + (size_t)(r0 + q / S) * 6;
        x = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zc[q]));
      }
      emb[c * kLd + p] = x;
    }
    __syncthreads();
    pe_rows(emb, E);
    __syncthreads();

    // trunk: layer i reads `in0, in1` and writes the buffer not holding h
    Seg in0{emb, Ep}, in1 = none();
    float* cur = hB;
    for (int i = 0; i < d.depth; ++i) {
      float* nxt = (cur == hA) ? hB : hA;
      dense(params, d.layer[i], in0, in1, none(), nxt, true);
      __syncthreads();
      cur = nxt;
      if (i == d.skip) {
        in0 = Seg{emb, Ep};
        in1 = Seg{cur, pad8(d.layer[i].n)};
      } else {
        in0 = Seg{cur, pad8(d.layer[i].n)};
        in1 = none();
      }
    }
    dense_small(params, d.layer[d.depth], in0, in1, none(), strip, q0, nq, cs, 0);  // sigma
    __syncthreads();
  }

  // composite: alpha and y = e + 1e-10 per point
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int s = q % S;
    const float* ray = rays + (size_t)(r0 + q / S) * 6;
    const float nd = sqrtf(ray[3] * ray[3] + ray[4] * ray[4] + ray[5] * ray[5]);
    const float dist = (s == S - 1) ? 1e10f : zc[q + 1] - zc[q];
    const float e = expf(-fmaxf(strip[q * cs], 0.f) * (dist * nd));
    strip[q * cs] = 1.f - e;
    strip[q * cs + 1] = e + 1e-10f;
  }
  __syncthreads();
  for (int rl = threadIdx.x; rl < nr; rl += kThreads) {  // exclusive product per ray
    float T = 1.f;
    for (int s = 0; s < S; ++s) {
      float* c = strip + (rl * S + s) * cs;
      const float y = c[1];
      c[1] = T;
      T *= y;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += kThreads)
    weights[(size_t)r0 * S + q] = strip[q * cs] * strip[q * cs + 1];
}

}  // namespace

extern "C" int nerf_coarse_weights(const float* od, const float* z, const float* params,
                                   const MLPDesc* d, float* weights, int R, int S,
                                   int rays_per_cta, void* stream) {
  const size_t smem = ((size_t)((d->emb_dim + 7) / 8 * 8 + 2 * d->hrows) * kLd +
                       (size_t)rays_per_cta * S * 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(coarse_weights_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (R + rays_per_cta - 1) / rays_per_cta;
  coarse_weights_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(od, z, params, *d, weights,
                                                                        R, S, rays_per_cta);
  return (int)cudaGetLastError();
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
