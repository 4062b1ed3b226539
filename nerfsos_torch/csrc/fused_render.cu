// Fused eval render kernels for Hopper (sm_90a): field MLP + volumetric
// composite in one kernel per pass.
//
// Replaces two TPU kernels of nerfsos_tpu/ops/pallas/fused_render.py:
//   K1  fused_coarse_weights_planar -> _sigma_weights_kernel (coarse pass:
//       points o + d*z, PE, depth x W skip trunk, alpha head, composite ->
//       weights [R, S]);
//   K2  fused_render_planar -> _render_kernel (fine pass: PE(points) and
//       PE(viewdirs), trunk, alpha / feature / views / rgb heads, the 2-layer
//       semantic head, composite -> maps [R, 5 + sem] and weights [R, S]).
//
// What bounds it on the H100: arithmetic. At the flagship shape (8 x 256
// trunk, multires 10) a fine point costs ~1.27 MFLOP and a coarse point
// ~1 MFLOP; the only device-memory traffic is od/odv and z in, and weights
// and maps out (~1.5 KB per fine ray), so the kernel is compute bound by
// three orders of magnitude. Every 64-point tile re-reads the layer weights
// (3 x ~2.4 MB fp32: W, its TF32 high and low parts) from L2/L1; that load
// latency, the in-kernel operand splits and register pressure (128 a thread
// at 512 threads) are what keep this version far from the tensor-core peak.
//
// What the design does about it (a first version, fp32 accuracy only):
//   * one CTA of 512 threads takes `rays_per_cta` rays and walks their
//     points in tiles of 64; activations stay in shared memory feature-major
//     ([feature][point], row stride 72: fragment loads are conflict-free);
//   * each wide layer (trunk, feature, views, semantic hidden) runs on the
//     tensor cores as mma.sync m16n8k8 TF32 in the 3xTF32 scheme: every fp32
//     operand is split into a TF32 high part and a TF32 low part and the
//     product is hi*hi + hi*lo + lo*hi, accumulated in fp32, which keeps the
//     result at fp32 accuracy (plain TF32 would keep ~3 digits). The weights'
//     parts are split once on the host; the activations' in the kernel. A
//     warp owns 32 points x up to 32 outputs; weights come from L2/L1 with
//     __ldg, two k steps in flight;
//   * heads with few outputs (alpha, rgb, semantics) use one thread per
//     (point, output) and plain fp32 FMAs;
//   * concatenations ([emb, h] after the skip layer, [h, emb] into the
//     semantic head, [feature, PE(dirs)] into the views layer) are never
//     materialised: a layer reads up to three input segments in order. Every
//     segment, and every layer's output, is padded to a multiple of 8 rows
//     (zero rows here, zero rows/columns in the packed W^T), so the mma loop
//     has no masks;
//   * per-point sigma / rgb logits / semantics go to a per-CTA strip, and the
//     composite runs from shared memory in fp32 (exclusive product of
//     e + 1e-10 per ray, sequential), then warp reductions form the maps.
// Precision: the points and the PE phases use explicit round-to-nearest
// multiplies and adds (no FMA contraction) and accurate sinf/expf; phases
// reach |x| * 2^9 radians, so no fast-math or tensor-core product touches
// them. No single-pass TF32 anywhere.
// Later work: bf16 activations with wgmma, TMA-fed weight tiles in shared
// memory, more than one CTA per SM.

#include "tile_mlp.cuh"

namespace {

// The wide layers of K2 run as a real call and K1's inline: K2 keeps more
// values live around its layers, and at 128 registers a thread (512 threads)
// inlining made it spill ~1 KB (H100, 8192 rays x 192 samples: 95.5 ms
// inline vs 66.2 ms called); K1 is faster inline (13.3 vs 15.7 ms).
__device__ __noinline__ void dense_call(const float* __restrict__ params, const LayerDesc L,
                                        Seg s0, Seg s1, Seg s2, float* out, bool relu) {
  dense(params, L, s0, s1, s2, out, relu);
}

template <bool kCall>
__device__ __forceinline__ void layer(const float* __restrict__ params, const LayerDesc L, Seg s0,
                                      Seg s1, Seg s2, float* out, bool relu) {
  if (kCall) {
    dense_call(params, L, s0, s1, s2, out, relu);
  } else {
    dense(params, L, s0, s1, s2, out, relu);
  }
}

// kFull = false: K1 (rays = od [R, 6], writes weights).
// kFull = true:  K2 (rays = odv [R, 9], writes maps and weights).
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    render_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                  const float* __restrict__ params, const MLPDesc d, float* __restrict__ maps,
                  float* __restrict__ weights, int R, int S, int rays_per_cta) {
  extern __shared__ float smem[];
  const int E = d.emb_dim, Ep = pad8(E);
  const int Ed = kFull ? d.demb_dim : 0, Edp = pad8(Ed);
  const int sem = kFull ? d.sem_dim : 0;
  const int cs = kFull ? 5 + sem : 2;  // strip: sigma->alpha->w, y->T, rgb x3, sem
  const int ray_stride = kFull ? 9 : 6;
  float* emb = smem;
  float* demb = emb + Ep * kLd;
  float* hA = demb + Edp * kLd;
  float* hB = hA + d.hrows * kLd;
  float* strip = hB + d.hrows * kLd;
  for (int t = threadIdx.x; t < (Ep - E) * kLd; t += kThreads) emb[E * kLd + t] = 0.f;
  for (int t = threadIdx.x; t < (Edp - Ed) * kLd; t += kThreads) demb[Ed * kLd + t] = 0.f;

  const int r0 = blockIdx.x * rays_per_cta;
  const int nr = min(rays_per_cta, R - r0);
  const int nq = nr * S;
  const float* zc = z + (size_t)r0 * S;

  for (int q0 = 0; q0 < nq; q0 += kPts) {
    for (int t = threadIdx.x; t < 3 * kPts; t += kThreads) {
      const int c = t / kPts, p = t % kPts, q = q0 + p;
      float x = 0.f, v = 0.f;
      if (q < nq) {
        const float* ray = rays + (size_t)(r0 + q / S) * ray_stride;
        x = __fadd_rn(ray[c], __fmul_rn(ray[3 + c], zc[q]));
        if (kFull) v = ray[6 + c];
      }
      emb[c * kLd + p] = x;
      if (kFull) demb[c * kLd + p] = v;
    }
    __syncthreads();
    pe_rows(emb, E);
    if (kFull) pe_rows(demb, Ed);
    __syncthreads();

    // trunk: layer i reads `in0, in1` and writes the buffer not holding h
    Seg in0{emb, Ep}, in1 = none();
    float* cur = hB;
    for (int i = 0; i < d.depth; ++i) {
      float* nxt = (cur == hA) ? hB : hA;
      layer<kFull>(params, d.layer[i], in0, in1, none(), nxt, true);
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
    float* spare = (cur == hA) ? hB : hA;
    const LayerDesc* head = d.layer + d.depth;  // alpha, feature, views, rgb, sem_0, sem_1

    dense_small(params, head[0], in0, in1, none(), strip, q0, nq, cs, 0);  // sigma
    if (kFull) {
      if (sem) {
        const Seg coord = d.sem_with_coord ? Seg{emb, Ep} : none();
        layer<kFull>(params, head[4], in0, in1, coord, spare, true);
        __syncthreads();
        dense_small(params, head[5], Seg{spare, pad8(head[4].n)}, none(), none(), strip, q0, nq,
                    cs, 5);
        __syncthreads();
      }
      layer<kFull>(params, head[1], in0, in1, none(), spare, false);  // feature
      __syncthreads();
      layer<kFull>(params, head[2], Seg{spare, pad8(head[1].n)}, Seg{demb, Edp}, none(), cur,
                   true);  // views
      __syncthreads();
      dense_small(params, head[3], Seg{cur, pad8(head[2].n)}, none(), none(), strip, q0, nq, cs,
                  2);
    }
    __syncthreads();
  }

  // composite: alpha and y = e + 1e-10 per point
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int s = q % S;
    const float* ray = rays + (size_t)(r0 + q / S) * ray_stride;
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
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float w = strip[q * cs] * strip[q * cs + 1];
    strip[q * cs] = w;
    weights[(size_t)r0 * S + q] = w;
  }
  if (!kFull) return;
  __syncthreads();

  // maps: one warp per ray, lanes stride over samples, then a warp reduction
  const int nmaps = 5 + sem;
  for (int rl = threadIdx.x / 32; rl < nr; rl += kThreads / 32) {
    float acc[5 + kMaxSem];
#pragma unroll
    for (int c = 0; c < 5 + kMaxSem; ++c) acc[c] = 0.f;
    for (int s = threadIdx.x % 32; s < S; s += 32) {
      const float* c = strip + (rl * S + s) * cs;
      const float w = c[0];
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[j] += w * (1.f / (1.f + expf(-c[2 + j])));
      acc[3] += w * zc[rl * S + s];
      acc[4] += w;
#pragma unroll
      for (int j = 0; j < kMaxSem; ++j)
        if (j < sem) acc[5 + j] += w * c[5 + j];
    }
#pragma unroll
    for (int c = 0; c < 5 + kMaxSem; ++c) {
      float v = acc[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (threadIdx.x % 32 == 0 && c < nmaps) maps[(size_t)(r0 + rl) * nmaps + c] = v;
    }
  }
}

template <bool kFull>
int launch(const float* rays, const float* z, const float* params, const MLPDesc* d,
           float* maps, float* weights, int R, int S, int rays_per_cta, void* stream) {
  const int Edp = kFull ? (d->demb_dim + 7) / 8 * 8 : 0;
  const int cs = kFull ? 5 + d->sem_dim : 2;
  const size_t smem =
      ((size_t)((d->emb_dim + 7) / 8 * 8 + Edp + 2 * d->hrows) * kLd +
       (size_t)rays_per_cta * S * cs) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      render_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (R + rays_per_cta - 1) / rays_per_cta;
  render_kernel<kFull><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      rays, z, params, *d, maps, weights, R, S, rays_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nerf_coarse_weights(const float* od, const float* z, const float* params,
                                   const MLPDesc* d, float* weights, int R, int S,
                                   int rays_per_cta, void* stream) {
  return launch<false>(od, z, params, d, nullptr, weights, R, S, rays_per_cta, stream);
}

extern "C" int nerf_render(const float* odv, const float* z, const float* params,
                           const MLPDesc* d, float* maps, float* weights, int R, int S,
                           int rays_per_cta, void* stream) {
  return launch<true>(odv, z, params, d, maps, weights, R, S, rays_per_cta, stream);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
