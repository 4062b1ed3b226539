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
  int emb_dim;         // 3 + 6 * multires
  int demb_dim;        // 3 + 6 * multires_views
  int sem_dim;         // 0 without the semantic head
  int sem_with_coord;
};

namespace {

constexpr int kPts = 64;          // points per tile
constexpr int kLd = 72;           // shared-memory row stride (floats), = 8 mod 32
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

__device__ __forceinline__ void mma_stage(float (&acc)[2][kTilesN][4], const Stage& st,
                                          int ntiles, int wn) {
  uint32_t ahi[2][4], alo[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(st.a[mt * 4 + i], ahi[mt][i], alo[mt][i]);
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) {
    if (wn + kWarpsN * j < ntiles) {
      const uint32_t b0h = __float_as_uint(st.b[j][0]), b1h = __float_as_uint(st.b[j][1]);
      const uint32_t b0l = __float_as_uint(st.b[j][2]), b1l = __float_as_uint(st.b[j][3]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tf32(acc[mt][j], alo[mt], b0h, b1h);
        mma_tf32(acc[mt][j], ahi[mt], b0l, b1l);
        mma_tf32(acc[mt][j], ahi[mt], b0h, b1h);
      }
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
        float v[4] = {acc[mt][j][0] + b0, acc[mt][j][1] + b1, acc[mt][j][2] + b0,
                      acc[mt][j][3] + b1};
        if (relu) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
        }
        out[n * kLd + p] = v[0];
        out[(n + 1) * kLd + p] = v[1];
        out[n * kLd + p + 8] = v[2];
        out[(n + 1) * kLd + p + 8] = v[3];
      }
    }
  }
}

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

// Few-output head: thread (p, g) computes outputs g, g + 8, ... of point p and
// writes them to strip[(q0 + p) * cs + c0 + n] for valid points.
__device__ void dense_small(const float* __restrict__ params, const LayerDesc L, Seg s0,
                            Seg s1, Seg s2, float* strip, int q0, int nq, int cs, int c0) {
  const int p = threadIdx.x % kPts;
  const int N = L.n, ldn = pad8(L.n);
  const Seg segs[3] = {s0, s1, s2};
  for (int n = threadIdx.x / kPts; n < N; n += kThreads / kPts) {
    float acc = 0.f;
    const float* __restrict__ wcol = params + L.w + n;
#pragma unroll
    for (int sg = 0; sg < 3; ++sg) {
      const float* a = segs[sg].a;
      const int K = segs[sg].k;
      for (int k = 0; k < K; ++k, wcol += ldn) acc = fmaf(a[k * kLd + p], __ldg(wcol), acc);
    }
    if (q0 + p < nq) strip[(q0 + p) * cs + c0 + n] = acc + __ldg(params + L.b + n);
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
