// Field kernels for Hopper (sm_90a): the radiance field queried point by
// point with no composite, its density alone, and its backward from a
// per-point cotangent.
//
// Replaces the six kernels of nerfsos_tpu/ops/pallas/fused_field.py and K11,
// one kernel per role: the TPU's row-major and channel-major twins differ in
// their IO layout alone, and here the IO is the plain NeRFField's, [N, 3]
// in and [N, C] out.
//   sigma forward   K8a _sigma_forward -> _sigma_kernel and K8e
//                   _sigma_forward_pl -> _sigma_kernel_pl: PE(pts), the
//                   trunk (skip after layer 4), the alpha head;
//                   pts [N, 3] -> sigma [N];
//   field forward   K8b _fused_forward -> _field_kernel and K8d
//                   _fused_forward_pl -> _field_kernel_pl: PE(pts) and
//                   PE(dirs), the trunk, alpha, feature, views, rgb and the
//                   2-layer semantic head; pts, dirs [N, 3] -> raw
//                   [N, 4 + sem] (rgb logits, sigma, semantics); and K11
//                   fused_mip_apply_planar (_field_kernel_pl with ipe): the
//                   same on the integrated PE of diagonal Gaussians (mean,
//                   cov [N, 3]) -> raw [N, 4], no semantic head;
//   field backward  K8c _fused_backward -> _field_bwd_kernel and K8f
//                   _fused_backward_pl -> _field_bwd_kernel_pl: dW/db of
//                   every layer from a cotangent g [N, 4 + sem] of the raw
//                   outputs; in its input-gradient mode (K8c) also dpts and
//                   ddirs [N, 3].
//
// What bounds them on the H100: arithmetic. A flagship point (8 x 256
// trunk, multires 10/4, the semantic head with coordinates) costs ~1.27
// MFLOP forward (~0.98 for the density alone) and ~3.7 MFLOP backward in
// the 3xTF32 products; a point moves 24 bytes in and 4 to 24 out (plus its
// cotangent for the backward), three orders of magnitude below that.
//
// The design is the train kernels', not a new one:
//   * the forwards (field_wg_kernel) run K4's 128-point tile (wg_tile.cuh:
//     two consumer warpgroups of 64 points on wgmma m64nNk8 in 3xTF32, the
//     weights through a ring of shared-memory stages that one producer
//     thread fills with bulk copies, setmaxnreg) in its point-list modes:
//     a CTA takes a run of `per` consecutive tiles (ops/fused_field.py
//     _field_plan: about one CTA an SM, one wave), point q of a tile is a
//     row of pts (K11: of the Gaussians' means and covariances, written
//     straight into h's scratch rows, then their integrated PE as K9 forms
//     it), seen from a row of dirs. The ring holds the trunk alone for the
//     sigma forward (the alpha head is a SIMT dot product, as K1's) and
//     every layer for the field forward. The alpha thread writes sigma to
//     its column of the output row; the rgb logits and the semantics go to
//     the tile's strip (3 + sem floats a point, so that a third ring stage
//     fits beside the flagship's tiles), and each warpgroup copies its 64
//     points' rows out, masked at N, after its last head;
//   * the backward is K6's: per wave of 512-point chunks, one a CTA, a
//     forward kernel (field_bwd_forward_kernel) recomputes the chunk on the
//     same tile in its storing point-list mode (wg_forward_tile<kStore,
//     kSemAct, kInList>: every activation the reverse sweep reads goes from
//     the epilogues to the CTA's workspace slice, 4 tiles a chunk, the
//     weights through the forward ring; no output row is written), then its
//     consumers copy g into the planes K6's composite fills (rgb logits,
//     sigma, semantics; zero in the padding rows and past N); K6's reverse
//     sweep (train_reverse_kernel) follows, and a last kernel sums the CTAs'
//     partial dW/db in CTA order, so two calls give bitwise-equal
//     gradients. The input-gradient mode gathers the cotangent of the point
//     PE from every layer that reads it and that of the view PE from the
//     views layer, and runs both back through the PE (pe_grads, from the
//     stored x, its phases rounded as pe_rows_wg rounds them), as
//     fused_field.py:454-465 does.
// Precision: the PE phases reach |x| 2^9 rad (7.2e3 at the x14 grid of the
// density export) and are formed with explicit round-to-nearest operations
// in the plain version's order, as are the IPE's; accurate sinf/cosf/expf,
// no fast-math, fp32 throughout.
// Every kernel also runs at --compute_dtype bfloat16 (the JAX kernels at
// compute_dtype bfloat16), its entry taking the mode from d->f.bf16: the
// forwards in the tile's bf16 mode (field_wg_kernel<kIn, true>: the PE or
// IPE exact in fp32, then rounded as the products read it, every product on
// wgmma bf16 with fp32 accumulation and bias, the ring in pack_ring's bf16
// layout). The field forward's twins round differently at bf16 (K8b keeps
// the heads' hidden activations s and hv in fp32 before sem_1 and rgb, K8d
// rounds them), so nerf_field takes the rule (f32_heads: K8b's). The
// backward (K8c/K8f at bf16) stores the bf16 activations (the PE in fp32:
// its products round it, K8c's chain rule reads it exact), rounds g to
// bf16 before anything else reads it, the bias sums included, as both JAX
// backwards do, and runs the reverse sweep's bf16 mode; K8c's PE
// cotangents and chain rule stay fp32.

#include "wg_tile.cuh"

// Translation-unit parts (nerfsos_torch/_build.py PARTS), as in
// train_render.cu: compiled as one unit this file holds every kernel; with
// -DNERF_PART=p part p holds the launches of its own kernels, which the C
// entry points of part 0 call: 0 the field forwards at fp32, 1 at bf16,
// 2 the field backward at fp32 without the input gradients (K8f), 3 with
// them (K8c), 4 and 5 the same at bf16.
#ifdef NERF_PART
#define NERF_IN_PART(p) (NERF_PART == (p))
#else
#define NERF_IN_PART(p) 1
#endif

namespace {

// The sigma forward (kInListSigma), the field forward (kInList) and K11
// (kInListGauss) on K4's tile: CTA b takes the tiles of points [b per 128,
// (b + 1) per 128) of the N (the ring's weights for each), point q's
// outputs to row q of out [N, C]. kBf16: the tile's bf16 mode; kHeadF32
// (kInList at bf16): K8b's head rule.
template <int kIn, bool kBf16 = false, bool kHeadF32 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    field_wg_kernel(const float* __restrict__ pts, const float* __restrict__ cov,
                    const float* __restrict__ dirs, const float* __restrict__ params,
                    const float* __restrict__ ring, const __grid_constant__ TrainDesc d,
                    const __grid_constant__ RingDesc rd, float* __restrict__ out, int C,
                    long long N, int per) {
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const WgCta cta = wg_cta(wg_raw, d.f, rd);
  const long long base = (long long)blockIdx.x * per * kWgTile;
  const int nq = (int)min((long long)per * kWgTile, N - base);
  const int ntiles = (nq + kWgTile - 1) / kWgTile;
  __syncthreads();
  if (!wg_consumer<kBf16>(ring, d.f, rd, cta.rg, ntiles, kIn != kInListSigma)) return;
  float* mine = cta.tiles + (threadIdx.x >> 7) * cta.per_wg;
  const PointList pl{pts + base * 3, cov ? cov + base * 3 : nullptr,
                     dirs ? dirs + base * 3 : nullptr, out + base * C, C};
  int pos = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    pos = wg_forward_tile<false, false, kIn, kBf16, kHeadF32>(nullptr, nullptr, 0, 1, nq, tile,
                                                              params, d, rd, cta.rg, pos, mine,
                                                              cta.strip, nullptr, 0, nullptr, pl);
}

// shared memory of field_wg_kernel: the ring's barriers and stages, two
// warpgroups' emb, demb and h tiles, and (heads) the tile's strip of 3 + sem
// floats a point; ops/fused_field.py _field_smem computes the same
int field_smem(const TrainDesc* d, const RingDesc* rd, bool heads) {
  const MLPDesc& f = d->f;
  const size_t rows = (f.emb_dim + 7) / 8 * 8 + (f.demb_dim + 7) / 8 * 8 + rd->hrows;
  const size_t strip = heads ? (size_t)kWgTile * (3 + f.sem_dim) : 0;
  return (int)(128 + ((size_t)rd->stages * rd->stage_floats + 2 * rows * kWgPts + strip) *
                         sizeof(float));
}

// One launch of field_wg_kernel<kIn, kBf16, kHeadF32> over N > 0 points,
// `per` tiles a CTA.
template <int kIn, bool kBf16 = false, bool kHeadF32 = false>
int field_launch(const float* pts, const float* cov, const float* dirs, const float* params,
                 const float* ring, const TrainDesc* d, const RingDesc* rd, float* out, int C,
                 long long N, int per, cudaStream_t st) {
  const int smem = field_smem(d, rd, kIn != kInListSigma);
  cudaError_t err = cudaFuncSetAttribute(field_wg_kernel<kIn, kBf16, kHeadF32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long span = (long long)per * kWgTile, grid = (N + span - 1) / span;
  field_wg_kernel<kIn, kBf16, kHeadF32><<<(unsigned)grid, kWgThreads, smem, st>>>(
      pts, cov, dirs, params, ring, *d, *rd, out, C, N, per);
  return (int)cudaGetLastError();
}

// Wave `wave` of the field backward's forward on K4's tile: CTA b takes
// chunk wave * gridDim.x + b (d.rays_per_chunk points) in 128-point tiles
// (threads, registers and shared memory as field_wg_kernel's, the ring of
// ring and rd: every layer) and writes every activation the reverse sweep
// reads into its workspace slice b, sub 2 t + w for warpgroup w of tile t
// (wg_forward_tile's kStore; kSem: the semantic head's hidden activation
// too); then the consumers copy the cotangent of each output from
// g [N, 4 + sem] into the planes that K6's composite fills (rgb logits,
// sigma, semantics), zero in their padding rows and past N. kInGrad: the
// plane the sweep gathers the point PE's cotangent in is zeroed. kBf16: the
// tile's bf16 store mode, the ring in pack_ring's bf16 layout, and g
// rounded to bf16 in the planes (both JAX backwards round it before any
// product or bias sum reads it).
template <bool kSem, bool kInGrad, bool kBf16>
__global__ void __launch_bounds__(kWgThreads, 1)
    field_bwd_forward_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                             const float* __restrict__ g, const float* __restrict__ params,
                             const float* __restrict__ ring, const __grid_constant__ TrainDesc d,
                             const __grid_constant__ RingDesc rd, float* __restrict__ workspace,
                             int N, int wave) {
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const int rpc = d.rays_per_chunk, c = wave * gridDim.x + blockIdx.x;
  if (c * rpc >= N) return;
  const WgCta cta = wg_cta(wg_raw, d.f, rd);
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  const long long base = (long long)c * rpc;
  const int nq = min(rpc, N - c * rpc);
  const int ntiles = (nq + kWgTile - 1) / kWgTile, nsub = (nq + kPts - 1) / kPts;
  __syncthreads();
  if (!wg_consumer<kBf16>(ring, d.f, rd, cta.rg, ntiles)) return;
  float* mine = cta.tiles + (threadIdx.x >> 7) * cta.per_wg;
  const PointList pl{pts + base * 3, nullptr, dirs + base * 3, nullptr, 0};
  int pos = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    pos = wg_forward_tile<true, kSem, kInList, kBf16>(nullptr, nullptr, 0, 1, nq, tile, params, d,
                                                      rd, cta.rg, pos, mine, cta.strip, nullptr,
                                                      0, ws, pl);
  // the consumers alone from here: the producer warpgroup has returned
  asm volatile("bar.sync 3, %0;\n" ::"n"(kWgConsumers) : "memory");
  const int sem = d.f.sem_dim, C = 4 + sem;
  const int p_dsem = P_ACT0 + d.f.depth + 1, p_gemb = P_ACT0 + d.f.depth + 3;
  for (int e = threadIdx.x; e < nsub * 8 * kPts; e += kWgConsumers) {
    const int sub = e / (8 * kPts), r = e / kPts % 8, p = e % kPts, q = sub * kPts + p;
    const bool live = q < nq;
    const float* gq = g + (size_t)(base + (live ? q : 0)) * C;
    auto cot = [](float v) { return kBf16 ? bf16r(v) : v; };
    plane(ws, d, P_DRGB, sub)[r * kLd + p] = live && r < 3 ? cot(gq[r]) : 0.f;
    plane(ws, d, P_DSIG, sub)[r * kLd + p] = live && r == 0 ? cot(gq[3]) : 0.f;
    if (kSem) plane(ws, d, p_dsem, sub)[r * kLd + p] = live && r < sem ? cot(gq[4 + r]) : 0.f;
  }
  if (kInGrad) {  // the chunk's tiles of a plane are contiguous
    float* gemb = plane(ws, d, p_gemb, 0);
    for (int e = threadIdx.x; e < nsub * d.rows[p_gemb] * kLd; e += kWgConsumers) gemb[e] = 0.f;
  }
}

// grid CTAs (each with a d->ws_size workspace slice and a d->grad_size partial
// gradient buffer) take the chunks of points in waves of `group` forward
// waves of grid chunks (train_grads's scheme): per wave the forward kernel
// of each (field_bwd_forward_kernel on K4's tile, its weights from ring as
// rd describes), chunk j of the group into sub j nsf .. of the slice's
// planes (group_desc), then one reverse sweep over the group's chunks; then
// the partials are summed into grads [d->grad_size]; kBf16: both kernels'
// bf16 modes. Returns the first CUDA error.
template <bool kSem, bool kInGrad, bool kBf16>
int field_grads_launch(const float* pts, const float* dirs, const float* g, const float* params,
                       const float* ring, const float* bring, const float* iring,
                       const TrainDesc* d, const RingDesc* rd, const RingDesc* brd,
                       const RingDesc* ird, float* partial, float* workspace, float* grads,
                       float* dpts, float* ddirs, int N, int grid, int group, cudaStream_t st) {
  const int fwd_smem = field_smem(d, rd, true);
  cudaError_t err = cudaFuncSetAttribute(field_bwd_forward_kernel<kSem, kInGrad, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(train_reverse_kernel<kSem, kInGrad, kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kReverseSmem);
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = (N + d->rays_per_chunk - 1) / d->rays_per_chunk;
  for (int wave = 0; (long long)wave * group * grid < nchunks; ++wave) {
    for (int j = 0; j < group && (long long)(wave * group + j) * grid < nchunks; ++j)
      field_bwd_forward_kernel<kSem, kInGrad, kBf16><<<grid, kWgThreads, fwd_smem, st>>>(
          pts, dirs, g, params, ring, group_desc(*d, j, 1), *rd, workspace, N, wave * group + j);
    train_reverse_kernel<kSem, kInGrad, kBf16><<<grid, kThreads, kReverseSmem, st>>>(
        bring, iring, *d, *brd, *ird, partial, workspace, N, 1, wave, group, dpts, ddirs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials<<<reduce_blocks(d->grad_size), 256, 0, st>>>(partial, grads, d->grad_size, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// The parts' launches (see NERF_PART): field_wg_kernel's in input mode kin
// (kInListSigma, kInList, kInListGauss; f32_heads: K8b's head rule at
// bf16), and the field backward (both kernels, every wave, the reduction)
// with or without the semantic head's planes: K8f's weights only, K8c's
// with the input gradients.
#define NERF_FIELD_ARGS                                                                     \
  int kin, bool f32_heads, const float *pts, const float *cov, const float *dirs,           \
      const float *params, const float *ring, const TrainDesc *d, const RingDesc *rd,        \
      float *out, int C, long long N, int per, cudaStream_t st
#define NERF_FIELD_GRADS_ARGS                                                               \
  bool sem, const float *pts, const float *dirs, const float *g,               \
      const float *params, const float *ring, const float *bring, const float *iring,        \
      const TrainDesc *d, const RingDesc *rd, const RingDesc *brd, const RingDesc *ird,      \
      float *partial, float *workspace, float *grads, float *dpts, float *ddirs, int N,       \
      int grid, int group, cudaStream_t st

int field_f32(NERF_FIELD_ARGS);
int field_bf16(NERF_FIELD_ARGS);
int k8f_f32(NERF_FIELD_GRADS_ARGS);
int k8c_f32(NERF_FIELD_GRADS_ARGS);
int k8f_bf16(NERF_FIELD_GRADS_ARGS);
int k8c_bf16(NERF_FIELD_GRADS_ARGS);

#define NERF_FIELD_PASS pts, cov, dirs, params, ring, d, rd, out, C, N, per, st
#define NERF_FIELD_GRADS_PASS pts, dirs, g, params, ring, bring, iring, d, rd, brd, ird, \
    partial, workspace, grads, dpts, ddirs, N, grid, group, st

#if NERF_IN_PART(0)
int field_f32(NERF_FIELD_ARGS) {
  if (kin == kInListSigma) return field_launch<kInListSigma>(NERF_FIELD_PASS);
  if (kin == kInListGauss) return field_launch<kInListGauss>(NERF_FIELD_PASS);
  return field_launch<kInList>(NERF_FIELD_PASS);
}
#endif

#if NERF_IN_PART(1)
int field_bf16(NERF_FIELD_ARGS) {
  if (kin == kInListSigma) return field_launch<kInListSigma, true>(NERF_FIELD_PASS);
  if (kin == kInListGauss) return field_launch<kInListGauss, true>(NERF_FIELD_PASS);
  if (f32_heads) return field_launch<kInList, true, true>(NERF_FIELD_PASS);
  return field_launch<kInList, true>(NERF_FIELD_PASS);
}
#endif

#if NERF_IN_PART(2)
int k8f_f32(NERF_FIELD_GRADS_ARGS) {
  return sem ? field_grads_launch<true, false, false>(NERF_FIELD_GRADS_PASS)
             : field_grads_launch<false, false, false>(NERF_FIELD_GRADS_PASS);
}
#endif

#if NERF_IN_PART(3)
int k8c_f32(NERF_FIELD_GRADS_ARGS) {
  return sem ? field_grads_launch<true, true, false>(NERF_FIELD_GRADS_PASS)
             : field_grads_launch<false, true, false>(NERF_FIELD_GRADS_PASS);
}
#endif

#if NERF_IN_PART(4)
int k8f_bf16(NERF_FIELD_GRADS_ARGS) {
  return sem ? field_grads_launch<true, false, true>(NERF_FIELD_GRADS_PASS)
             : field_grads_launch<false, false, true>(NERF_FIELD_GRADS_PASS);
}
#endif

#if NERF_IN_PART(5)
int k8c_bf16(NERF_FIELD_GRADS_ARGS) {
  return sem ? field_grads_launch<true, true, true>(NERF_FIELD_GRADS_PASS)
             : field_grads_launch<false, true, true>(NERF_FIELD_GRADS_PASS);
}
#endif

#if NERF_IN_PART(0)
// K8a/K8e: sigma [N] of pts [N, 3], the trunk's weights from ring (ops/
// fused_render.pack_ring) as rd describes, `per` 128-point tiles a CTA; one
// launch. The bf16 mode when d->f.bf16 (the ring in pack_ring's bf16 layout).
extern "C" int nerf_field_sigma(const float* pts, const float* params, const float* ring,
                                const TrainDesc* d, const RingDesc* rd, float* sigma,
                                long long N, int per, void* stream) {
  return (d->f.bf16 ? field_bf16 : field_f32)(kInListSigma, false, pts, nullptr, nullptr,
                                              params, ring, d, rd, sigma, 1, N, per,
                                              (cudaStream_t)stream);
}

// K8b/K8d: raw [N, 4 + sem] (rgb logits, sigma, semantics) of pts and
// dirs [N, 3], every layer's weights from ring as rd describes; one launch.
// The bf16 mode when d->f.bf16, with K8b's head rule when f32_heads (the
// heads' hidden activations unrounded before sem_1 and rgb), else K8d's.
extern "C" int nerf_field(const float* pts, const float* dirs, const float* params,
                          const float* ring, const TrainDesc* d, const RingDesc* rd, float* raw,
                          long long N, int per, int f32_heads, void* stream) {
  return (d->f.bf16 ? field_bf16 : field_f32)(kInList, f32_heads != 0, pts, nullptr, dirs,
                                              params, ring, d, rd, raw, 4 + d->f.sem_dim, N, per,
                                              (cudaStream_t)stream);
}

// K11: raw [N, 4] of the mip field at the Gaussians (mean, diagonal cov
// [N, 3]) seen from dirs [N, 3]; one launch. The bf16 mode when d->f.bf16
// (the ring in pack_ring's bf16 layout).
extern "C" int nerf_mip_field(const float* mean, const float* cov, const float* dirs,
                              const float* params, const float* ring, const TrainDesc* d,
                              const RingDesc* rd, float* raw, long long N, int per,
                              void* stream) {
  return (d->f.bf16 ? field_bf16 : field_f32)(kInListGauss, false, mean, cov, dirs, params, ring,
                                              d, rd, raw, 4, N, per, (cudaStream_t)stream);
}

// K8f (dpts null) and K8c: the field's dW/db from g [N, 4 + sem] into grads
// [d->grad_size] (K6's layout), the forward's weights from ring (ops/
// fused_render.pack_ring) as rd describes, the input-gradient products'
// matrices from bring (ops/fused_render.pack_bwd_ring) as brd describes;
// with dpts (then also ddirs, d->ibwd and iring as ird describes:
// fused_field.pack_input_ring) the points' and directions' gradients
// [N, 3]; `group` forward chunks a reverse sweep; see field_grads_launch.
// The bf16 mode when d->f.bf16 (the three rings in their bf16 layouts).
extern "C" int nerf_field_grads(const float* pts, const float* dirs, const float* g,
                                const float* params, const float* ring, const float* bring,
                                const float* iring, const TrainDesc* d, const RingDesc* rd,
                                const RingDesc* brd, const RingDesc* ird, float* partial,
                                float* workspace, float* grads, float* dpts, float* ddirs, int N,
                                int grid, int group, void* stream) {
  const bool ingrad = dpts != nullptr;
  return (ingrad ? (d->f.bf16 ? k8c_bf16 : k8c_f32) : (d->f.bf16 ? k8f_bf16 : k8f_f32))(
      d->f.sem_dim > 0, pts, dirs, g, params, ring, bring, ingrad ? iring : nullptr, d, rd, brd,
      ird, partial, workspace, grads, dpts, ingrad ? ddirs : nullptr, N, grid, group,
      (cudaStream_t)stream);
}
#endif
