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
// What the design does about it:
//   * a grid of about one CTA per SM takes chunks of whole rays
//     (rays_per_chunk = max(1, 512 / S), so ~512 points; fewer where the
//     forward's strip and ring do not fit, ops/fused_render._wg_plan) in
//     waves of one chunk per CTA, so the composite and its reverse scan stay
//     inside the CTA; per wave a forward kernel and a reverse-sweep kernel
//     run in turn (as one kernel, the layer products of both spilled
//     registers and the whole ran 1.6x slower: H100, 4096 rays x 192
//     samples, 190 ms vs 120 ms);
//   * the activations of a chunk do not fit in shared memory (~3,400 rows
//     of 64-point tiles, ~7.9 MB a CTA at the flagship shape, ~1 GB for the
//     grid), so each CTA keeps them in its own slice of a global workspace,
//     in feature-major [row][kLd] tiles of 64 points, from its forward to
//     its reverse sweep;
//   * the forward (train_forward_wg_kernel) runs on K4's tile (wg_tile.cuh:
//     128 points, two consumer warpgroups on wgmma 3xTF32, the weights
//     through a TMA ring, setmaxnreg) in its store mode: each layer's
//     epilogue writes act(acc + b) of the warpgroup's 64 points from the
//     accumulators into the workspace plane beside its write into the
//     shared h tile (a warp's 8 points of two rows: four 32-byte sectors),
//     the views' and sem_0's hidden activations too (K4 keeps them in
//     registers only), and emb and demb go out unswizzled once a tile;
//     warpgroup w of tile t writes sub 2 t + w, and a warpgroup wholly past
//     the chunk's points stores nothing;
//   * the input-gradient products dX = W dY (train_sweep.cuh bwd_layer) run
//     on wgmma m64nNk8 in 3xTF32, as K4's forward does: the host packs each
//     backward matrix per k-slice of 8 dY rows, TF32 high then low parts in
//     wgmma's K-major B layout (ops/fused_render.pack_bwd_ring), and the
//     warpgroups' first threads in turn fill a ring of shared-memory stages
//     ahead of the consumers with bulk copies on full/empty mbarriers: each
//     stage the matrix's k-slice, the 8 dY rows of that k step of up to four
//     64-point subs and, for the trunk and alpha's slot, the same rows of
//     the stored activations that gate the outputs. The four warpgroups take
//     (sub, piece of at most 128 outputs) units in rounds, A = their sub's
//     dY from the stage in registers, and apply the relu derivative in the
//     epilogue as a gate on the stored activation. The emb rows of the skip
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
// Where the time goes (H100 at 700 W, nerfsos_torch/tools/tile_probe.py, K6
// at 32768 rays x 192 samples): the forward on K4's tile 152.6 of 564.2 ms
// (fwdonly), the reverse sweep 411.6 ms (621.5 with the input-gradient
// products on dense()'s 64-point tile); inside the reverse kernel
// (sweepclock, thread 0 of CTA 0) the dW products (wgrad) 62%, of it 15
// points issuing their cp.async staging, and the dX products (bwd_layer)
// 38% (53% before).
// Precision: fp32 throughout; the points and the PE phases as in the render
// kernels (explicit round-to-nearest, accurate sinf), no fast-math.
//
// The same file holds the frozen-backbone SOS finetune's two kernels:
//
// K4 (replaces _train_render_fwd_impl -> _train_render_kernel): the train
// forward, maps [R, 5 + sem] and weights [R, S] with the hash noise and, on
// request, sem_in [R * S, C] = [h; emb] per point (C = 319 at the
// flagship), written from the activations the tile already holds. It is
// bound by its arithmetic (the forward, ~1.27 MFLOP a fine point); sem_in
// adds C * 4 bytes a point of writes (8.0 GB for the 32768 x 192 fine pass,
// ~2.4 ms at 3.35 TB/s). The JAX package recomputes above an 8 GiB residual
// for a 16 GB TPU; on an 80 GB card sem_in is always stored. Its tile is
// Hopper's own (wg_tile.cuh: 128 points, two consumer warpgroups on wgmma,
// the weights through a TMA ring), then K3's composite.
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
// mip-NeRF's three kernels are a mode (kMip) of the 64-point kernels
// (train_render_kernel, train_forward_kernel) and of the reverse sweep:
//   K9   fused_mip_render_planar -> _mip_render_kernel: the train forward
//        (K4's work, on train_sweep.cuh's 64-point forward_tile) without
//        noise on odvr [R, 10] (o, d, viewdirs, radius) and fenceposts
//        z [R, S + 1] -> maps [R, 5] (w·rgb x3, w·mid, w) and w [R, S];
//   K10a _mip_train_fwd_impl -> _mip_train_kernel: the same with the noise;
//   K10b _mip_train_bwd -> _mip_train_bwd_kernel: K6's reverse sweep
//        without the semantic head after the 64-point storing forward
//        (train_forward_kernel), from dmaps [R, 5] and dweights [R, S].
// A point is an interval (t0, t1) of its ray. The tile's prologue builds
// the cone frustum's diagonal Gaussian per point (tile_mlp.cuh
// frustum_gauss, the stable closed forms, one rounding per operation so
// the means are the plain version's bit for bit: the integrated PE
// multiplies them by up to 2^9) and its integrated PE (ipe_rows: 60 rows
// at multires 10, padded to 64, no raw-input rows) in place of the point
// PE; the composite takes D = (t1 - t0)·‖d‖ with no far pad and the
// midpoint as the depth, and K10b's cotangent mode reads the midpoint in
// dw. Everything else (the trunk with its [emb, h] skip, the heads, the
// reverse sweep, the CTA-ordered reduction) is K6's. Bound: the
// same arithmetic as K4 and K6 without the semantic head (~1.18 MFLOP a
// point forward, ~3x that for K10b); the Gaussian and the 60 sin/exp of a
// point are ~1% of it.

// The forward tile, the reverse sweep and the reduction live in
// train_sweep.cuh, which the field kernels (fused_field.cu) share.
#include "wg_tile.cuh"

namespace {

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

// forward_tile's inputs for a chunk of rays (rays r0.., S samples a ray, nq
// points): point q is sample q % S of ray r0 + q / S, at o + d z (kMip: the
// cone-frustum Gaussian of the interval (z[s], z[s + 1]) of its ray,
// frustum_gauss), seen from the ray's viewdir.
template <bool kMip>
struct RayFill {
  const float* rays;  // odv [R, 9] (kMip: odvr [R, 10])
  const float* zc;    // the chunk's z [nr][S] (kMip: fenceposts [nr][S + 1])
  int r0, S, nq;

  __device__ __forceinline__ void operator()(float* emb, float* demb, float* g, int q0) const {
    for (int t = threadIdx.x; t < 3 * kPts; t += kThreads) {
      const int ch = t / kPts, p = t % kPts, q = q0 + p;
      if (kMip) {
        float m = 0.f, cv = 0.f, v = 0.f;
        if (q < nq) {
          const int r = q / S, s = q % S;
          const float* ray = rays + (size_t)(r0 + r) * 10;
          const float* zr = zc + (size_t)r * (S + 1);
          frustum_gauss(ray, zr[s], zr[s + 1], ch, m, cv);
          v = ray[6 + ch];
        }
        g[ch * kLd + p] = m;
        g[(3 + ch) * kLd + p] = cv;
        demb[ch * kLd + p] = v;
      } else {
        float x = 0.f, v = 0.f;
        if (q < nq) {
          const float* ray = rays + (size_t)(r0 + q / S) * 9;
          x = __fadd_rn(ray[ch], __fmul_rn(ray[3 + ch], zc[q]));
          v = ray[6 + ch];
        }
        emb[ch * kLd + p] = x;
        demb[ch * kLd + p] = v;
      }
    }
  }
};

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
// kThr: the threads that run it (threads 0 .. kThr - 1 of the CTA).
template <int kMode, bool kMip = false, int kThr = kThreads>
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
  for (int rl = threadIdx.x; rl < nr; rl += kThr) {
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
  for (int q = nq + threadIdx.x; kMode != kForward && q < nsub * kPts; q += kThr) {
    const int sub = q / kPts, p = q % kPts;  // the last tile's tail
    plane(ws, d, P_DSIG, sub)[p] = 0.f;
    float* dr = plane(ws, d, P_DRGB, sub);
    for (int j = 0; j < 3; ++j) dr[j * kLd + p] = 0.f;
    if (kMode == kCotangent)
      for (int j = 0; j < sem; ++j) plane(ws, d, p_dsem, sub)[j * kLd + p] = 0.f;
  }
  if (kThr == kThreads) __syncthreads();
}

// The padding rows of the cotangent planes of a workspace slice, which
// nothing else writes (rows 3-7 of P_DRGB, 1-7 of P_DSIG, sem.. 7 of d_sem),
// zeroed for the rays_per_chunk * S points of a chunk by kThr threads.
template <int kMode, int kThr>
__device__ __forceinline__ void zero_cotangent_padding(float* ws, const TrainDesc& d, int S) {
  for (int sub = 0; sub < (d.rays_per_chunk * S + kPts - 1) / kPts; ++sub) {
    float* r = plane(ws, d, P_DRGB, sub);
    float* s = plane(ws, d, P_DSIG, sub);
    for (int i = threadIdx.x; i < 5 * kLd; i += kThr) r[3 * kLd + i] = 0.f;
    for (int i = threadIdx.x; i < 7 * kLd; i += kThr) s[kLd + i] = 0.f;
    if (kMode == kCotangent && d.f.sem_dim > 0) {
      float* m = plane(ws, d, P_ACT0 + d.f.depth + 1, sub);
      for (int i = threadIdx.x; i < (8 - d.f.sem_dim) * kLd; i += kThr)
        m[d.f.sem_dim * kLd + i] = 0.f;
    }
  }
}

// K10b's wave `wave` of the forward on the 64-point tile: CTA b takes chunk
// wave * gridDim.x + b into its workspace slice b: every activation of the
// reverse sweep, then the composite (kCotangent: dsigma and drgb from
// dmaps = aux and dweights). odv is odvr [R, 10] and z fenceposts
// [R, S + 1]. K3 and K6 take train_forward_wg_kernel instead.
template <int kMode, bool kMip>
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
  zero_pad_rows(tile, d.f);
  if (wave == 0) zero_cotangent_padding<kMode, kThreads>(ws, d, S);
  __syncthreads();
  const int r0 = c * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int nsub = (nq + kPts - 1) / kPts;
  const float* zc = z + (size_t)r0 * (kMip ? S + 1 : S);

  // ---- forward, storing every activation the reverse sweep reads
  for (int sub = 0; sub < nsub; ++sub)
    forward_tile<true, kMode == kCotangent, kMip, true>(
        RayFill<kMip>{odv, zc, r0, S, nq}, params, d, ws, strip,
        OutCols{6 + d.f.sem_dim, 0, 2, 5}, tile, nq, sub, nullptr, 0);

  // ---- composite, maps, the cotangent and its reverse: one thread a ray
  composite_chunk<kMode, kMip>(odv, zc, aux, dweights, d, ws, strip, maps, weights, r0, nr, S,
                               nsub, seed, noise_std, white_bkgd);
}

// K9 (noise_std 0) and K10a: CTA b takes chunk b (d.rays_per_chunk rays)
// of odvr [R, 10] and fenceposts [R, S + 1]: the forward of each 64-point
// tile, then the composite with the sigma noise into maps [R, 5] and
// weights. Nothing is stored for a reverse sweep. semin is null: it was
// K4's (forward_tile's sem_in rows) before K4 had a tile of its own, and
// stays a runtime argument because without it ptxas allocates this kernel
// otherwise and K9 ran 5.5% slower (H100, 4096 x 190 intervals, 28.9 ->
// 30.6 ms, nerfsos_torch/tools/tile_probe.py --kernel k9).
template <bool kMip>
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
  zero_pad_rows(tile, d.f);
  __syncthreads();
  const int r0 = blockIdx.x * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int nsub = (nq + kPts - 1) / kPts;
  const float* zc = z + (size_t)r0 * (kMip ? S + 1 : S);
  for (int sub = 0; sub < nsub; ++sub)
    forward_tile<false, false, kMip, true>(RayFill<kMip>{odv, zc, r0, S, nq}, params, d, nullptr,
                                           strip, OutCols{6 + d.f.sem_dim, 0, 2, 5}, tile, nq,
                                           sub, semin, (long long)r0 * S);
  composite_chunk<kForward, kMip>(odv, zc, nullptr, nullptr, d, nullptr, strip, maps, weights, r0,
                                  nr, S, nsub, seed, noise_std, 0);
}

// K4: CTA b takes chunk b (d.rays_per_chunk rays, nq points) in tiles of
// 128 points (wg_tile.cuh: wg_cta's shared memory, wg_consumer's two
// consumer warpgroups and producer thread); then the consumers composite
// the chunk with the sigma noise into maps and weights (a thread a ray).
__global__ void __launch_bounds__(kWgThreads, 1)
    train_render_wg_kernel(const float* __restrict__ odv, const float* __restrict__ z,
                           const float* __restrict__ params, const float* __restrict__ ring,
                           const __grid_constant__ TrainDesc d,
                           const __grid_constant__ RingDesc rd, float* __restrict__ maps,
                           float* __restrict__ weights, float* __restrict__ semin, int R, int S,
                           unsigned seed, float noise_std) {
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const WgCta cta = wg_cta(wg_raw, d.f, rd);
  const int rpc = d.rays_per_chunk, r0 = blockIdx.x * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int ntiles = (nq + kWgTile - 1) / kWgTile;
  __syncthreads();
  if (!wg_consumer(ring, d.f, rd, cta.rg, ntiles)) return;
  float* mine = cta.tiles + (threadIdx.x >> 7) * cta.per_wg;
  float* strip = cta.strip;
  const float* zc = z + (size_t)r0 * S;
  int pos = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    pos = wg_forward_tile<false, false>(odv, zc, r0, S, nq, tile, params, d, rd, cta.rg, pos,
                                        mine, strip, semin, (long long)r0 * S, nullptr);
  asm volatile("bar.sync 3, %0;\n" ::"n"(kWgConsumers) : "memory");  // the strip is whole
  composite_chunk<kForward, false, kWgConsumers>(odv, zc, nullptr, nullptr, d, nullptr, strip,
                                                 maps, weights, r0, nr, S, 0, seed, noise_std, 0);
}

// K3 (kLoss) and K6 (kCotangent): wave `wave` of the storing forward on
// K4's tile. CTA b takes chunk wave * gridDim.x + b in 128-point tiles
// (threads, registers and shared memory as train_render_wg_kernel's) and
// writes every activation the reverse sweep reads into its workspace slice
// b, sub 2 t + w for warpgroup w of tile t (wg_forward_tile's kStore); then
// the consumers composite the chunk (kLoss: maps, weights, dsigma and drgb
// from gt = aux; kCotangent: dsigma, drgb and d_sem from dmaps = aux and
// dweights). train_reverse_kernel then sweeps the slice.
template <int kMode>
__global__ void __launch_bounds__(kWgThreads, 1)
    train_forward_wg_kernel(const float* __restrict__ odv, const float* __restrict__ z,
                            const float* __restrict__ aux, const float* __restrict__ dweights,
                            const float* __restrict__ params, const float* __restrict__ ring,
                            const __grid_constant__ TrainDesc d,
                            const __grid_constant__ RingDesc rd, float* __restrict__ maps,
                            float* __restrict__ weights, float* __restrict__ workspace, int R,
                            int S, int wave, unsigned seed, float noise_std, int white_bkgd) {
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const int rpc = d.rays_per_chunk, c = wave * gridDim.x + blockIdx.x;
  if (c * rpc >= R) return;
  const WgCta cta = wg_cta(wg_raw, d.f, rd);
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  const int r0 = c * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int ntiles = (nq + kWgTile - 1) / kWgTile, nsub = (nq + kPts - 1) / kPts;
  if (wave == 0) zero_cotangent_padding<kMode, kWgThreads>(ws, d, S);
  __syncthreads();
  if (!wg_consumer(ring, d.f, rd, cta.rg, ntiles)) return;
  float* mine = cta.tiles + (threadIdx.x >> 7) * cta.per_wg;
  float* strip = cta.strip;
  const float* zc = z + (size_t)r0 * S;
  int pos = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    pos = wg_forward_tile<true, kMode == kCotangent>(odv, zc, r0, S, nq, tile, params, d, rd,
                                                     cta.rg, pos, mine, strip, nullptr, 0, ws);
  asm volatile("bar.sync 3, %0;\n" ::"n"(kWgConsumers) : "memory");  // the strip is whole
  composite_chunk<kMode, false, kWgConsumers>(odv, zc, aux, dweights, d, ws, strip, maps, weights,
                                              r0, nr, S, nsub, seed, noise_std, white_bkgd);
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

// shared memory of the forward kernels (K3's, K9's and K10a's): the chunk's
// composite strip, then emb, demb and two layer tiles
int forward_smem(const TrainDesc* d, int S) {
  return (int)((((size_t)d->rays_per_chunk * S * (6 + d->f.sem_dim) + 3) / 4 * 4) *
               sizeof(float)) +
         tile_smem(d->f);
}

// shared memory of K4 (train_render_wg_kernel) and of K3's and K6's forward
// (train_forward_wg_kernel); ops/fused_render.py _wg_smem computes the same
int wg_smem(const TrainDesc* d, const RingDesc* rd, int S) {
  const MLPDesc& f = d->f;
  const size_t rows = (f.emb_dim + 7) / 8 * 8 + (f.demb_dim + 7) / 8 * 8 + rd->hrows;
  const size_t strip = ((size_t)d->rays_per_chunk * S * (6 + f.sem_dim) + 3) / 4 * 4;
  return (int)(128 + ((size_t)rd->stages * rd->stage_floats + 2 * rows * kWgPts + strip) *
                         sizeof(float));
}

}  // namespace

// K4: one launch, a CTA a chunk of d->rays_per_chunk rays; semin may be null.
extern "C" int nerf_train_render(const float* odv, const float* z, const float* params,
                                 const float* ring, const TrainDesc* d, const RingDesc* rd,
                                 float* maps, float* weights, float* semin, int R, int S,
                                 unsigned seed, float noise_std, void* stream) {
  const int smem = wg_smem(d, rd, S);
  cudaError_t err = cudaFuncSetAttribute(train_render_wg_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  train_render_wg_kernel<<<nchunks, kWgThreads, smem, (cudaStream_t)stream>>>(
      odv, z, params, ring, *d, *rd, maps, weights, semin, R, S, seed, noise_std);
  return (int)cudaGetLastError();
}

// K9 (noise_std 0) and K10a: the mip render pass, odvr [R, 10] and
// fenceposts z [R, S + 1] -> maps [R, 5] and weights [R, S], with the sigma
// noise of seed; one launch, a CTA a chunk of d->rays_per_chunk rays. The
// two TPU kernels differ by the noise alone, so they are one kernel here.
extern "C" int nerf_mip_render(const float* odvr, const float* z, const float* params,
                               const TrainDesc* d, float* maps, float* weights, int R, int S,
                               unsigned seed, float noise_std, void* stream) {
  const int smem = forward_smem(d, S);
  cudaError_t err = cudaFuncSetAttribute(train_render_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  train_render_kernel<true><<<nchunks, kThreads, smem, (cudaStream_t)stream>>>(
      odvr, z, params, *d, maps, weights, nullptr, R, S, seed, noise_std);
  return (int)cudaGetLastError();
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
  reduce_partials<<<reduce_blocks(d->grad_size), 256, 0, st>>>(partial, grads, d->grad_size, grid);
  return (int)cudaGetLastError();
}

namespace {

// grid CTAs (each with a d->ws_size workspace slice and a d->grad_size partial
// gradient buffer) take the chunks of rays in waves of grid: per wave the
// forward kernel (K3, K6: train_forward_wg_kernel on K4's tile, with the
// ring of ring and rd; kMip, K10b: train_forward_kernel), then the
// reverse-sweep kernel (its input-gradient products' matrices from the
// backward ring bring as brd describes); then the partials are summed into
// grads [d->grad_size]. Returns the first CUDA error of the launches.
template <int kMode, bool kSem, bool kMip = false>
int train_grads(const float* odv, const float* z, const float* aux, const float* dweights,
                const float* params, const float* ring, const float* bring,
                const TrainDesc* d, const RingDesc* rd, const RingDesc* brd, float* maps,
                float* weights, float* partial, float* workspace, float* grads, int R, int S,
                int grid, unsigned seed, float noise_std, int white_bkgd, cudaStream_t st) {
  int fwd_smem;
  cudaError_t err;
  if constexpr (kMip) {
    fwd_smem = forward_smem(d, S);
    err = cudaFuncSetAttribute(train_forward_kernel<kMode, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem);
  } else {
    fwd_smem = wg_smem(d, rd, S);
    err = cudaFuncSetAttribute(train_forward_wg_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(train_reverse_kernel<kSem>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kReverseSmem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  for (int wave = 0; wave * grid < nchunks; ++wave) {
    if constexpr (kMip) {
      train_forward_kernel<kMode, true><<<grid, kThreads, fwd_smem, st>>>(
          odv, z, aux, dweights, params, *d, maps, weights, workspace, R, S, wave, seed,
          noise_std, white_bkgd);
    } else {
      train_forward_wg_kernel<kMode><<<grid, kWgThreads, fwd_smem, st>>>(
          odv, z, aux, dweights, params, ring, *d, *rd, maps, weights, workspace, R, S, wave,
          seed, noise_std, white_bkgd);
    }
    train_reverse_kernel<kSem><<<grid, kThreads, kReverseSmem, st>>>(
        bring, nullptr, *d, *brd, RingDesc{}, partial, workspace, R, S, wave, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials<<<reduce_blocks(d->grad_size), 256, 0, st>>>(partial, grads, d->grad_size, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: the RGB train pass, the forward's weights from ring (ops/fused_render
// pack_ring) as rd describes, the reverse sweep's from bring (pack_bwd_ring)
// as brd describes; see train_grads.
extern "C" int nerf_rgb_train_grads(const float* odv, const float* z, const float* gt,
                                    const float* params, const float* ring, const float* bring,
                                    const TrainDesc* d, const RingDesc* rd, const RingDesc* brd,
                                    float* maps, float* weights, float* partial, float* workspace,
                                    float* grads, int R, int S, int grid, unsigned seed,
                                    float noise_std, int white_bkgd, void* stream) {
  return train_grads<kLoss, false>(odv, z, gt, nullptr, params, ring, bring, d, rd, brd, maps,
                                   weights, partial, workspace, grads, R, S, grid, seed,
                                   noise_std, white_bkgd, (cudaStream_t)stream);
}

// K6: the train render's backward from the maps' cotangent dmaps [R, 5 + sem]
// and the weights' dweights [R, S] (null: zero); d describes the semantic
// head's planes and gradients when d->f.sem_dim > 0; the forward's weights
// from ring as rd describes, the reverse sweep's from bring as brd
// describes; see train_grads.
extern "C" int nerf_train_render_grads(const float* odv, const float* z, const float* dmaps,
                                       const float* dweights, const float* params,
                                       const float* ring, const float* bring,
                                       const TrainDesc* d, const RingDesc* rd,
                                       const RingDesc* brd, float* partial, float* workspace,
                                       float* grads, int R, int S, int grid, unsigned seed,
                                       float noise_std, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (d->f.sem_dim > 0)
    return train_grads<kCotangent, true>(odv, z, dmaps, dweights, params, ring, bring, d, rd,
                                         brd, nullptr, nullptr, partial, workspace, grads, R, S,
                                         grid, seed, noise_std, 0, st);
  return train_grads<kCotangent, false>(odv, z, dmaps, dweights, params, ring, bring, d, rd,
                                        brd, nullptr, nullptr, partial, workspace, grads, R, S,
                                        grid, seed, noise_std, 0, st);
}

// K10b: the mip train render's backward from the maps' cotangent dmaps
// [R, 5] and the weights' dweights [R, S] (null: zero), on odvr [R, 10] and
// fenceposts z [R, S + 1]: K6's kernels without the semantic head in their
// mip mode (the Gaussian and integrated-PE prologue, the mip composite), the
// reverse sweep's matrices from bring as brd describes; see train_grads.
extern "C" int nerf_mip_train_render_grads(const float* odvr, const float* z, const float* dmaps,
                                           const float* dweights, const float* params,
                                           const float* bring, const TrainDesc* d,
                                           const RingDesc* brd, float* partial, float* workspace,
                                           float* grads, int R, int S, int grid, unsigned seed,
                                           float noise_std, void* stream) {
  return train_grads<kCotangent, false, true>(odvr, z, dmaps, dweights, params, nullptr, bring,
                                              d, nullptr, brd, nullptr, nullptr, partial,
                                              workspace, grads, R, S, grid, seed, noise_std, 0,
                                              (cudaStream_t)stream);
}
