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
//   * dW = X^T dY contracts over the points (train_sweep.cuh wgrad) on
//     wgmma m64nNk8 in 3xTF32 too: M = X rows, N = dY rows, K = points.
//     A second ring brings each sub's rows in blocks of 64 by bulk copies;
//     the CTA converts the sub's dY rows once into TF32 parts in wgmma's
//     K-major B layout, and each warpgroup multiplies a 64-row block of X
//     (A, from its stage in registers) into its 64 x (<= 128) accumulators,
//     so a sub's dY is staged once a layer and its X once a piece of 128
//     outputs (the old 128 x 128 macro tiles read X again for every n0 and
//     dY for every m0). A k-slice's k positions hold its points in the
//     order 0, 2, 4, 6, 1, 3, 5, 7, so an A fragment's two points are one
//     float2 and its loads hit 32 banks a half-warp. The reverse kernel
//     sweeps `group` forward chunks at once (ops/fused_render._rev_group:
//     about 2048 points), so the CTA's partial dW in global memory is read
//     and written once a group rather than once a chunk. A third kernel
//     sums the partials in a fixed order, so the gradients are
//     deterministic (no atomics);
//   * the semantic head runs forward only: in this loss its cotangent is
//     identically zero, so its gradients are exact zeros (the wrapper writes
//     them) and it adds nothing to dh;
//   * the sigma noise is the TPU kernel's hash: SplitMix-style avalanche of
//     (global point index + seed) in uint32 arithmetic, Box-Muller with
//     log1pf and cosf, so kernel and plain version draw the same values.
// Where the time went before wgrad's redesign (H100 at 700 W,
// nerfsos_torch/tools/tile_probe.py, K6 at 32768 rays x 192 samples): the
// forward on K4's tile 152.6 of 564.2 ms (fwdonly), the reverse sweep
// 411.6 ms; inside the reverse kernel (sweepclock, thread 0 of CTA 0) the
// dW products on m16n8k8 mma.sync 62%, of it 15 points issuing their
// cp.async staging, and the dX products (bwd_layer) 38%.
// Precision: fp32 throughout; the points and the PE phases as in the render
// kernels (explicit round-to-nearest, accurate sinf), no fast-math.
//
// K1 (replaces fused_coarse_weights_planar -> _sigma_weights_kernel, the
// eval's coarse pass: points o + d z, PE, the skip trunk, the alpha head,
// the composite -> weights [R, S]) is K4's kernel below in its sigma-only
// mode (train_render_wg_kernel<kInSigma>): od [R, 6] in, the trunk through
// the tile's ring and wgmma, the alpha head, K3's composite without noise,
// the weights out. Bound: the trunk's products (~0.98 MFLOP a flagship
// coarse point, 12.49 ms at 32768 x 64 at 165 TFLOP/s).
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
// constant, from sem_in [P, C], w and the maps' cotangent: per point
// s_pre = sem_in W0^T + b0, d_sem = dmaps[ray, 5:] w,
// ds = (W1^T d_sem) [s_pre > 0]; dW1 += relu(s_pre)^T d_sem, db1, db0 and
// dW0 += sem_in^T ds. Bound: the two C x 128 products (~164 KFLOP a
// flagship point, 6.27 ms at 32768 x 192 at 165 TFLOP/s) over reading
// sem_in once (8.0 GB there, 2.4 ms).
// The design (redesigned for Hopper; frozen_sem_kernel):
//   * a cluster of four CTAs takes a run of 64-point tiles; CTA rank r owns
//     sem_0's outputs 32 r .. 32 r + 31 (the flagship head has 128), so each
//     CTA's dW0 share is C x 32. Rank 0's producer warp brings each tile of
//     sem_in (64 rows of C floats: 81,664 B at C = 319, one contiguous,
//     16-byte aligned block) into all four CTAs with one multicast bulk
//     copy, so sem_in leaves device memory once; each CTA frees a stage on
//     its own barrier and the other ranks' consumers also on rank 0's, which
//     refills it;
//   * 512 threads: warpgroup F, two dW0 warpgroups D0/D1 and a producer
//     warpgroup (warp 0 the X ring, one thread of warp 1 the W0 ring);
//   * F: s_pre on wgmma m64n32k8 in 3xTF32 (M = the tile's points, N = the
//     CTA's outputs, K = C), A = the tile's sem_in rows split in registers,
//     B = W0^T's k-slices, host-packed as TF32 high and low parts in wgmma's
//     K-major B layout (pack_frozen, as pack_ring packs K4's layers), four
//     k-slices an 8 KB stage of a ring of up to six; W0 never sits whole in
//     shared memory (80 KB a rank at C = 319). Its epilogue forms ds from
//     the accumulators and writes it to shared memory as dW0's B operand
//     ([output][point] per k-slice of 8 points: K-major), TF32 high and low
//     parts as split() forms them, and the small sums (dW1, db0, db1) by
//     shuffles over the warp's points in a fixed order into registers;
//   * D0/D1: dW0 += sem_in^T ds on wgmma m64n32k8 in 3xTF32 (M = features
//     in blocks of 64, N = the CTA's outputs, K = the tile's 64 points),
//     A = sem_in read transposed from the X stage into registers and split,
//     B = F's ds; D0 takes feature blocks 0-2, D1 3-5 (C <= 384). TF32
//     wgmma takes only K-major shared-memory operands, hence A from
//     registers for both products. The points are permuted inside a tile
//     (F: accumulator row 16 w + g is point 4 g + w; D: k position j of
//     slice kk is point kk + 8 j) so that a fragment's loads of rows C
//     floats apart hit 32 banks for odd C;
//   * registers: 128 a thread (512 threads; ptxas allocates within the
//     launch bound, setmaxnreg or not: at 64 outputs a CTA, with D's 96
//     accumulators, it serialised the wgmma (C7512) and spilled, and so it
//     did with setmaxnreg 232 for D). D: 3 blocks x 16 accumulators = 48
//     (the CTA's C x 32 dW0 share over two warpgroups, kept for the whole
//     run) + 24 A parts; F: 16 accumulators + 48 A registers and raw loads
//     of a stage, the small sums and d_sem 4 x sem_dim (rounded up to 2, 4
//     or 8: a template argument);
//   * shared memory: two X stages (163,328 B at C = 319), ds (16,384 B),
//     six W0 stages (49,152 B) and the barriers: 229,120 B of 232,448;
//     the widest head (C = 382: a skip after the last trunk layer, with
//     coordinates) takes two X stages beside two W0 stages
//     (ops/fused_render._frozen_plan; one X stage where two do not fit);
//   * each cluster writes its partial gradient buffer (each entry by one
//     CTA) and reduce_partials sums the buffers in cluster order: two
//     calls give bitwise-equal gradients;
//   * every mbarrier wait traps after ~19 s (mbar_wait): a protocol fault
//     ends the launch with an error rather than hanging the card.
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
// cotangent before its gate (bwd_layer's add). K3's mode runs the sweep it
// ran before. Bound: arithmetic, K3's work plus the semantic head's
// backward (~3.8 MFLOP a flagship point); the extra planes (s_act, d_sem,
// ds: 264 rows a tile) add ~8% to the per-CTA workspace.
//
// K3 and K6 at --compute_dtype bfloat16 (_train_render_bwd_kernel with
// compute_dtype bfloat16) run a bf16 mode of both kernels
// (train_forward_wg_kernel<kMode, kInPoint, true>, train_reverse_kernel<kSem,
// false, true>): the storing forward is K4's bf16 tile that also rounds each
// stored activation to bf16 (emb, the view PE, every trunk layer's output,
// feat, hv, s_act: JAX's bf16 values, in the fp32 planes); the composite and
// its cotangent stay fp32 (P_DRGB, P_DSIG and d_sem unrounded, as JAX's bias
// sums read them); the reverse sweep's dX and dW products run wgmma
// m64nNk16 bf16 on operands rounded as they are loaded (the input-gradient
// matrices in pack_bwd_ring's bf16 layout), and bwd_layer's epilogue rounds
// dhv, d_feat, ds and each trunk dpre to bf16 after its gate, so the next
// product and its bias sum see JAX's rounded values. The partials are summed
// in CTA order, as in fp32 mode.
//
// mip-NeRF's three kernels:
//   K9   fused_mip_render_planar -> _mip_render_kernel: the train forward
//        without noise on odvr [R, 10] (o, d, viewdirs, radius) and
//        fenceposts z [R, S + 1] -> maps [R, 5] (w·rgb x3, w·mid, w) and
//        w [R, S];
//   K10a _mip_train_fwd_impl -> _mip_train_kernel: the same with the noise;
//   K10b _mip_train_bwd -> _mip_train_bwd_kernel: K6's kernels without the
//        semantic head in their mip mode (the storing forward
//        train_forward_wg_kernel<kCotangent, kInMip> on K4's tile, the mip
//        composite's reverse, the reverse sweep), from dmaps [R, 5] and
//        dweights [R, S].
// K9 and K10a are K4's kernel in its mip mode (train_render_wg_kernel<kInMip>,
// wg_tile.cuh: 128-point tiles, two consumer warpgroups on wgmma 3xTF32, the
// trunk's, feature's and views' weights through the TMA ring), and K10b's
// forward is K6's storing forward in the same mode. A point is an
// interval (t0, t1) of its ray. The tile's prologue builds the cone
// frustum's diagonal Gaussian per point (tile_mlp.cuh frustum_gauss, the
// stable closed forms, one rounding per operation so the means are the
// plain version's bit for bit: the integrated PE multiplies them by up to
// 2^9) into six scratch rows of the warpgroup's h tile, and from them its
// integrated PE (ipe_rows_wg: 60 rows at multires 10, padded to 64, no
// raw-input rows) in place of the point PE; the composite takes
// D = (t1 - t0)·‖d‖ with no far pad and the midpoint as the depth, and
// K10b's cotangent mode reads the midpoint in dw. Everything else (the
// trunk with its [emb, h] skip, the heads, the reverse sweep, the
// CTA-ordered reduction) is K4's and K6's. Bound: the same arithmetic as
// K4 and K6 without the semantic head (~1.18 MFLOP a point forward, ~3x
// that for K10b); the Gaussian and the 60 sin/exp of a point are ~1% of it.
// At --compute_dtype bfloat16 (_mip_render_kernel, _mip_train_kernel and
// _mip_train_bwd_kernel with compute_dtype bfloat16) the three run the bf16
// modes of K4's tile and of K6's kernels in the mip mode
// (train_render_wg_kernel<kInMip, true>, train_forward_wg_kernel<kCotangent,
// kInMip, true>, train_reverse_kernel<false, false, true>): the Gaussians
// and the integrated PE stay exact fp32, the IPE is rounded to bf16 as the
// products read it (and as K10b's forward stores it), and the composite and
// its cotangent stay fp32, as K6's bf16 mode has them.

// The forward tile, the reverse sweep and the reduction live in
// train_sweep.cuh, which the field kernels (fused_field.cu) share.
#include "wg_tile.cuh"

// Translation-unit parts (nerfsos_torch/_build.py PARTS). Compiled as one
// unit (NERF_PART undefined) this file holds every kernel. _build compiles
// it once a part with -DNERF_PART=p, so that one nvcc a part runs at once:
// part p holds the launches (and so the instantiations) of its kernels,
// each a function of external linkage that the C entry points of part 0
// (and K5's of part 2) call: 0 train_render_wg_kernel at fp32, 1 at bf16,
// 2 K5, 3 the storing forwards at fp32, 4 at bf16, 5 the reverse sweeps at
// fp32, 6 at bf16.
#ifdef NERF_PART
#define NERF_IN_PART(p) (NERF_PART == (p))
#else
#define NERF_IN_PART(p) 1
#endif

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
// The two consumer warpgroups of K4's tile run it (threads 0 ..
// kWgConsumers - 1 of the CTA). kCols: the floats of a ray of odv (K1: od
// [R, 6]).
template <int kMode, bool kMip = false, int kCols = kMip ? 10 : 9>
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
  for (int rl = threadIdx.x; rl < nr; rl += kWgConsumers) {
    const float* ray = odv + (size_t)(r0 + rl) * kCols;
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
  for (int q = nq + threadIdx.x; kMode != kForward && q < nsub * kPts; q += kWgConsumers) {
    const int sub = q / kPts, p = q % kPts;  // the last tile's tail
    plane(ws, d, P_DSIG, sub)[p] = 0.f;
    float* dr = plane(ws, d, P_DRGB, sub);
    for (int j = 0; j < 3; ++j) dr[j * kLd + p] = 0.f;
    if (kMode == kCotangent)
      for (int j = 0; j < sem; ++j) plane(ws, d, p_dsem, sub)[j * kLd + p] = 0.f;
  }
}

// The padding rows of the cotangent planes of a workspace slice, which
// nothing else writes (rows 3-7 of P_DRGB, 1-7 of P_DSIG, sem.. 7 of d_sem),
// zeroed for the rays_per_chunk * S points of a chunk by the CTA's threads.
template <int kMode>
__device__ __forceinline__ void zero_cotangent_padding(float* ws, const TrainDesc& d, int S) {
  for (int sub = 0; sub < (d.rays_per_chunk * S + kPts - 1) / kPts; ++sub) {
    float* r = plane(ws, d, P_DRGB, sub);
    float* s = plane(ws, d, P_DSIG, sub);
    for (int i = threadIdx.x; i < 5 * kLd; i += kWgThreads) r[3 * kLd + i] = 0.f;
    for (int i = threadIdx.x; i < 7 * kLd; i += kWgThreads) s[kLd + i] = 0.f;
    if (kMode == kCotangent && d.f.sem_dim > 0) {
      float* m = plane(ws, d, P_ACT0 + d.f.depth + 1, sub);
      for (int i = threadIdx.x; i < (8 - d.f.sem_dim) * kLd; i += kWgThreads)
        m[d.f.sem_dim * kLd + i] = 0.f;
    }
  }
}

// K4: CTA b takes chunk b (d.rays_per_chunk rays, nq points) in tiles of
// 128 points (wg_tile.cuh: wg_cta's shared memory, wg_consumer's two
// consumer warpgroups and producer thread); then the consumers composite
// the chunk with the sigma noise into maps and weights (a thread a ray).
// kIn (wg_tile.cuh InMode): kInPoint K4 (and K2: noise 0, semin null);
// kInSigma K1 (noise 0, maps and semin null): odv is od [R, 6] and the
// tiles run the trunk and the alpha head alone, only the weights are
// written; kInMip K9 (noise 0) and K10a (semin null): odv is odvr [R, 10]
// and z fenceposts [R, S + 1], the tiles start from the intervals'
// Gaussians and their integrated PE, and the composite is the mip one
// (maps [R, 5]). The ring holds ring_order's layers: the trunk, then but
// for kInSigma sem_0 (with the semantic head), feature and views.
// kBf16 (kInPoint, kInSigma, kInMip): the tile's bf16 mode (wg_tile.cuh; K4,
// K2, K1, K9 and K10a at --compute_dtype bfloat16), the ring in pack_ring's
// bf16 layout, sem_in a bf16 array; the composite is fp32 mode's.
template <int kIn, bool kBf16 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    train_render_wg_kernel(const float* __restrict__ odv, const float* __restrict__ z,
                           const float* __restrict__ params, const float* __restrict__ ring,
                           const __grid_constant__ TrainDesc d,
                           const __grid_constant__ RingDesc rd, float* __restrict__ maps,
                           float* __restrict__ weights,
                           typename std::conditional<kBf16, __nv_bfloat16, float>::type*
                               __restrict__ semin,
                           int R, int S, unsigned seed, float noise_std) {
  constexpr bool kMip = kIn == kInMip;
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const WgCta cta = wg_cta(wg_raw, d.f, rd);
  const int rpc = d.rays_per_chunk, r0 = blockIdx.x * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int ntiles = (nq + kWgTile - 1) / kWgTile;
  __syncthreads();
  if (!wg_consumer<kBf16>(ring, d.f, rd, cta.rg, ntiles, kIn != kInSigma)) return;
  float* mine = cta.tiles + (threadIdx.x >> 7) * cta.per_wg;
  float* strip = cta.strip;
  const float* zc = z + (size_t)r0 * (kMip ? S + 1 : S);
  int pos = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    pos = wg_forward_tile<false, false, kIn, kBf16>(odv, zc, r0, S, nq, tile, params, d, rd,
                                                    cta.rg, pos, mine, strip, semin,
                                                    (long long)r0 * S, nullptr);
  asm volatile("bar.sync 3, %0;\n" ::"n"(kWgConsumers) : "memory");  // the strip is whole
  composite_chunk<kForward, kMip, kIn == kInSigma ? 6 : kMip ? 10 : 9>(
      odv, zc, nullptr, nullptr, d, nullptr, strip, maps, weights, r0, nr, S, 0, seed, noise_std,
      0);
}

// K3 (kLoss) and K6 (kCotangent): wave `wave` of the storing forward on
// K4's tile. CTA b takes chunk wave * gridDim.x + b in 128-point tiles
// (threads, registers and shared memory as train_render_wg_kernel's) and
// writes every activation the reverse sweep reads into its workspace slice
// b, sub 2 t + w for warpgroup w of tile t (wg_forward_tile's kStore) of
// d's planes (group_desc's for its place in a group of `group` forward
// waves, which zero the cotangent planes' padding rows in the first
// group); then the consumers composite the chunk (kLoss: maps, weights,
// dsigma and drgb from gt = aux; kCotangent: dsigma, drgb and d_sem from
// dmaps = aux and dweights). K10b (kCotangent, kIn kInMip): odv is odvr
// [R, 10] and z fenceposts [R, S + 1], the tiles start from the intervals'
// Gaussians and their integrated PE, and the composite is the mip one.
// kBf16 (K3, K6 at --compute_dtype bfloat16, kInPoint; K10b, kInMip): the
// tile's bf16 storing mode (the ring in pack_ring's bf16 layout, the
// workspace planes holding the bf16 activations); the composite is fp32
// mode's.
// train_reverse_kernel then sweeps the slice.
template <int kMode, int kIn = kInPoint, bool kBf16 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    train_forward_wg_kernel(const float* __restrict__ odv, const float* __restrict__ z,
                            const float* __restrict__ aux, const float* __restrict__ dweights,
                            const float* __restrict__ params, const float* __restrict__ ring,
                            const __grid_constant__ TrainDesc d,
                            const __grid_constant__ RingDesc rd, float* __restrict__ maps,
                            float* __restrict__ weights, float* __restrict__ workspace, int R,
                            int S, int wave, int group, unsigned seed, float noise_std,
                            int white_bkgd) {
  constexpr bool kMip = kIn == kInMip;
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const int rpc = d.rays_per_chunk, c = wave * gridDim.x + blockIdx.x;
  if (c * rpc >= R) return;
  const WgCta cta = wg_cta(wg_raw, d.f, rd);
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  const int r0 = c * rpc, nr = min(rpc, R - r0), nq = nr * S;
  const int ntiles = (nq + kWgTile - 1) / kWgTile, nsub = (nq + kPts - 1) / kPts;
  if (wave < group) zero_cotangent_padding<kMode>(ws, d, S);
  __syncthreads();
  if (!wg_consumer<kBf16>(ring, d.f, rd, cta.rg, ntiles)) return;
  float* mine = cta.tiles + (threadIdx.x >> 7) * cta.per_wg;
  float* strip = cta.strip;
  const float* zc = z + (size_t)r0 * (kMip ? S + 1 : S);
  int pos = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    pos = wg_forward_tile<true, kMode == kCotangent, kIn, kBf16>(
        odv, zc, r0, S, nq, tile, params, d, rd, cta.rg, pos, mine, strip, nullptr, 0, ws);
  asm volatile("bar.sync 3, %0;\n" ::"n"(kWgConsumers) : "memory");  // the strip is whole
  composite_chunk<kMode, kMip>(odv, zc, aux, dweights, d, ws, strip, maps, weights, r0, nr, S,
                               nsub, seed, noise_std, white_bkgd);
}

// K5: the semantic head's weight gradients for a frozen backbone, on a
// cluster of four CTAs a run of 64-point tiles (the design is in the header
// of this file).
constexpr int kSemRanks = 4;      // CTAs a cluster
constexpr int kSemPts = 64;       // points a tile
constexpr int kSemCols = 32;      // sem_0 outputs a CTA: cluster rank r has 32 r ..
constexpr int kSemKs = 4;         // W0 k-slices of 8 rows a ring stage
constexpr int kSemSlice = 16 * kSemCols;          // floats a k-slice, hi + lo (2 KB)
constexpr int kSemStage = kSemKs * kSemSlice;     // floats a W0 ring stage (8 KB)
constexpr int kSemDs = 8 * kSemSlice;             // floats of the tile's ds as B (16 KB)
constexpr int kSemBars = 256;     // bytes of the CTA's barriers
constexpr int kSemMb = 3;         // m64 feature blocks of dW0 a dW0 warpgroup
constexpr int kSemThreads = 512;  // F, D0, D1 and the producer warpgroup
constexpr int kSemRelease = 12;   // arrivals a CTA frees an X stage with: 4 warps x 3
// The bf16 mode (--compute_dtype bfloat16): a W0 k-slice is 16 rows of bf16
// (1 KB), a stage kSemKs of them (4 KB); ds is the tile's four k16 slices
// of bf16 (4 KB) at the start of kSemDs's room; sem_in's tiles are bf16.
constexpr int kSemSlice16 = 8 * kSemCols;            // 4-byte words a bf16 k16 slice
constexpr int kSemStage16 = kSemKs * kSemSlice16;    // words a bf16 W0 ring stage

// words of a W0 ring stage, and bytes of a sem_in element, in each mode
template <bool kBf16>
__host__ __device__ constexpr int sem_stage_words() { return kBf16 ? kSemStage16 : kSemStage; }
template <bool kBf16>
__host__ __device__ constexpr int sem_x_bytes() { return kBf16 ? 2 : 4; }
}  // namespace

constexpr int kMaxSemWStages = 6;

// Host-visible: the C entry point takes a FrozenDesc* (ops/fused_render.pack_frozen).
struct FrozenDesc {
  long long b0, w1;              // sem_0's bias [hidden], sem_1's weight [sem_dim][hidden]
  long long gw0, gb0, gw1, gb1;  // gradient buffer: dW0^T [C][hidden], db0 [hidden],
                                 //   dW1^T [hidden][sem_dim], db1 [sem_dim]
  long long grad_size;
  int C;                         // sem_in columns
  int kslices;                   // W0^T's k-slices of 8 rows (C padded to 32) a rank;
                                 //   bf16: of 16 rows (C padded to 64)
  int hidden, sem_dim, n_maps;
  int xstages, wstages;          // sem_in tile stages (1-2), W0 ring stages (2-6)
  int bf16;                      // 1: the bf16 mode (sem_in bf16, pack_frozen's bf16 ring)
};

namespace {

// The X (sem_in tile) and W0 rings and the ds hand-off of a K5 CTA, in its
// dynamic shared memory: barriers (kSemBars), the X stages, ds, the W0 stages.
struct SemCta {
  uint64_t *xfull, *xempty, *wfull, *wempty, *dsfull, *dsempty;
  float *xs, *ds, *ws;  // bf16 mode: xs holds bf16 tiles, ds bf16 k16 slices
};

// The producer warp of the X ring: tile i of the cluster's run into stage
// i % xstages once every CTA's consumers freed it (rank 0's empty barrier
// counts the other ranks' arrivals too); rank 0 multicasts each full tile
// (64 rows of C floats, one contiguous block) to the cluster's CTAs, the
// others only expect its bytes; the ragged last tile each CTA copies
// itself, rows past np zeroed. kBf16: sem_in's elements are bf16.
template <bool kBf16>
__device__ __forceinline__ void sem_x_producer(const void* __restrict__ semin, const SemCta& c,
                                               const FrozenDesc& d, uint32_t rank,
                                               long long t0, int nt, long long P) {
  using XT = typename std::conditional<kBf16, uint16_t, float>::type;
  const int lane = threadIdx.x & 31, C = d.C;
  for (int i = 0; i < nt; ++i) {
    const int slot = i % d.xstages;
    const long long q0 = (t0 + i) * kSemPts;
    const int np = (int)min((long long)kSemPts, P - q0);
    XT* dst = reinterpret_cast<XT*>(c.xs) + (size_t)slot * kSemPts * C;
    const XT* src = static_cast<const XT*>(semin) + q0 * C;
    if (lane == 0) mbar_wait(c.xempty + slot, ((i / d.xstages) & 1) ^ 1);
    __syncwarp();
    if (np == kSemPts) {
      if (lane == 0) {
        const uint32_t bytes = kSemPts * C * sem_x_bytes<kBf16>();
        mbar_expect_tx(c.xfull + slot, bytes);
        if (rank == 0)
          bulk_g2s_multicast(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
                             bytes, c.xfull + slot, (1 << kSemRanks) - 1);
      }
    } else {
      for (int e = lane; e < kSemPts * C; e += 32) dst[e] = e < np * C ? __ldg(src + e) : XT(0);
      __syncwarp();
      if (lane == 0) mbar_arrive(c.xfull + slot);
    }
  }
}

// The W0 ring's producer (one thread): this rank's k-slices of W0^T, every
// tile of the run, kSemKs slices a stage (kBf16: bf16 k16 slices).
template <bool kBf16>
__device__ __forceinline__ void sem_w_producer(const float* __restrict__ ring, const SemCta& c,
                                               const FrozenDesc& d, int nt) {
  constexpr int kStage = sem_stage_words<kBf16>();
  const int nst = d.kslices / kSemKs;
  int pos = 0;
  for (int i = 0; i < nt; ++i)
    for (int s = 0; s < nst; ++s, ++pos) {
      const int slot = pos % d.wstages;
      mbar_wait(c.wempty + slot, ((pos / d.wstages) & 1) ^ 1);
      mbar_expect_tx(c.wfull + slot, kStage * 4);
      bulk_g2s(c.ws + (size_t)slot * kStage, ring + (size_t)s * kStage, kStage * 4,
               c.wfull + slot);
    }
}

// An X stage is done with for this warp: every CTA's consumers free it on
// their own barrier, the other ranks' also on rank 0's (whose producer
// multicasts).
__device__ __forceinline__ void sem_release_x(const SemCta& c, int slot, uint32_t rank) {
  fence_proxy_async_smem();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(c.xempty + slot);
    if (rank != 0) mbar_arrive_remote(c.xempty + slot, 0);
  }
}

// v[q] (q < 4) summed over the 8 lanes of a warp that share lane & 3 (lane
// bits 2-4, g = lane >> 2): lanes g = 2 q and 2 q + 1 get the sum of v[q],
// by a reduce-scatter of 4 shuffles (each step hands the partner the half
// of the values it keeps); the order of the additions is fixed, so the
// result is deterministic and the same in both lanes.
__device__ __forceinline__ float sum_scatter4(const float (&v)[4], int g) {
  const bool h2 = (g >> 2) & 1, h1 = (g >> 1) & 1;
  float a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a[i] = (h2 ? v[2 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, h2 ? v[i] : v[2 + i], 16);
  const float b = (h1 ? a[1] : a[0]) + __shfl_xor_sync(0xffffffffu, h1 ? a[0] : a[1], 8);
  return b + __shfl_xor_sync(0xffffffffu, b, 4);
}

// The forward warpgroup (F): per tile, s_pre = X W0 (M = the tile's 64
// points, N = this CTA's 32 outputs, K = C) through the W0 ring; then, once
// the dW0 warpgroups are done with the last tile's ds, the epilogue:
// d_sem = dmaps[ray, 5 + j] w of the thread's two points, ds = (W1^T d_sem)
// [s_pre + b0 > 0] written as dW0's B operand (TF32 high and low parts,
// point p at k position p / 8 of k-slice p % 8), and the small sums in
// registers: accumulator row m0 (m0 + 8) is point 4 g + w (+ 32), whose
// X row loads then hit 32 banks for odd C; each (output, j) sum over the
// warp's 16 points by a reduce-scatter of shuffles in a fixed order
// (sum_scatter4), kept by lanes 2 q and 2 q + 1 of its output group q. kS: sem_dim rounded
// up to 2, 4 or 8 (the sums' registers). At the end the four warps' sums
// are added in order through the (then idle) W0 ring's shared memory into
// the partial buffer gp.
// kBf16: the JAX kernel's bf16 semantics (_train_frozen_bwd_kernel at
// compute_dtype bfloat16): s_pre on bf16 wgmma m64n32k16 (A = the bf16
// sem_in rows, k position j of a k16 slice its column 16 s + j), s_act =
// bf16(relu(s_pre + b0)), d_sem_c = bf16(d_sem), ds = bf16([s_act > 0]
// bf16(W1)^T d_sem_c) written as dW0's bf16 B operand (point p at k
// position p % 16 of k16 slice p / 16), dW1 from s_act and d_sem_c, db0 from
// the rounded ds, db1 from the unrounded d_sem.
template <int kS, bool kBf16>
__device__ __forceinline__ void sem_forward_wg(const float* __restrict__ weights,
                                               const float* __restrict__ dmaps,
                                               const float* __restrict__ params, const SemCta& c,
                                               const FrozenDesc& d, uint32_t rank, long long t0,
                                               int nt, long long P, int S, float* gp) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int C = d.C, sem = d.sem_dim, hidden = d.hidden, n0 = rank * kSemCols;
  const int nb = min(kSemCols, hidden - n0), nst = d.kslices / kSemKs;
  const int pa = 4 * g + w, pb = pa + 32;  // the points of accumulator rows m0, m0 + 8
  const float* __restrict__ b0 = params + d.b0;
  const float* __restrict__ w1 = params + d.w1;
  // this lane's sums over its warp's points: dW1 and db0 of outputs
  // 8 (g >> 1) + 2 t + e, db1 (kept by lane 0)
  float dw1r[2][kS], db0r[2] = {0.f, 0.f}, db1r[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) dw1r[0][j] = dw1r[1][j] = db1r[j] = 0.f;
  int wpos = 0;
  for (int i = 0; i < nt; ++i) {
    const int slot = i % d.xstages;
    const long long q0 = (t0 + i) * kSemPts;
    const int np = (int)min((long long)kSemPts, P - q0);
    mbar_wait(c.xfull + slot, (i / d.xstages) & 1);
    const float* x = c.xs + (size_t)slot * kSemPts * C;
    const float* xa = x + (size_t)pa * C;
    const float* xb = x + (size_t)pb * C;
    const uint16_t* x16 = reinterpret_cast<const uint16_t*>(c.xs) + (size_t)slot * kSemPts * C;
    const uint16_t* xa16 = x16 + (size_t)pa * C;
    const uint16_t* xb16 = x16 + (size_t)pb * C;
    // bf16: the A registers of the stage's k16 slices (0 past column C)
    auto load16 = [&](int st, uint32_t (&a)[kSemKs][4]) {
      auto col = [&](const uint16_t* r, int k) { return k < C ? r[k] : (uint16_t)0; };
#pragma unroll
      for (int kk = 0; kk < kSemKs; ++kk) {
        const int k = 16 * (kSemKs * st + kk) + 2 * t;
        a[kk][0] = pack_bf16(col(xa16, k), col(xa16, k + 1));
        a[kk][1] = pack_bf16(col(xb16, k), col(xb16, k + 1));
        a[kk][2] = pack_bf16(col(xa16, k + 8), col(xa16, k + 9));
        a[kk][3] = pack_bf16(col(xb16, k + 8), col(xb16, k + 9));
      }
    };
    auto load = [&](int st, float (&v)[kSemKs][4]) {
#pragma unroll
      for (int kk = 0; kk < kSemKs; ++kk) {
        const int k = 8 * (kSemKs * st + kk) + t;
        v[kk][0] = k < C ? xa[k] : 0.f;
        v[kk][1] = k < C ? xb[k] : 0.f;
        v[kk][2] = k + 4 < C ? xa[k + 4] : 0.f;
        v[kk][3] = k + 4 < C ? xb[k + 4] : 0.f;
      }
    };
    // two accumulators, the even and the odd k-slices', so that no wgmma
    // waits on the one before it (an m64n32k8's work is short beside the
    // latency of its accumulator); summed after the loop
    float acc[kSemCols / 2], acc1[kSemCols / 2];
#pragma unroll
    for (int e = 0; e < kSemCols / 2; ++e) acc[e] = acc1[e] = 0.f;
    for (int st = 0; st < nst; ++st, ++wpos) {
      // the stage's A values are loaded while the W0 stage may still be
      // landing, and split after (a prefetch of the next stage's cost 16
      // registers and spilled); bf16: the A registers themselves
      float raw[kSemKs][4];
      uint32_t a16[kSemKs][4];
      if constexpr (kBf16) {
        load16(st, a16);
      } else {
        load(st, raw);
      }
      const int wslot = wpos % d.wstages;
      mbar_wait(c.wfull + wslot, (wpos / d.wstages) & 1);
      if constexpr (kBf16) {
        const float* b = c.ws + (size_t)wslot * kSemStage16;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSemKs; ++kk) {
          float(&ac)[kSemCols / 2] = kk & 1 ? acc1 : acc;
          WgmmaBf16<kSemCols>::mma(ac, a16[kk], b_desc(b + kk * kSemSlice16));
        }
      } else {
      uint32_t ahi[kSemKs][4], alo[kSemKs][4];
#pragma unroll
      for (int kk = 0; kk < kSemKs; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) split(raw[kk][e], ahi[kk][e], alo[kk][e]);
      const float* b = c.ws + (size_t)wslot * kSemStage;
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < 3; ++pr)  // lo x hi, hi x lo, hi x hi of every k-slice
#pragma unroll
        for (int kk = 0; kk < kSemKs; ++kk) {
          const uint64_t bd = b_desc(b + kk * kSemSlice + (pr == 1 ? 8 * kSemCols : 0));
          float(&ac)[kSemCols / 2] = kk & 1 ? acc1 : acc;
          Wgmma<kSemCols>::mma(ac, pr == 0 ? alo[kk] : ahi[kk], bd);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(c.wempty + wslot);  // the stage is free
    }
#pragma unroll
    for (int e = 0; e < kSemCols / 2; ++e) {
      asm volatile("" : "+f"(acc[e]), "+f"(acc1[e])::"memory");
      acc[e] += acc1[e];
    }
    sem_release_x(c, slot, rank);

    // d_sem of the thread's two points (0 past the tile's points and for j >= sem)
    float da[kS], dbv[kS];
    const bool va = pa < np, vb = pb < np;
    const float wa = va ? __ldg(weights + q0 + pa) : 0.f, wb = vb ? __ldg(weights + q0 + pb) : 0.f;
    const float* ma = dmaps + ((q0 + pa) / S) * d.n_maps + 5;
    const float* mb = dmaps + ((q0 + pb) / S) * d.n_maps + 5;
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      da[j] = j < sem && va ? __ldg(ma + j) * wa : 0.f;
      dbv[j] = j < sem && vb ? __ldg(mb + j) * wb : 0.f;
    }
    // the products' d_sem: bf16 rounded in the bf16 mode (the sums of db1 keep da, dbv)
    float dca[kS], dcb[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      dca[j] = kBf16 ? bf16r(da[j]) : da[j];
      dcb[j] = kBf16 ? bf16r(dbv[j]) : dbv[j];
    }
    mbar_wait(c.dsempty, (i & 1) ^ 1);  // the dW0 warpgroups are done with the last ds
    float* sla = c.ds + (pa & 7) * kSemSlice;
    float* slb = c.ds + (pb & 7) * kSemSlice;
    __nv_bfloat16* ds16 = reinterpret_cast<__nv_bfloat16*>(c.ds);
    // accumulator 4 q + 2 r + e: point row r (pa, pb), output n = 8 q + 2 t + e
    constexpr int kQ = kSemCols / 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float bias[kQ], v[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int n = 8 * q + 2 * t + e;
        const bool live = n < nb;
        bias[q] = live ? __ldg(b0 + n0 + n) : 0.f;
        float sa = acc[4 * q + e] + bias[q], sb = acc[4 * q + 2 + e] + bias[q];
        if (kBf16) {  // s_act, bf16 rounded: its sign gates ds
          sa = bf16r(fmaxf(sa, 0.f));
          sb = bf16r(fmaxf(sb, 0.f));
        }
        float ga = 0.f, gb = 0.f;  // W1^T d_sem
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          float w1v = live && j < sem ? __ldg(w1 + (size_t)j * hidden + n0 + n) : 0.f;
          if (kBf16) w1v = bf16r(w1v);
          ga = fmaf(w1v, dca[j], ga);
          gb = fmaf(w1v, dcb[j], gb);
        }
        float dsa = sa > 0.f ? ga : 0.f, dsb = sb > 0.f ? gb : 0.f;
        if constexpr (kBf16) {
          dsa = bf16r(dsa);
          dsb = bf16r(dsb);
          store_b_bf16(ds16 + (pa >> 4) * (2 * kSemSlice16), pa & 15, n, dsa);
          store_b_bf16(ds16 + (pb >> 4) * (2 * kSemSlice16), pb & 15, n, dsb);
        } else {
          store_b_split(sla, kSemCols, pa >> 3, n, dsa);
          store_b_split(slb, kSemCols, pb >> 3, n, dsb);
        }
        v[q] = dsa + dsb;
      }
      db0r[e] += sum_scatter4(v, g);  // db0 of output 8 (g >> 1) + 2 t + e
#pragma unroll
      for (int j = 0; j < kS; ++j) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          if (kBf16) {  // acc was left unrounded: s_act again
            v[q] = bf16r(fmaxf(acc[4 * q + e] + bias[q], 0.f)) * dca[j] +
                   bf16r(fmaxf(acc[4 * q + 2 + e] + bias[q], 0.f)) * dcb[j];
          } else {
            v[q] = fmaxf(acc[4 * q + e] + bias[q], 0.f) * da[j] +
                   fmaxf(acc[4 * q + 2 + e] + bias[q], 0.f) * dbv[j];
          }
        dw1r[e][j] += sum_scatter4(v, g);
      }
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) {  // db1 over the warp's 16 points
      float u = da[j] + dbv[j];
      u += __shfl_xor_sync(0xffffffffu, u, 4);
      u += __shfl_xor_sync(0xffffffffu, u, 8);
      u += __shfl_xor_sync(0xffffffffu, u, 16);
      db1r[j] += u;
    }
    fence_proxy_async_smem();  // ds is read by the dW0 warpgroups' wgmma
    __syncwarp();
    if (lane == 0) mbar_arrive(c.dsfull);
  }

  // the four warps' sums in order: each warp's into the W0 ring's stages
  // (every fill has landed and been read), then one thread an entry
  float* red = c.ws;  // [4][kSemCols][kMaxSem + 1], then db1 [4][kMaxSem]
  constexpr int kRed = kSemCols * (kMaxSem + 1);
#pragma unroll
  for (int e = 0; e < 2 && (g & 1) == 0; ++e) {
    float* r = red + w * kRed + (8 * (g >> 1) + 2 * t + e) * (kMaxSem + 1);
#pragma unroll
    for (int j = 0; j < kS; ++j) r[j] = dw1r[e][j];
    r[kMaxSem] = db0r[e];
  }
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < kS; ++j) red[4 * kRed + w * kMaxSem + j] = db1r[j];
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const int tid = threadIdx.x & 127;
  for (int e = tid; e < nb * (sem + 1); e += 128) {
    const int n = e / (sem + 1), j = e % (sem + 1);
    const int k = j < sem ? j : kMaxSem;
    float v = 0.f;
    for (int ww = 0; ww < 4; ++ww) v += red[ww * kRed + n * (kMaxSem + 1) + k];
    if (j < sem) {
      gp[d.gw1 + (size_t)(n0 + n) * sem + j] = v;
    } else {
      gp[d.gb0 + n0 + n] = v;
    }
  }
  if (rank == 0 && tid < sem) {
    float v = 0.f;
    for (int ww = 0; ww < 4; ++ww) v += red[4 * kRed + ww * kMaxSem + tid];
    gp[d.gb1 + tid] = v;
  }
}

// A dW0 warpgroup (D0 or D1: dwg): dW0[c][n] += sum_p X[p][c] ds[p][n] for
// its kNb feature blocks c in 64 (kSemMb dwg + u) .. + 64 (u < kNb: those
// that start below C; a block's count is a template argument, so no wgmma
// sits under a runtime branch, which made ptxas serialise them, C7520),
// M = features, N = the CTA's 32 outputs, K = the tile's points,
// A = X^T from the X stage in registers (k position j of slice kk is point
// kk + 8 j, so a fragment's loads hit 32 banks for odd C), B = the F
// warpgroup's ds; its accumulators stay in registers for the whole run and
// go to the partial buffer gp at the end.
// kBf16: bf16 wgmma m64n32k16 over the tile's four k16 slices (k position j
// of slice kk is point 16 kk + j), A = X^T from the bf16 X stage, B = F's
// bf16 ds.
template <int kNb, bool kBf16>
__device__ __forceinline__ void sem_dw0_wg(int dwg, const SemCta& c, const FrozenDesc& d,
                                           uint32_t rank, int nt, float* gp) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int C = d.C, hidden = d.hidden, n0 = rank * kSemCols;
  const int nb = min(kSemCols, hidden - n0);
  const int m0 = 16 * w + g;
  float acc[kNb > 0 ? kNb : 1][kSemCols / 2];
#pragma unroll
  for (int u = 0; u < kNb; ++u)
#pragma unroll
    for (int e = 0; e < kSemCols / 2; ++e) acc[u][e] = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int slot = i % d.xstages;
    mbar_wait(c.xfull + slot, (i / d.xstages) & 1);
    mbar_wait(c.dsfull, i & 1);
    const float* x = c.xs + (size_t)slot * kSemPts * C;
    if constexpr (kBf16) {
      const uint16_t* x16 = reinterpret_cast<const uint16_t*>(c.xs) + (size_t)slot * kSemPts * C;
      for (int kk = 0; kk < kSemPts / 16; ++kk) {
        if (kNb == 0) continue;
        const int p0 = 16 * kk + 2 * t;  // the points of k positions 2 t, 2 t + 1 (+ 8)
        uint32_t a[kNb > 0 ? kNb : 1][4];
#pragma unroll
        for (int u = 0; u < kNb; ++u)
          xt_fragment_bf16(x16, C, C, 64 * (kSemMb * dwg + u) + m0, p0, p0 + 8, a[u]);
        const uint64_t bd = b_desc(c.ds + kk * kSemSlice16);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < kNb; ++u) WgmmaBf16<kSemCols>::mma(acc[u], a[u], bd);
        wgmma_commit();
        wgmma_wait<0>();
      }
    } else {
    for (int kk = 0; kk < 8; ++kk) {
      const int pa = kk + 8 * t, pb = pa + 32;  // the points of k positions t, t + 4
      if (kNb == 0) continue;
      uint32_t ahi[kNb > 0 ? kNb : 1][4], alo[kNb > 0 ? kNb : 1][4];
#pragma unroll
      for (int u = 0; u < kNb; ++u)
        xt_fragment(x, C, C, 64 * (kSemMb * dwg + u) + m0, pa, pb, ahi[u], alo[u]);
      const float* b = c.ds + kk * kSemSlice;
      const uint64_t bhi = b_desc(b), blo = b_desc(b + 8 * kSemCols);
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < 3; ++pr)  // the blocks' chains interleaved
#pragma unroll
        for (int u = 0; u < kNb; ++u)
          Wgmma<kSemCols>::mma(acc[u], pr == 0 ? alo[u] : ahi[u], pr == 1 ? blo : bhi);
      wgmma_commit();
      wgmma_wait<0>();
    }
    }
#pragma unroll
    for (int u = 0; u < kNb; ++u)
#pragma unroll
      for (int e = 0; e < kSemCols / 2; ++e) asm volatile("" : "+f"(acc[u][e])::"memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(c.dsempty);
    sem_release_x(c, slot, rank);
  }
  // accumulator e of block u: feature 64 (kSemMb dwg + u) + m0 + 8 ((e >> 1) & 1),
  // output 8 (e >> 2) + 2 t + (e & 1)
#pragma unroll
  for (int u = 0; u < kNb; ++u)
#pragma unroll
    for (int e = 0; e < kSemCols / 2; ++e) {
      const int row = 64 * (kSemMb * dwg + u) + m0 + 8 * ((e >> 1) & 1);
      const int n = 8 * (e >> 2) + 2 * t + (e & 1);
      if (row < C && n < nb) gp[d.gw0 + (size_t)row * hidden + n0 + n] = acc[u][e];
    }
}

// K5: cluster k (CTAs 4 k .. 4 k + 3, rank r) takes tiles [k per, (k + 1)
// per) of the P points and writes its share (sem_0's outputs 32 r ..) of
// partial buffer k; every entry of the buffer is written by one CTA.
// kBf16: the bf16 mode (sem_in bf16, pack_frozen's bf16 ring).
template <bool kBf16>
__global__ void __cluster_dims__(kSemRanks, 1, 1) __launch_bounds__(kSemThreads, 1)
    frozen_sem_kernel(const void* __restrict__ semin, const float* __restrict__ weights,
                      const float* __restrict__ dmaps, const float* __restrict__ params,
                      const __grid_constant__ FrozenDesc d, float* __restrict__ partial,
                      long long P, int S, long long per) {
  extern __shared__ __align__(128) unsigned char sem_raw[];
  SemCta c;
  c.xfull = reinterpret_cast<uint64_t*>(sem_raw);
  c.xempty = c.xfull + 2;
  c.wfull = c.xempty + 2;
  c.wempty = c.wfull + kMaxSemWStages;
  c.dsfull = c.wempty + kMaxSemWStages;
  c.dsempty = c.dsfull + 1;
  c.xs = reinterpret_cast<float*>(sem_raw + kSemBars);
  c.ds = reinterpret_cast<float*>(sem_raw + kSemBars +
                                  (size_t)d.xstages * kSemPts * d.C * sem_x_bytes<kBf16>());
  c.ws = c.ds + kSemDs;
  const uint32_t rank = cluster_rank();
  const long long cl = blockIdx.x / kSemRanks, ntiles = (P + kSemPts - 1) / kSemPts;
  const long long t0 = cl * per;
  const int nt = (int)max(0ll, min(ntiles, t0 + per) - t0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < d.xstages; ++i) {
      mbar_init(c.xfull + i, 1);
      mbar_init(c.xempty + i, kSemRelease * (rank == 0 ? kSemRanks : 1));
    }
    for (int i = 0; i < d.wstages; ++i) {
      mbar_init(c.wfull + i, 1);
      mbar_init(c.wempty + i, 4);  // lane 0 of each F warp
    }
    mbar_init(c.dsfull, 4);   // lane 0 of each F warp
    mbar_init(c.dsempty, 8);  // lane 0 of each dW0 warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the peers' barriers are initialised before any remote signal
  float* gp = partial + (size_t)cl * d.grad_size;
  // the warpgroup, warp-uniform as ptxas sees it (a role branch on
  // threadIdx.x alone made it serialise the wgmma, C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 3) {
    const int warp = (threadIdx.x >> 5) & 3;
    if (warp == 0) {
      sem_x_producer<kBf16>(semin, c, d, rank, t0, nt, P);
    } else if (warp == 1 && (threadIdx.x & 31) == 0) {
      sem_w_producer<kBf16>(params + (size_t)rank * d.kslices * (kBf16 ? kSemSlice16 : kSemSlice),
                            c, d, nt);
    }
  } else if (wg == 0) {
    if (d.sem_dim <= 2) {
      sem_forward_wg<2, kBf16>(weights, dmaps, params, c, d, rank, t0, nt, P, S, gp);
    } else if (d.sem_dim <= 4) {
      sem_forward_wg<4, kBf16>(weights, dmaps, params, c, d, rank, t0, nt, P, S, gp);
    } else {
      sem_forward_wg<kMaxSem, kBf16>(weights, dmaps, params, c, d, rank, t0, nt, P, S, gp);
    }
  } else {
    // D0 takes feature blocks 0-2, D1 3-5, each those that start below C
    const int nblk = min(kSemMb, max(0, (d.C + 63) / 64 - kSemMb * (wg - 1)));
    if (nblk == 3) {
      sem_dw0_wg<3, kBf16>(wg - 1, c, d, rank, nt, gp);
    } else if (nblk == 2) {
      sem_dw0_wg<2, kBf16>(wg - 1, c, d, rank, nt, gp);
    } else if (nblk == 1) {
      sem_dw0_wg<1, kBf16>(wg - 1, c, d, rank, nt, gp);
    } else {
      sem_dw0_wg<0, kBf16>(wg - 1, c, d, rank, nt, gp);
    }
  }
  __syncwarp();
  cluster_sync();  // no CTA exits while a peer may still signal it
}

// shared memory of train_render_wg_kernel (K4, K2, K1, K9, K10a) and of K3's,
// K6's and K10b's forward (train_forward_wg_kernel); ops/fused_render.py _wg_smem
// computes the same
int wg_smem(const TrainDesc* d, const RingDesc* rd, int S) {
  const MLPDesc& f = d->f;
  const size_t rows = (f.emb_dim + 7) / 8 * 8 + (f.demb_dim + 7) / 8 * 8 + rd->hrows;
  const size_t strip = ((size_t)d->rays_per_chunk * S * (6 + f.sem_dim) + 3) / 4 * 4;
  return (int)(128 + ((size_t)rd->stages * rd->stage_floats + 2 * rows * kWgPts + strip) *
                         sizeof(float));
}

// shared memory of K5 (frozen_sem_kernel); ops/fused_render.py _frozen_smem
// computes the same (bf16: half-size sem_in tiles and W0 stages)
int frozen_smem(const FrozenDesc* d) {
  const size_t xb = d->bf16 ? 2 : 4, stage = d->bf16 ? kSemStage16 : kSemStage;
  return (int)(kSemBars + (size_t)d->xstages * kSemPts * d->C * xb +
               (kSemDs + (size_t)d->wstages * stage) * sizeof(float));
}

// One launch of train_render_wg_kernel<kIn, kBf16>, a CTA a chunk of
// d->rays_per_chunk rays, the ring's layers from ring as rd describes.
template <int kIn, bool kBf16 = false>
int render_wg(const float* rays, const float* z, const float* params, const float* ring,
              const TrainDesc* d, const RingDesc* rd, float* maps, float* weights, void* semin,
              int R, int S, unsigned seed, float noise_std, void* stream) {
  using SemT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  const int smem = wg_smem(d, rd, S);
  cudaError_t err = cudaFuncSetAttribute(train_render_wg_kernel<kIn, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  train_render_wg_kernel<kIn, kBf16><<<nchunks, kWgThreads, smem, (cudaStream_t)stream>>>(
      rays, z, params, ring, *d, *rd, maps, weights, static_cast<SemT*>(semin), R, S, seed,
      noise_std);
  return (int)cudaGetLastError();
}

// Wave `wave` of train_grads's storing forward: the forward kernel
// (train_forward_wg_kernel<kMode, kIn, kBf16>) of each of the group's
// chunks j (chunk (wave * group + j) grid .. of the rays), into sub j nsf ..
// of the workspace slices' planes (group_desc).
template <int kMode, int kIn, bool kBf16>
int forward_wave(const float* odv, const float* z, const float* aux, const float* dweights,
                 const float* params, const float* ring, const TrainDesc* d, const RingDesc* rd,
                 float* maps, float* weights, float* workspace, int R, int S, int grid, int wave,
                 int group, unsigned seed, float noise_std, int white_bkgd, cudaStream_t st) {
  const int smem = wg_smem(d, rd, S);
  cudaError_t err = cudaFuncSetAttribute(train_forward_wg_kernel<kMode, kIn, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  for (int j = 0; j < group && (long long)(wave * group + j) * grid < nchunks; ++j) {
    train_forward_wg_kernel<kMode, kIn, kBf16><<<grid, kWgThreads, smem, st>>>(
        odv, z, aux, dweights, params, ring, group_desc(*d, j, S), *rd, maps, weights,
        workspace, R, S, wave * group + j, group, seed, noise_std, white_bkgd);
  }
  return (int)cudaGetLastError();
}

// Wave `wave`'s reverse sweep (train_reverse_kernel<kSem, false, kBf16>)
// over the group's chunks, its input-gradient products' matrices from the
// backward ring bring as brd describes.
template <bool kSem, bool kBf16>
int reverse_wave(const float* bring, const TrainDesc* d, const RingDesc* brd, float* partial,
                 float* workspace, int R, int S, int grid, int wave, int group, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(train_reverse_kernel<kSem, false, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kReverseSmem);
  if (err != cudaSuccess) return (int)err;
  train_reverse_kernel<kSem, false, kBf16><<<grid, kThreads, kReverseSmem, st>>>(
      bring, nullptr, *d, *brd, RingDesc{}, partial, workspace, R, S, wave, group, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// The parts' launches (see NERF_PART): train_render_wg_kernel's in input
// mode kin (kInPoint, kInSigma, kInMip), a storing forward's wave in mode
// `mode` (kLoss: kInPoint alone; kCotangent: kInPoint or kInMip), a reverse
// sweep's wave with or without the semantic head's planes; _f32 and _bf16
// the two dtypes' kernels.
#define NERF_RENDER_ARGS                                                                    \
  int kin, const float *rays, const float *z, const float *params, const float *ring,      \
      const TrainDesc *d, const RingDesc *rd, float *maps, float *weights, void *semin, int R, \
      int S, unsigned seed, float noise_std, void *stream
#define NERF_FORWARD_ARGS                                                                    \
  int mode, int kin, const float *odv, const float *z, const float *aux,                     \
      const float *dweights, const float *params, const float *ring, const TrainDesc *d,     \
      const RingDesc *rd, float *maps, float *weights, float *workspace, int R, int S,        \
      int grid, int wave, int group, unsigned seed, float noise_std, int white_bkgd,          \
      cudaStream_t st
#define NERF_REVERSE_ARGS                                                                    \
  bool sem, const float *bring, const TrainDesc *d, const RingDesc *brd, float *partial,     \
      float *workspace, int R, int S, int grid, int wave, int group, cudaStream_t st

int render_f32(NERF_RENDER_ARGS);
int render_bf16(NERF_RENDER_ARGS);
int forward_wave_f32(NERF_FORWARD_ARGS);
int forward_wave_bf16(NERF_FORWARD_ARGS);
int reverse_wave_f32(NERF_REVERSE_ARGS);
int reverse_wave_bf16(NERF_REVERSE_ARGS);

#define NERF_RENDER_PASS rays, z, params, ring, d, rd, maps, weights, semin, R, S, seed, \
    noise_std, stream
#define NERF_FORWARD_PASS odv, z, aux, dweights, params, ring, d, rd, maps, weights, \
    workspace, R, S, grid, wave, group, seed, noise_std, white_bkgd, st
#define NERF_REVERSE_PASS bring, d, brd, partial, workspace, R, S, grid, wave, group, st

#if NERF_IN_PART(0)
int render_f32(NERF_RENDER_ARGS) {
  if (kin == kInSigma) return render_wg<kInSigma>(NERF_RENDER_PASS);
  if (kin == kInMip) return render_wg<kInMip>(NERF_RENDER_PASS);
  return render_wg<kInPoint>(NERF_RENDER_PASS);
}
#endif

#if NERF_IN_PART(1)
int render_bf16(NERF_RENDER_ARGS) {
  if (kin == kInSigma) return render_wg<kInSigma, true>(NERF_RENDER_PASS);
  if (kin == kInMip) return render_wg<kInMip, true>(NERF_RENDER_PASS);
  return render_wg<kInPoint, true>(NERF_RENDER_PASS);
}
#endif

#if NERF_IN_PART(3)
int forward_wave_f32(NERF_FORWARD_ARGS) {
  if (mode == kLoss) return forward_wave<kLoss, kInPoint, false>(NERF_FORWARD_PASS);
  if (kin == kInMip) return forward_wave<kCotangent, kInMip, false>(NERF_FORWARD_PASS);
  return forward_wave<kCotangent, kInPoint, false>(NERF_FORWARD_PASS);
}
#endif

#if NERF_IN_PART(4)
int forward_wave_bf16(NERF_FORWARD_ARGS) {
  if (mode == kLoss) return forward_wave<kLoss, kInPoint, true>(NERF_FORWARD_PASS);
  if (kin == kInMip) return forward_wave<kCotangent, kInMip, true>(NERF_FORWARD_PASS);
  return forward_wave<kCotangent, kInPoint, true>(NERF_FORWARD_PASS);
}
#endif

#if NERF_IN_PART(5)
int reverse_wave_f32(NERF_REVERSE_ARGS) {
  return sem ? reverse_wave<true, false>(NERF_REVERSE_PASS)
             : reverse_wave<false, false>(NERF_REVERSE_PASS);
}
#endif

#if NERF_IN_PART(6)
int reverse_wave_bf16(NERF_REVERSE_ARGS) {
  return sem ? reverse_wave<true, true>(NERF_REVERSE_PASS)
             : reverse_wave<false, true>(NERF_REVERSE_PASS);
}
#endif

#if NERF_IN_PART(0)
// K4 (and K2, noise 0 and semin null): odv [R, 9] and z [R, S] -> maps
// [R, 5 + sem], weights [R, S] and, where semin is not null, sem_in (fp32,
// or bf16 when d->f.bf16: the bf16 mode, the ring in pack_ring's bf16
// layout).
extern "C" int nerf_train_render(const float* odv, const float* z, const float* params,
                                 const float* ring, const TrainDesc* d, const RingDesc* rd,
                                 float* maps, float* weights, void* semin, int R, int S,
                                 unsigned seed, float noise_std, void* stream) {
  return (d->f.bf16 ? render_bf16 : render_f32)(kInPoint, odv, z, params, ring, d, rd, maps,
                                                weights, semin, R, S, seed, noise_std, stream);
}

// K1: the eval's coarse pass, od [R, 6] and z [R, S] -> weights [R, S]:
// K4's kernel in its sigma-only mode (the ring holds the trunk alone), no
// noise; the bf16 mode when d->f.bf16.
extern "C" int nerf_coarse_weights(const float* od, const float* z, const float* params,
                                   const float* ring, const TrainDesc* d, const RingDesc* rd,
                                   float* weights, int R, int S, void* stream) {
  return (d->f.bf16 ? render_bf16 : render_f32)(kInSigma, od, z, params, ring, d, rd, nullptr,
                                                weights, nullptr, R, S, 0u, 0.f, stream);
}

extern "C" const char* nerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K9 (noise_std 0) and K10a: the mip render pass, odvr [R, 10] and
// fenceposts z [R, S + 1] -> maps [R, 5] and weights [R, S], with the sigma
// noise of seed: K4's kernel in its mip mode (the ring holds the trunk,
// feature and views). The two TPU kernels differ by the noise alone, so
// they are one kernel here. The bf16 mode when d->f.bf16 (the ring in
// pack_ring's bf16 layout).
extern "C" int nerf_mip_render(const float* odvr, const float* z, const float* params,
                               const float* ring, const TrainDesc* d, const RingDesc* rd,
                               float* maps, float* weights, int R, int S, unsigned seed,
                               float noise_std, void* stream) {
  return (d->f.bf16 ? render_bf16 : render_f32)(kInMip, odvr, z, params, ring, d, rd, maps,
                                                weights, nullptr, R, S, seed, noise_std, stream);
}
#endif

#if NERF_IN_PART(2)
namespace {

// K5's clusters that fit on the card at once with d's shared memory
// (cudaOccupancyMaxActiveClusters: four SMs of one GPC each), into *out.
template <bool kBf16>
int frozen_sem_clusters(const FrozenDesc* d, int* out) {
  const int smem = frozen_smem(d);
  cudaError_t err = cudaFuncSetAttribute(frozen_sem_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSemRanks * 256);
  cfg.blockDim = dim3(kSemThreads);
  cfg.dynamicSmemBytes = smem;
  return (int)cudaOccupancyMaxActiveClusters(out, frozen_sem_kernel<kBf16>, &cfg);
}

template <bool kBf16>
int frozen_sem_grads(const void* semin, const float* weights, const float* dmaps,
                     const float* params, const FrozenDesc* d, float* partial, float* grads,
                     long long P, int S, int clusters, long long per, cudaStream_t st) {
  const int smem = frozen_smem(d);
  cudaError_t err = cudaFuncSetAttribute(frozen_sem_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  frozen_sem_kernel<kBf16><<<kSemRanks * clusters, kSemThreads, smem, st>>>(
      semin, weights, dmaps, params, *d, partial, P, S, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<reduce_blocks(d->grad_size), 256, 0, st>>>(partial, grads, d->grad_size,
                                                               clusters);
  return (int)cudaGetLastError();
}

}  // namespace

// K5's clusters that fit on the card at once with d's shared memory, in
// d->bf16's mode, into *out.
extern "C" int nerf_frozen_sem_clusters(const FrozenDesc* d, int* out) {
  return d->bf16 ? frozen_sem_clusters<true>(d, out) : frozen_sem_clusters<false>(d, out);
}

// K5: `clusters` clusters of four CTAs over P = R * S points, cluster k on
// 64-point tiles [k per, (k + 1) per) with partial buffer k (d->grad_size
// floats), then the partials summed in cluster order into grads. sem_in is
// fp32, or bf16 when d->bf16 (the bf16 mode, pack_frozen's bf16 ring).
extern "C" int nerf_frozen_sem_grads(const void* semin, const float* weights,
                                     const float* dmaps, const float* params,
                                     const FrozenDesc* d, float* partial, float* grads,
                                     long long P, int S, int clusters, long long per,
                                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (d->bf16)
    return frozen_sem_grads<true>(semin, weights, dmaps, params, d, partial, grads, P, S,
                                  clusters, per, st);
  return frozen_sem_grads<false>(semin, weights, dmaps, params, d, partial, grads, P, S,
                                 clusters, per, st);
}
#endif

#if NERF_IN_PART(0)
namespace {

// grid CTAs (each with a d->ws_size workspace slice and a d->grad_size partial
// gradient buffer) take the chunks of rays in waves of `group` forward
// waves of grid chunks: per wave the forward kernel of each
// (train_forward_wg_kernel<kMode, kIn> on K4's tile, with the ring of ring
// and rd; kIn kInMip for K10b), chunk j of the group into sub j nsf .. of
// the slice's planes (group_desc), then one reverse-sweep kernel over the
// group's chunks (its input-gradient products' matrices from the backward
// ring bring as brd describes); then the partials are summed into grads
// [d->grad_size]. bf16: both kernels' bf16 modes (K3, K6, K10b at
// --compute_dtype bfloat16; the rings in their bf16 layouts). Returns the
// first CUDA error of the launches.
int train_grads(int mode, bool sem, int kin, bool bf16, const float* odv, const float* z,
                const float* aux, const float* dweights, const float* params,
                const float* ring, const float* bring, const TrainDesc* d, const RingDesc* rd,
                const RingDesc* brd, float* maps, float* weights, float* partial,
                float* workspace, float* grads, int R, int S, int grid, int group,
                unsigned seed, float noise_std, int white_bkgd, cudaStream_t st) {
  const long long nchunks = (R + d->rays_per_chunk - 1) / d->rays_per_chunk;
  for (int wave = 0; (long long)wave * group * grid < nchunks; ++wave) {
    int err = (bf16 ? forward_wave_bf16 : forward_wave_f32)(
        mode, kin, odv, z, aux, dweights, params, ring, d, rd, maps, weights, workspace, R, S,
        grid, wave, group, seed, noise_std, white_bkgd, st);
    if (err == 0)
      err = (bf16 ? reverse_wave_bf16 : reverse_wave_f32)(sem, bring, d, brd, partial, workspace,
                                                          R, S, grid, wave, group, st);
    if (err != 0) return err;
  }
  reduce_partials<<<reduce_blocks(d->grad_size), 256, 0, st>>>(partial, grads, d->grad_size, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: the RGB train pass, the forward's weights from ring (ops/fused_render
// pack_ring) as rd describes, the reverse sweep's from bring (pack_bwd_ring)
// as brd describes; see train_grads. The bf16 mode when d->f.bf16 (both
// rings in their bf16 layouts).
extern "C" int nerf_rgb_train_grads(const float* odv, const float* z, const float* gt,
                                    const float* params, const float* ring, const float* bring,
                                    const TrainDesc* d, const RingDesc* rd, const RingDesc* brd,
                                    float* maps, float* weights, float* partial, float* workspace,
                                    float* grads, int R, int S, int grid, int group,
                                    unsigned seed, float noise_std, int white_bkgd,
                                    void* stream) {
  return train_grads(kLoss, false, kInPoint, d->f.bf16, odv, z, gt, nullptr, params, ring,
                     bring, d, rd, brd, maps, weights, partial, workspace, grads, R, S, grid,
                     group, seed, noise_std, white_bkgd, (cudaStream_t)stream);
}

// K6: the train render's backward from the maps' cotangent dmaps [R, 5 + sem]
// and the weights' dweights [R, S] (null: zero); d describes the semantic
// head's planes and gradients when d->f.sem_dim > 0; the forward's weights
// from ring as rd describes, the reverse sweep's from bring as brd
// describes; see train_grads. The bf16 mode when d->f.bf16.
extern "C" int nerf_train_render_grads(const float* odv, const float* z, const float* dmaps,
                                       const float* dweights, const float* params,
                                       const float* ring, const float* bring,
                                       const TrainDesc* d, const RingDesc* rd,
                                       const RingDesc* brd, float* partial, float* workspace,
                                       float* grads, int R, int S, int grid, int group,
                                       unsigned seed, float noise_std, void* stream) {
  return train_grads(kCotangent, d->f.sem_dim > 0, kInPoint, d->f.bf16, odv, z, dmaps,
                     dweights, params, ring, bring, d, rd, brd, nullptr, nullptr, partial,
                     workspace, grads, R, S, grid, group, seed, noise_std, 0,
                     (cudaStream_t)stream);
}

// K10b: the mip train render's backward from the maps' cotangent dmaps
// [R, 5] and the weights' dweights [R, S] (null: zero), on odvr [R, 10] and
// fenceposts z [R, S + 1]: K6's kernels without the semantic head in their
// mip mode (the forward on K4's tile with the Gaussian and integrated-PE
// prologue, its weights from ring as rd describes, the mip composite), the
// reverse sweep's matrices from bring as brd describes; see train_grads.
// The bf16 mode when d->f.bf16 (both rings in their bf16 layouts: K6's
// bf16 kernels without the semantic head, in the mip mode).
extern "C" int nerf_mip_train_render_grads(const float* odvr, const float* z, const float* dmaps,
                                           const float* dweights, const float* params,
                                           const float* ring, const float* bring,
                                           const TrainDesc* d, const RingDesc* rd,
                                           const RingDesc* brd, float* partial, float* workspace,
                                           float* grads, int R, int S, int grid, int group,
                                           unsigned seed, float noise_std, void* stream) {
  return train_grads(kCotangent, false, kInMip, d->f.bf16, odvr, z, dmaps, dweights, params,
                     ring, bring, d, rd, brd, nullptr, nullptr, partial, workspace, grads, R, S,
                     grid, group, seed, noise_std, 0, (cudaStream_t)stream);
}
#endif
