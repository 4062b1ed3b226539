// Device building blocks of the train kernels' reverse sweep, shared by the
// fused train kernels (train_render.cu: the reverse sweep of K3, K6 and
// K10b) and the field backward (fused_field.cu: K8c/K8f); every forward,
// the storing ones that fill the workspace included, is the 128-point tile
// of wg_tile.cuh: the train descriptor and its workspace planes, the
// input-gradient product of a layer (bwd_layer:
// wgmma 3xTF32, its matrix and dY through a ring of shared-memory stages
// filled by bulk copies), the weight-gradient product (wgrad: wgmma 3xTF32,
// the X and dY rows of each sub through a second ring of bulk copies), the
// reverse sweep of the field MLP from the per-point cotangents of its
// outputs, and the CTA-ordered reduction of the partial gradients.
// K3, K6, K10b and K8c/K8f at --compute_dtype bfloat16 run a bf16 mode of
// both products (wgmma m64nNk16 bf16, the operands rounded to bf16 as they
// are loaded, the cotangents JAX rounds rounded in bwd_layer's epilogue);
// the workspace planes stay fp32 and hold the bf16 values the storing
// forward rounded.
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

// One input of a weight-gradient product: up to three planes, in row order.
struct XSegs {
  int p[3];
  int n;
};

// The backward ring of bwd_layer: kBwdStages stages, each one k step s of a
// product: the k-slice of its matrix (16 N floats: the TF32 high parts, then
// the low parts, N <= kBwdMaxN), in slot j the 8 dY rows of that k step of
// the round's j-th 64-point sub ([8][kLd], as the plane holds them), and in
// gate slot j that sub's rows 8 s .. 8 s + 7 of the gate plane (when the
// product has a k-slice for every 8 outputs: the trunk, alpha's slot).
// The bf16 mode's k step is 16 dY rows: the matrix's k16 slice in bf16 (8 N
// floats' room), the two 8-row blocks of dY (and of the gate, for output
// groups 2 s and 2 s + 1) in slots 2 j and 2 j + 1.
constexpr int kBwdMaxN = 256;
constexpr int kBwdSlot = 8 * kLd;
constexpr int kBwdStages = 4;

template <bool kBf16>
struct BwdStage {
  static constexpr int kRows = kBf16 ? 2 : 1;                  // 8-row blocks a k step
  static constexpr int kMat = (kBf16 ? 8 : 16) * kBwdMaxN;      // the matrix slice's room
  static constexpr int kGate = kMat + 4 * kRows * kBwdSlot;    // the gate slots' offset
  static constexpr int kFloats = kGate + 4 * kRows * kBwdSlot;
};
// wgrad's ring: kWgrStages stages, each a block of up to 64 rows of one
// 64-point sub of a plane ([row][kLd], as the plane holds them, one bulk
// copy a plane it spans); B: a sub's dY rows of a round as the wgmma B
// operand (per k-slice of 8 points the TF32 high then low parts, at most
// kWgrMaxN outputs); db: a sub's sums of dY over each k-slice's points
// ([8][kWgrMaxN]).
constexpr int kWgrStageFloats = 64 * kLd;
constexpr int kWgrStages = 8;
constexpr int kWgrMaxN = 128;
constexpr int kWgrB = 8 * 16 * kWgrMaxN;
constexpr int kWgrDb = 8 * kWgrMaxN;
constexpr int kWgrFloats = kWgrB + kWgrDb + kWgrStages * kWgrStageFloats;

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
template <int NP, bool kBf16>
__device__ __forceinline__ int bwd_pieces(const float* __restrict__ src, int N, int nk8,
                                          int ldn, float* ws, const TrainDesc& d, int p0,
                                          int p1, int out, int gate, int nsub,
                                          const BwdRing& br, int pos, bool add, bool rnd) {
  using St = BwdStage<kBf16>;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * w + g;  // the thread's accumulator rows: points m0 and m0 + 8
  const int np = N / NP, per = 4 / np;  // pieces of N; subs a round
  const int nk = (nk8 + St::kRows - 1) / St::kRows;  // k steps
  const int rounds = (nsub + per - 1) / per, total = rounds * nk, k0 = d.rows[p0];
  const bool ring_gate = gate >= 0 && nk8 * 8 >= ldn;
  auto fill = [&](int f) {  // step f of the call
    const int r = f / nk, s = f - r * nk, at = pos + f, slot = at % kBwdStages;
    while (!mbar_try_wait(br.empty + slot, ((at / kBwdStages) & 1) ^ 1)) {
    }
    const int nlive = min(per, nsub - r * per);
    float* st = br.stages + (size_t)slot * St::kFloats;
    const uint32_t mat = N * (kBf16 ? 32 : 64);  // bytes of the matrix's k-slice
    uint32_t bytes = mat;
    for (int e = 0; e < St::kRows; ++e) {
      const int row = 8 * (St::kRows * s + e);
      if (row < 8 * nk8) bytes += nlive * kBwdSlot * ((ring_gate && row < ldn) ? 8 : 4);
    }
    mbar_expect_tx(br.full + slot, bytes);
    bulk_g2s(st, src + (size_t)s * (mat / 4), mat, br.full + slot);
    for (int e = 0; e < St::kRows; ++e) {
      const int row = 8 * (St::kRows * s + e);  // the block's first dY row
      if (row >= 8 * nk8) break;                // the last bf16 step's absent block
      const int p = row < k0 ? p0 : p1, rr = row < k0 ? row : row - k0;
      const bool gr = ring_gate && row < ldn;
      for (int u = 0; u < nlive; ++u) {
        const int sub = r * per + u, at_u = (St::kRows * u + e) * kBwdSlot;
        bulk_g2s(st + St::kMat + at_u, plane(ws, d, p, sub) + rr * kLd, kBwdSlot * 4,
                 br.full + slot);
        if (gr)
          bulk_g2s(st + St::kGate + at_u, plane(ws, d, gate, sub) + row * kLd, kBwdSlot * 4,
                   br.full + slot);
      }
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
        // split as split() does (bf16: the k16 step's rows t, t + 4 of each
        // 8-row block as bf16x2 pairs, pack_bwd_ring's k order; a block past
        // the matrix's rows reads 0); its registers are rewritten only after
        // the last step's products are done (wait_group 0)
        const float* st = br.stages + (size_t)slot * St::kFloats;
        const float* a = st + St::kMat + St::kRows * j * kBwdSlot + t * kLd + m0;
        if constexpr (kBf16) {
          const bool two = 2 * s + 1 < nk8;
          const float* a2 = a + kBwdSlot;
          const uint32_t ab[4] = {bf16x2(a[0], a[4 * kLd]), bf16x2(a[8], a[4 * kLd + 8]),
                                  two ? bf16x2(a2[0], a2[4 * kLd]) : 0u,
                                  two ? bf16x2(a2[8], a2[4 * kLd + 8]) : 0u};
          const uint64_t bd = b_desc(st + n0 * 8);
          wgmma_fence();
          WgmmaBf16<NP>::mma(acc, ab, bd);
          wgmma_commit();
        } else {
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
        }
#pragma unroll
        for (int e = 0; e < St::kRows; ++e) {
          // the output group whose gate rows block e of this step holds
          const int q = St::kRows * s + e - n0 / 8;
          if (ring_gate && q >= 0 && q < NP / 8 && 8 * (St::kRows * s + e) < ldn) {
            const float* gt = st + St::kGate + (St::kRows * j + e) * kBwdSlot + 2 * t * kLd + m0;
            const uint32_t bits = (gt[0] > 0.f) | (gt[kLd] > 0.f) << 1 | (gt[8] > 0.f) << 2 |
                                  (gt[kLd + 8] > 0.f) << 3;
            if (q < 8) {
              mlo |= bits << (4 * q);
            } else {
              mhi |= bits << (4 * (q - 8));
            }
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
    // the epilogue: add adds out's value, then the gate (the ring's
    // bits, or loaded), then (bf16 with rnd) the rounding to bf16 of the
    // cotangent JAX rounds, then the store of the plane's rows n < ldn
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
      if (add) {
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
      if (kBf16 && rnd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = bf16r(v[e]);
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
// (64 accumulators a thread under the kernel's 128 registers). add: the
// product is added to what out holds (before the gate). kBf16 (the sweeps at
// --compute_dtype bfloat16): the matrix in pack_bwd_ring's bf16 layout, a
// k step of 16 dY rows rounded to bf16 at the A load (cvt.rn.bf16x2) on
// one wgmma m64nNPk16 bf16, and with rnd the stored cotangent rounded to
// bf16 after its gate (JAX's .astype(bf16) of dhv, d_feat, ds and each
// trunk dpre). Returns the ring position after the layer's stages.
// Inlined into the reverse kernel's one call site, so no call splits a
// wgmma pipeline (ptxas serialises every wgmma of a function whose
// pipeline crosses a call, C7510).
template <bool kBf16>
__device__ __forceinline__ int bwd_layer(const float* __restrict__ src, int N, const LayerDesc L,
                                         float* ws, const TrainDesc& d, int p0, int p1, int out,
                                         int gate, int nsub, const BwdRing br, int pos,
                                         bool add, bool rnd) {
  // the planes' stores and wgrad's use of the stages before the bulk copies
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  const int nk = L.k / 8, ldn = pad8(L.n);
  switch (N) {
    case 256:
    case 128:
      pos = bwd_pieces<128, kBf16>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos,
                                   add, rnd);
      break;
    case 64:
      pos = bwd_pieces<64, kBf16>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos,
                                  add, rnd);
      break;
    case 32:
      pos = bwd_pieces<32, kBf16>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos,
                                  add, rnd);
      break;
    case 16:
      pos = bwd_pieces<16, kBf16>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos,
                                  add, rnd);
      break;
    default:
      pos = bwd_pieces<8, kBf16>(src, N, nk, ldn, ws, d, p0, p1, out, gate, nsub, br, pos,
                                 add, rnd);
  }
  __syncthreads();  // out is whole before wgrad or the next product reads it
  return pos;
}

// The reverse kernel's view of wgrad's ring: stage pos (counted over the
// kernel's run) in slot pos % kWgrStages, its fill completing phase
// (pos / kWgrStages) & 1 of the slot's full barrier; its consumers free it
// with 16 arrivals on the slot's empty barrier (a dY stage: each of the
// CTA's 16 warps once; an X stage: each warp of its warpgroup 4 times).
struct WgrRing {
  uint64_t* full;
  uint64_t* empty;
  float* b;
  float* db;
  float* stages;
};

// Round r of a layer's dW: the dY rows [pc NP, pc NP + nrow) (nd stages of
// up to 64 rows a sub) against the X row blocks mb0 .. mb0 + cnt - 1 of 64
// rows (warpgroup w takes block mb0 + w); rounds go m-group by m-group of
// four blocks (ngr of them), then piece by piece.
struct WgrRound {
  int pc, mb0, cnt, nrow, nd;
};

__device__ __forceinline__ WgrRound wgr_round(int r, int ngr, int nm, int NP, int ldn) {
  WgrRound o;
  o.pc = r / ngr;
  o.mb0 = 4 * (r - o.pc * ngr);
  o.cnt = min(4, nm - o.mb0);
  o.nrow = min(NP, ldn - o.pc * NP);
  o.nd = (o.nrow + 63) / 64;
  return o;
}

// Rows [r0, r1) of the concatenation of X's planes, sub `sub`, to dst: one
// bulk copy a plane they span, completing on bar (issue false: none).
// Returns their bytes.
__device__ __forceinline__ uint32_t copy_rows(float* dst, float* ws, const TrainDesc& d,
                                              const XSegs& X, int sub, int r0, int r1,
                                              uint64_t* bar, bool issue) {
  uint32_t bytes = 0;
  int off = 0;
  for (int s = 0; s < X.n; ++s) {
    const int rows = d.rows[X.p[s]], lo = max(r0, off), hi = min(r1, off + rows);
    if (lo < hi) {
      const uint32_t nb = (uint32_t)(hi - lo) * kLd * 4;
      if (issue)
        bulk_g2s(dst + (lo - r0) * kLd, plane(ws, d, X.p[s], sub) + (size_t)(lo - off) * kLd,
                 nb, bar);
      bytes += nb;
    }
    off += rows;
  }
  return bytes;
}

// x as TF32 high and low parts, four consecutive floats each at hi and lo
__device__ __forceinline__ void split4(float* hi, float* lo, float a, float b, float c, float e) {
  uint32_t h[4], l[4];
  split(a, h[0], l[0]);
  split(b, h[1], l[1]);
  split(c, h[2], l[2]);
  split(e, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// wgrad at a piece width NP (see wgrad). Sub by sub of a round: the CTA
// converts the sub's dY rows from their stages into B (and, in a piece's
// first round, db's sums), then warpgroup w multiplies its X block's stage
// into its accumulators, 8 k steps of three wgmma (kBf16: 4 k16 steps of
// one bf16 wgmma); after the round's last sub each warpgroup adds its
// 64 x NP block into dW. Thread 0 fills the ring: at the call's start,
// whenever it waits for a stage, once a k step, and after the conversion
// (then waiting for a free slot) every X stage of the sub; a slot is never
// waited for before its last use is done.
template <int NP, bool kBf16>
__device__ __forceinline__ int wgrad_rounds(float* ws, const TrainDesc& d, const XSegs X,
                                            int kpad, int dy, int ldn, float* __restrict__ dW,
                                            float* __restrict__ db, int nsub, const WgrRing& wr,
                                            int wpos) {
  constexpr int K = kWgrStages;
  const int tid = threadIdx.x, lane = tid & 31, w = (tid >> 5) & 3;
  // the warpgroup, warp-uniform as ptxas sees it (C7520 otherwise)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int g = lane >> 2, t = lane & 3, m0 = 16 * w + g;
  const int nm = (kpad + 63) / 64, ngr = (nm + 3) / 4;
  const int nrounds = ((ldn + NP - 1) / NP) * ngr;
  const XSegs Y{{dy, 0, 0}, 1};
  // thread 0's next fill: round fr (its plan frd), sub fs, item fi (items
  // 0 .. nd - 1 the dY blocks, then the X blocks), ring position fpos
  int fr = 0, fs = 0, fi = 0, fpos = wpos;
  WgrRound frd = wgr_round(0, ngr, nm, NP, ldn);
  auto pump = [&](int until) {  // fill every stage before `until`, then those with a free slot
    while (fr < nrounds) {
      uint64_t* e = wr.empty + fpos % K;
      const uint32_t par = ((fpos / K) & 1) ^ 1;
      if (fpos < until) {
        while (!mbar_try_wait(e, par)) {
        }
      } else if (!mbar_test_wait(e, par)) {
        break;
      }
      float* st = wr.stages + (size_t)(fpos % K) * kWgrStageFloats;
      uint64_t* bar = wr.full + fpos % K;
      const bool isd = fi < frd.nd;
      const int r0 = isd ? frd.pc * NP + 64 * fi : 64 * (frd.mb0 + fi - frd.nd);
      const int r1 = min(r0 + 64, isd ? frd.pc * NP + frd.nrow : kpad);
      const XSegs src = isd ? Y : X;
      mbar_expect_tx(bar, copy_rows(st, ws, d, src, fs, r0, r1, bar, false));
      copy_rows(st, ws, d, src, fs, r0, r1, bar, true);
      ++fpos;
      if (++fi == frd.nd + frd.cnt) {
        fi = 0;
        if (++fs == nsub) {
          fs = 0;
          if (++fr < nrounds) frd = wgr_round(fr, ngr, nm, NP, ldn);
        }
      }
    }
  };
  auto wait_full = [&](int q) {
    if (tid == 0) {
      while (!mbar_test_wait(wr.full + q % K, (q / K) & 1)) pump(0);
    } else {
      while (!mbar_try_wait(wr.full + q % K, (q / K) & 1)) {
      }
    }
  };
  if (tid == 0) pump(0);
  int pos = wpos;
  for (int r = 0; r < nrounds; ++r) {
    const WgrRound rd = wgr_round(r, ngr, nm, NP, ldn);
    const bool live = wg < rd.cnt, sums = rd.mb0 == 0;
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
    float dbacc = 0.f;
    for (int s = 0; s < nsub; ++s) {
      __syncthreads();  // the last sub's products and sums are done: B and db are free
      for (int b = 0; b < rd.nd; ++b) wait_full(pos + b);
      // dY row n, points 8 kk .. 8 kk + 7 into k-slice kk of B: k position
      // j holds point 8 kk + 2 (j & 3) + (j >> 2), so that an A fragment's
      // points t and t + 4 are one float2 (the X loads below hit 32 banks
      // a half-warp); the 4 k positions of a half are 4 consecutive floats
      // of B's K-major core matrix (b_offset). A warp's 8 lanes of a
      // quarter take 8 consecutive rows, so their B stores hit 32 banks.
      // kBf16: points 16 kk .. 16 kk + 15 are the k16 slice kk's k positions
      // in order, rounded to bf16 as they are stored (store_b8_bf16)
      for (int i = tid; i < rd.nrow * 8; i += kThreads) {
        const int n = (i & 7) + 8 * (i >> 6), kk = (i >> 3) & 7;
        const float* y = wr.stages + (size_t)((pos + (n >> 6)) % K) * kWgrStageFloats +
                         (n & 63) * kLd + 8 * kk;
        const float4 v0 = *reinterpret_cast<const float4*>(y);
        const float4 v1 = *reinterpret_cast<const float4*>(y + 4);
        if constexpr (kBf16) {
          store_b8_bf16(reinterpret_cast<__nv_bfloat16*>(wr.b + (kk >> 1) * 8 * NP),
                        8 * (kk & 1), n, v0, v1);
        } else {
          float* bs = wr.b + kk * 16 * NP + (n >> 3) * 64 + (n & 7) * 4;
          split4(bs, bs + 8 * NP, v0.x, v0.z, v1.x, v1.z);
          split4(bs + 32, bs + 32 + 8 * NP, v0.y, v0.w, v1.y, v1.w);
        }
        if (sums)
          wr.db[kk * kWgrMaxN + n] = ((((((v0.x + v0.y) + v0.z) + v0.w) + v1.x) + v1.y) + v1.z) +
                                     v1.w;
      }
      fence_proxy_async_smem();  // B is read by wgmma, the dY stages refilled by bulk copies
      __syncwarp();
      if (lane == 0)
        for (int b = 0; b < rd.nd; ++b) mbar_arrive(wr.empty + (pos + b) % K);
      __syncthreads();  // B is whole
      if (tid == 0) pump(pos + rd.nd + rd.cnt);  // the sub's X blocks
      if (sums && tid < rd.nrow) {
        float v = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) v += wr.db[kk * kWgrMaxN + tid];
        dbacc += v;
      }
      if (live) {
        const int q = pos + rd.nd + wg;
        wait_full(q);
        // A fragment of k-slice kk: a0 (row m0, k t) and a2 (m0, t + 4) are
        // points 8 kk + 2 t and + 1, a1 and a3 the same of row m0 + 8; rows
        // past kpad hold stale values, which reach only accumulator rows
        // that are never stored
        // (kBf16: k positions 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 of k16 slice
        // kk are points 16 kk + 2 t, + 1 and 16 kk + 8 + 2 t, + 1: two float2
        // a row, rounded to bf16 pairs, 32 banks a half-warp)
        const float* xa = wr.stages + (size_t)(q % K) * kWgrStageFloats + m0 * kLd + 2 * t;
        for (int kk = 0; kk < (kBf16 ? 4 : 8); ++kk) {
          if constexpr (kBf16) {
            const float* x0 = xa + 16 * kk;
            const uint32_t ab[4] = {
                a_pair_bf16(*reinterpret_cast<const float2*>(x0)),
                a_pair_bf16(*reinterpret_cast<const float2*>(x0 + 8 * kLd)),
                a_pair_bf16(*reinterpret_cast<const float2*>(x0 + 8)),
                a_pair_bf16(*reinterpret_cast<const float2*>(x0 + 8 * kLd + 8))};
            const uint64_t bk = b_desc(wr.b + kk * 8 * NP);
            wgmma_fence();
            WgmmaBf16<NP>::mma(acc, ab, bk);
            wgmma_commit();
          } else {
            const float2 u = *reinterpret_cast<const float2*>(xa + 8 * kk);
            const float2 v = *reinterpret_cast<const float2*>(xa + 8 * kLd + 8 * kk);
            uint32_t ahi[4], alo[4];
            split(u.x, ahi[0], alo[0]);
            split(v.x, ahi[1], alo[1]);
            split(u.y, ahi[2], alo[2]);
            split(v.y, ahi[3], alo[3]);
            const float* bk = wr.b + kk * 16 * NP;
            const uint64_t bhi = b_desc(bk), blo = b_desc(bk + 8 * NP);
            wgmma_fence();
            Wgmma<NP>::mma(acc, alo, bhi);
            Wgmma<NP>::mma(acc, ahi, blo);
            Wgmma<NP>::mma(acc, ahi, bhi);
            wgmma_commit();
          }
          wgmma_wait<0>();
          if (tid == 0) pump(0);
        }
        fence_proxy_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive_n(wr.empty + q % K, 4);  // the X stage is free
      }
      pos += rd.nd + rd.cnt;
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      // accumulator i: row 64 mb + m0 + 8 ((i >> 1) & 1), output pc NP +
      // 8 (i >> 2) + 2 t + (i & 1); added into the partial dW four output
      // groups at a time, every load of a group before its stores
      const int ma = 64 * (rd.mb0 + wg) + m0;
      float* ra = ma < kpad ? dW + (size_t)ma * ldn : nullptr;
      float* rb = ma + 8 < kpad ? dW + (size_t)(ma + 8) * ldn : nullptr;
#pragma unroll
      for (int q0 = 0; q0 < NP / 8; q0 += 4) {
        float2 old[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = rd.pc * NP + 8 * (q0 + q) + 2 * t;
          const bool ok = q0 + q < NP / 8 && n < ldn;
          old[q][0] = ok && ra ? *reinterpret_cast<const float2*>(ra + n) : make_float2(0.f, 0.f);
          old[q][1] = ok && rb ? *reinterpret_cast<const float2*>(rb + n) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = rd.pc * NP + 8 * (q0 + q) + 2 * t, i = 4 * (q0 + q);
          if (q0 + q >= NP / 8 || n >= ldn) continue;
          if (ra)
            *reinterpret_cast<float2*>(ra + n) =
                make_float2(old[q][0].x + acc[i], old[q][0].y + acc[i + 1]);
          if (rb)
            *reinterpret_cast<float2*>(rb + n) =
                make_float2(old[q][1].x + acc[i + 2], old[q][1].y + acc[i + 3]);
        }
      }
    }
    if (sums && tid < rd.nrow) db[rd.pc * NP + tid] += dbacc;
  }
  return pos;
}

// dW[m][n] += sum over the chunk's points p of X[m][p] dY[n][p] and
// db[n] += sum_p dY[n][p], for m < kpad (the rows of X's planes) and
// n < ldn: the weight-gradient product of one layer, over nsub 64-point
// subs. On wgmma m64nNPk8 in 3xTF32 (lo x hi, hi x lo, hi x hi) with
// M = X rows, N = dY rows and K = points: A = 64 X rows of a sub from a
// ring stage in registers, split with cvt.rna.tf32; B = the sub's dY rows
// of the round, converted once a sub into TF32 parts in the K-major
// layout. NP = min(128, ldn rounded up to 8 .. 256) outputs a warpgroup
// (64 accumulators a thread under the kernel's 128 registers); the four
// warpgroups take four 64-row blocks of X a round, so each sub's dY rows
// are staged once a layer and its X rows once a piece of NP outputs (twice
// for a 256-wide layer). The CTA's partial dW is read and written once a
// round of the call. kBf16 (the sweeps at --compute_dtype bfloat16): X and dY
// rounded to bf16 (X at the A load, dY as B is written; db sums the
// plane's values as they are), wgmma m64nNPk16 bf16 over 16 points a k
// step. Returns the ring position after the call's stages.
template <bool kBf16>
__device__ __forceinline__ int wgrad(float* ws, const TrainDesc& d, const XSegs X, int dy,
                                     int ldn, float* __restrict__ dW, float* __restrict__ db,
                                     int nsub, const WgrRing& wr, int wpos) {
  // bwd_layer's use of the stages before the bulk copies
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  int kpad = 0;
  for (int s = 0; s < X.n; ++s) kpad += d.rows[X.p[s]];
  int n = 8;
  while (n < ldn && n < kWgrMaxN) n *= 2;
  switch (n) {
    case 128:
      return wgrad_rounds<128, kBf16>(ws, d, X, kpad, dy, ldn, dW, db, nsub, wr, wpos);
    case 64:
      return wgrad_rounds<64, kBf16>(ws, d, X, kpad, dy, ldn, dW, db, nsub, wr, wpos);
    case 32:
      return wgrad_rounds<32, kBf16>(ws, d, X, kpad, dy, ldn, dW, db, nsub, wr, wpos);
    case 16:
      return wgrad_rounds<16, kBf16>(ws, d, X, kpad, dy, ldn, dW, db, nsub, wr, wpos);
    default:
      return wgrad_rounds<8, kBf16>(ws, d, X, kpad, dy, ldn, dW, db, nsub, wr, wpos);
  }
}

// One step of the reverse sweep: a layer's dW product (wgrad: X planes x,
// dY plane dy of ldn rows) or its input-gradient product (bwd_layer: dY
// planes p0, p1 into out, gated by gate, added with add; in: its emb
// columns' matrix, K8c; rnd: in the bf16 mode out is a cotangent JAX
// rounds to bf16 once it is whole).
struct SweepStep {
  XSegs x;
  int layer, dy, ldn, p0, p1, out, gate;
  bool dx, add, in, rnd;
};
constexpr int kMaxSteps = 4 * kMaxLayers;
// The reverse kernel's shared memory: both rings' barriers (256 B), the
// sweep's steps and their count, then the stages that bwd_layer and wgrad
// take in turn.
constexpr int kRevHead = (256 + kMaxSteps * (int)sizeof(SweepStep) + 4 + 127) / 128 * 128;
constexpr int kRevFloats = kBwdStages * BwdStage<false>::kFloats > kWgrFloats
                               ? kBwdStages * BwdStage<false>::kFloats
                               : kWgrFloats;
static_assert(kBwdStages * BwdStage<true>::kFloats <= kRevFloats,
              "the bf16 mode's backward ring fits the reverse kernel's stages");
constexpr int kReverseSmem = kRevHead + kRevFloats * (int)sizeof(float);

// The chain rule of the PE for nq points from sub sub0 on: from the
// cotangent of a PE buffer (plane pg: rows 3 + 6 b + 3 h + c of
// sin(2^b x_c + h pi/2), rows 0-2 of x itself) and the stored x (rows 0-2
// of plane pe), out[base + q][c] = g[c] + sum over b, h of (g[3 + 6 b +
// 3 h + c] cos(2^b x_c + h pi/2)) 2^b, the phase rounded as the forward's
// PE (wg_tile.cuh pe_rows_wg) rounds it.
__device__ void pe_grads(float* ws, const TrainDesc& d, int pe, int pg, int rows,
                         float* __restrict__ out, long long base, int nq, int sub0) {
  const int F = (rows - 3) / 6;
  for (int e = threadIdx.x; e < nq * 3; e += kThreads) {
    const int q = e / 3, c = e % 3, sub = sub0 + q / kPts, p = q % kPts;
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

// Chunk j (< group) of wave `wave` of CTA b: chunk (wave group + j) G + b
// of the R rays (or points), G = the grid.
__device__ __forceinline__ long long group_chunk(int wave, int group, int j) {
  return ((long long)wave * group + j) * gridDim.x + blockIdx.x;
}

// The sweep's steps in order (see train_reverse_kernel) into tab; returns their count.
template <bool kSem, bool kInGrad>
__device__ int sweep_steps(const TrainDesc& d, SweepStep* tab) {
  const MLPDesc& f = d.f;
  const int depth = f.depth, ldw = pad8(f.layer[0].n);
  const int k_alpha = depth, k_feat = depth + 1, k_views = depth + 2, k_rgb = depth + 3;
  const int p_gemb = P_ACT0 + depth + 3, p_gdemb = p_gemb + 1;
  int n = 0;
  auto W = [&](int layer, XSegs x, int dy, int ldn) {
    SweepStep s{};
    s.x = x;
    s.layer = layer;
    s.dy = dy;
    s.ldn = ldn;
    tab[n++] = s;
  };
  auto D = [&](bool add, bool in, int layer, int p0, int p1, int out, int gate) {
    SweepStep s{};
    s.dx = true;
    s.add = add;
    s.in = in;
    // every cotangent but alpha's slot's output where sem_0's is still to be
    // added into it and the PE's (K8c's, which JAX keeps in fp32)
    s.rnd = !in && !(kSem && layer == k_alpha);
    s.layer = layer;
    s.p0 = p0;
    s.p1 = p1;
    s.out = out;
    s.gate = gate;
    tab[n++] = s;
  };
  W(k_rgb, XSegs{{P_HV, 0, 0}, 1}, P_DRGB, pad8(3));
  D(false, false, k_rgb, P_DRGB, -1, P_DPV, P_HV);
  W(k_views, XSegs{{P_FEAT, P_DEMB, 0}, 2}, P_DPV, pad8(f.layer[k_views].n));
  D(false, false, k_views, P_DPV, -1, P_DFEAT, -1);
  if (kInGrad) D(false, true, k_views, P_DPV, -1, p_gdemb, -1);
  const int last = P_ACT0 + depth - 1;
  const XSegs h = (f.skip == depth - 1) ? XSegs{{P_EMB, last, 0}, 2} : XSegs{{last, 0, 0}, 1};
  W(k_feat, h, P_DFEAT, ldw);
  W(k_alpha, h, P_DSIG, 8);
  D(false, false, k_alpha, P_DFEAT, P_DSIG, P_DA, last);
  if (kInGrad && d.ibwd[k_alpha].k > 0) D(true, true, k_alpha, P_DFEAT, P_DSIG, p_gemb, -1);
  if (kSem) {  // sem_1, ds, sem_0, and sem_0's input gradient on h added into P_DA
    const int k_s0 = depth + 4, k_s1 = depth + 5;
    const int p_sact = P_ACT0 + depth, p_dsem = p_sact + 1, p_ds = p_sact + 2;
    W(k_s1, XSegs{{p_sact, 0, 0}, 1}, p_dsem, pad8(f.layer[k_s1].n));
    D(false, false, k_s1, p_dsem, -1, p_ds, p_sact);
    XSegs in = h;
    if (f.sem_with_coord) in.p[in.n++] = P_EMB;
    W(k_s0, in, p_ds, pad8(f.layer[k_s0].n));
    D(true, false, k_s0, p_ds, -1, P_DA, last);
    if (kInGrad && d.ibwd[k_s0].k > 0) D(true, true, k_s0, p_ds, -1, p_gemb, -1);
  }
  int cur = P_DA;
  for (int i = depth - 1; i >= 0; --i) {
    const XSegs in = (i == 0) ? XSegs{{P_EMB, 0, 0}, 1}
                     : (i - 1 == f.skip) ? XSegs{{P_EMB, P_ACT0 + i - 1, 0}, 2}
                                         : XSegs{{P_ACT0 + i - 1, 0, 0}, 1};
    W(i, in, cur, ldw);
    if (kInGrad && (i == 0 || i - 1 == f.skip)) D(true, true, i, cur, -1, p_gemb, -1);
    const int nxt = (cur == P_DA) ? P_DB : P_DA;
    if (i > 0) D(false, false, i, cur, -1, nxt, P_ACT0 + i - 1);
    cur = nxt;
  }
  return n;
}

// Wave `wave` of the reverse sweep, on the chunks that the forward left in
// workspace slice b: its `group` chunks (group_chunk; those past R are
// absent, and only the last present one may be short), sub j nsf.. of its
// planes chunk j's (nsf = the subs of a whole chunk), swept as one run of
// subs: rgb, views, feature + alpha, with kSem (K6, K8c/K8f) the semantic
// head, then the trunk; dW/db add into CTA b's partial gradients (zeroed in
// wave 0), once a wgrad round a wave. Every input-gradient product is
// bwd_layer's, its matrix from bring as br describes (pack_bwd_ring, by
// forward layer index). kInGrad (K8c): the cotangent of the point PE is
// gathered in plane P_ACT0 + depth + 3 (zeroed by the forward) from every
// layer that reads emb (layer 0, the layer after the skip, sem_0's
// coordinates, and feature and alpha when the skip follows the last
// layer; their emb columns in iring as bi describes, d.ibwd by forward
// layer index), the view PE's from the views layer's (plane P_ACT0 +
// depth + 4), and both run back through the PE's chain rule into dpts
// and ddirs [R * S, 3]. The steps (sweep_steps) run from one table, so
// bwd_layer and wgrad each have one inlined call site and the kernel makes
// no call inside a wgmma pipeline. kBf16 (K3, K6, K10b and K8c/K8f at
// --compute_dtype bfloat16): bwd_layer's and wgrad's bf16 modes, the
// input-gradient matrices in pack_bwd_ring's bf16 layout (K8c's emb
// columns in pack_input_ring's); K8c's PE cotangents stay fp32 and
// unrounded, and pe_grads exact fp32 on the stored fp32 points and
// directions, as JAX keeps d_demb, demb_acc and its phases.
template <bool kSem, bool kInGrad = false, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1)
    train_reverse_kernel(const float* __restrict__ bring, const float* __restrict__ iring,
                         const __grid_constant__ TrainDesc d, const __grid_constant__ RingDesc br,
                         const __grid_constant__ RingDesc bi, float* __restrict__ partial,
                         float* __restrict__ workspace, int R, int S, int wave, int group,
                         float* __restrict__ dpts, float* __restrict__ ddirs) {
  extern __shared__ __align__(128) unsigned char rev_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(rev_raw);
  SweepStep* tab = reinterpret_cast<SweepStep*>(rev_raw + 256);
  int* nsteps = reinterpret_cast<int*>(tab + kMaxSteps);
  float* region = reinterpret_cast<float*>(rev_raw + kRevHead);
  const BwdRing ring{bars, bars + kBwdStages, region};
  const WgrRing wr{bars + 2 * kBwdStages, bars + 2 * kBwdStages + kWgrStages, region,
                   region + kWgrB, region + kWgrB + kWgrDb};
  const int rpc = d.rays_per_chunk, nsf = (rpc * S + kPts - 1) / kPts;
  float* gpart = partial + (size_t)blockIdx.x * d.grad_size;
  if (wave == 0) {
    for (size_t i = threadIdx.x; i < (size_t)d.grad_size; i += kThreads) gpart[i] = 0.f;
    __syncthreads();
  }
  int nsub = 0, nchunks = 0;
  for (int j = 0; j < group; ++j) {
    const long long c = group_chunk(wave, group, j);
    if (c * rpc >= R) break;
    nsub = j * nsf + (int)((min((long long)rpc, R - c * rpc) * S + kPts - 1) / kPts);
    nchunks = j + 1;
  }
  if (nsub == 0) return;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwdStages; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, kThreads / 32);  // lane 0 of each warp
    }
    for (int i = 0; i < kWgrStages; ++i) {
      mbar_init(wr.full + i, 1);
      mbar_init(wr.empty + i, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *nsteps = sweep_steps<kSem, kInGrad>(d, tab);
  }
  __syncthreads();
  float* ws = workspace + (size_t)blockIdx.x * d.ws_size;
  int pos = 0, wpos = 0;  // the two rings' stages so far
  for (int k = 0; k < *nsteps; ++k) {
    const SweepStep s = tab[k];
    if (s.dx) {
      const float* src = s.in ? iring + bi.off[s.layer] : bring + br.off[s.layer];
      const int N = s.in ? bi.ncols[s.layer] : br.ncols[s.layer];
      const LayerDesc L = s.in ? d.ibwd[s.layer] : d.bwd[s.layer];
      pos = bwd_layer<kBf16>(src, N, L, ws, d, s.p0, s.p1, s.out, s.gate, nsub, ring, pos, s.add,
                             s.rnd);
    } else {
      wpos = wgrad<kBf16>(ws, d, s.x, s.dy, s.ldn, gpart + d.gw[s.layer], gpart + d.gb[s.layer],
                          nsub, wr, wpos);
    }
  }
  if (kInGrad) {
    __syncthreads();
    const int p_gemb = P_ACT0 + d.f.depth + 3;
    for (int j = 0; j < nchunks; ++j) {
      const long long c = group_chunk(wave, group, j);
      const long long base = c * rpc * S;
      const int nq = (int)(min((long long)rpc, R - c * rpc) * S);
      pe_grads(ws, d, P_EMB, p_gemb, d.f.emb_dim, dpts, base, nq, j * nsf);
      pe_grads(ws, d, P_DEMB, p_gemb + 1, d.f.demb_dim, ddirs, base, nq, j * nsf);
    }
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

// d with its planes moved to chunk j of a wave's group: sub j nsf .. of
// each plane, nsf the subs of a whole chunk of S samples a ray (the
// forward kernels of a group write there, the reverse sweep reads all)
inline TrainDesc group_desc(const TrainDesc& d, int j, int S) {
  TrainDesc dj = d;
  const long long nsf = ((long long)d.rays_per_chunk * S + kPts - 1) / kPts;
  for (int p = 0; p < kMaxPlanes; ++p) dj.plane[p] += j * nsf * d.rows[p] * kLd;
  return dj;
}

// Launch configuration of reduce_partials over n floats.
inline int reduce_blocks(long long n) {
  return (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
}

}  // namespace
