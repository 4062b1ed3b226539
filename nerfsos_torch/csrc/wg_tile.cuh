// The forward tile of the SOS train forward K4 (train_render.cu
// train_render_wg_kernel), redesigned for Hopper: 128 points a tile, two
// consumer warpgroups of 64 points each and one producer thread that
// streams every layer's weights through a ring of shared-memory stages
// with bulk (TMA) copies, and the layer products on wgmma in 3xTF32.
//
// Replaces, with the kernel, nerfsos_tpu/ops/pallas/fused_render.py
// _train_render_fwd_impl -> _train_render_kernel, as the 64-point tile of
// train_sweep.cuh forward_tile did before it.
//
// What bounds it on the H100: the 3xTF32 products, ~1.27 MFLOP a flagship
// point (8 x 256 trunk, the semantic head with coordinates), 48.39 ms for
// the SOS step's 32768 x 192 fine pass at 165 TFLOP/s (495 TF32 / 3); its
// sem_in write (8.0 GB there) is 2.4 ms at 3.35 TB/s.
//
// What held the old tile back (clock64 counters and a variant with the
// weight rows held in L1, nerfsos_torch/tools/tile_probe.py, H100): 37% of
// the tile loop issuing each k step's loads (A from shared memory, the
// weights' TF32 parts with __ldg, 16 a thread), 32% in the m16n8k8 mma and
// their splits, 31% outside the products; the weights in L1 took the
// 32768 x 192 pass from 252 to 217 ms only. So the cost was the
// instructions each warp spent per k step more than the L2 bytes.
//
// What this design does about it:
//   * the host packs each layer's W^T once (ops/fused_render.pack_ring):
//     per k-slice of 8 input rows, the TF32 high parts then the low parts,
//     each in the K-major no-swizzle layout of a wgmma B operand (core
//     matrices of 8 outputs x 4 inputs, 128 B; the two k halves of an
//     8-output group side by side: LBO 128 B, SBO 256 B), so a ring stage
//     is one contiguous block that one cp.async.bulk fills, with no tensor
//     map. The producer thread walks the layers in the consumers' order,
//     tile after tile, on full/empty mbarriers; no consumer thread spends
//     an instruction on the weights, and each weight byte leaves L2 once a
//     128-point tile (39.7 KB a flagship point, against 158.7 KB);
//   * a consumer warpgroup's k step is three wgmma m64nNk8 (lo x hi,
//     hi x lo, hi x hi; N the layer's output width rounded up to 8, 16,
//     32, 64, 128 or 256) with A from registers: each thread loads its four
//     activations of the step from shared memory and splits them with
//     cvt.rna.tf32 as split() does. A step's A registers are rewritten
//     only after the last step's products are done (wait_group 0: an
//     in-flight wgmma's registers must not be touched; with wait_group 1
//     the N = 256 layers came out wrong), so the two warpgroups take turns
//     on the tensor cores;
//   * activations stay fp32, feature-major [row][64 points] a warpgroup,
//     rows XOR-swizzled (point p of row k at p ^ 8 (k & 3)) so the A loads
//     hit 32 banks; a layer's output is written over its input rows once
//     the warpgroup's last product of the layer is done: a warp reads and
//     writes only its own 16 points, so no barrier is needed between
//     layers;
//   * the semantic head's sem_1 and the rgb head are formed from the
//     accumulators of sem_0 and views in registers (a row of an m64
//     accumulator lies in one quad: two shuffles), so neither hidden layer
//     is written to shared memory; sem_in's h columns are written from the last trunk
//     layer's accumulators; the alpha head (one output) is a SIMT dot
//     product over h in shared memory.
// Shared memory (flagship): two warpgroup tiles of emb 64, demb 32 and
// h 256 rows x 64 points (176 KB), the composite strip (12 KB at S = 192,
// 16 KB at S = 64), two 16 KB ring stages (up to four where they fit),
// the barriers: 220-224 KB of 227 (ops/fused_render._wg_plan). Two stages
// keep the consumers waiting on the ring 5% of the tile loop (wgclock).
// Registers: a CTA of 384 threads (the producer's warpgroup is whole, as
// setmaxnreg works by warpgroups) gets 168 a thread at launch; setmaxnreg
// takes the producers to 40 and the consumers to 232, room for the 128
// accumulators of an N = 256 layer (at 168 ptxas serialised the wgmma and
// spilled 734 B).
// K3's and K6's forward (train_render.cu train_forward_wg_kernel) run the
// same tile in its store mode (wg_forward_tile's kStore): every activation
// their reverse sweep reads also goes from the epilogues' registers to the
// CTA's workspace, in train_sweep.cuh's [row][kLd] planes of 64 points
// (sub 2 t + w for warpgroup w of tile t), and emb and demb are copied out
// unswizzled once a tile; K4's instantiation compiles none of it.
// Precision: fp32 activations, 3xTF32 products (both operands split into
// TF32 high and low parts), the PE phases with explicit round-to-nearest
// (no fast-math).
#pragma once

#include "train_sweep.cuh"

constexpr int kMaxRingStages = 4;

// Host-visible: the C entry point takes a RingDesc* (ops/fused_render.pack_ring).
struct RingDesc {
  long long off[kMaxLayers];  // float offset of layer i's first k-slice in the ring buffer
  int ncols[kMaxLayers];      // wgmma N of layer i (0: not a ring layer)
  int hrows;                  // rows of a warpgroup's h tile (the trunk's and feature's N)
  int stages;                 // ring stages, 2 .. kMaxRingStages
  int stage_floats;           // floats of a stage: 16 x the widest N
};

namespace {

constexpr int kWgPts = 64;               // points a consumer warpgroup
constexpr int kWgTile = 2 * kWgPts;      // points a tile
constexpr int kWgConsumers = 256;        // threads of the two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// row k, point p of a warpgroup tile
__device__ __forceinline__ int swz(int k, int p) { return k * kWgPts + (p ^ ((k & 3) << 3)); }

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A K-major, no-swizzle wgmma descriptor of B at p: core matrices of 8
// outputs x 16 B, the two k halves 128 B apart (LBO), 8-output groups
// 256 B apart (SBO).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a b for a 64 x 8 A fragment in registers (tf32) and B at desc:
// wgmma.mma_async m64nNk8, fp32 accumulators.
template <int N>
struct Wgmma;

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Rows [k][64 points] of a warpgroup tile that a layer reads, k a multiple of 8.
struct ASeg {
  const float* a;
  int k;
};

// The consumers' view of the ring: stage pos (counted over the whole CTA's
// run) lies in slot pos % nst, and its fill completes phase (pos / nst) & 1
// of that slot's full barrier.
struct WgRing {
  float* stages;
  uint64_t* full;
  uint64_t* empty;
  int nst, stage_floats;
};

// Where a layer's output goes. Layer mode (h set): rows n < N of h get
// act(acc + b) (relu or not) and, with semin set (the last trunk layer),
// sem_in's h columns of each valid point, semin + (point - qw) * C + n for
// n < hn. Head mode (h null): head's outputs over relu(acc + b) go to
// strip[q * cs + col0 ..] for the valid points q of the warpgroup. With
// plane set (wg_layer's kStore: the train kernels' storing forward), the
// layer's output of all 64 points also goes to plane[n * kLd + point],
// rows n < prow, a workspace tile in the layout train_reverse_kernel
// reads: in layer mode each warp copies its 16 points of each row from h
// once its epilogue is done (float4 copies: 152.3 against 178.5 ms for
// K6's forward at 32768 x 192 with the epilogue's scalar stores, H100,
// tools/tile_probe.py); in head mode, where nothing is written to h, the
// epilogue writes the hidden activation relu(acc + b) itself.
struct WgOut {
  float* h;
  bool relu;
  float* semin;
  int C, hn;
  LayerDesc head;
  float* strip;
  int cs, col0, qw, nq;
  float* plane;
  int prow;
};

// One layer for a consumer warpgroup: acc[point][n] = sum over the
// segments' rows k (in order) of a[k][point] W^T[k][n], k step by k step as
// the ring delivers W^T's k-slices, then the epilogue of o. Returns the
// ring position after the layer's stages. kStore: o.plane may be set.
template <int N, bool kStore>
__device__ __forceinline__ int wg_layer(const float* __restrict__ params, const LayerDesc L,
                                        ASeg s0, ASeg s1, ASeg s2, const WgRing rg, int pos,
                                        const WgOut o) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * w + g;  // the thread's accumulator rows: points m0 and m0 + 8
  // A fragment: a0 (point m0, k t), a1 (m0 + 8, t), a2 (m0, t + 4), a3 (m0 + 8, t + 4)
  const int o0 = t * kWgPts + (m0 ^ (t << 3)), o1 = t * kWgPts + ((m0 + 8) ^ (t << 3));
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int n1 = s0.k / 8, n2 = n1 + s1.k / 8, nsteps = n2 + s2.k / 8;
  auto load = [&](int ks, float (&v)[4]) {
    const float* a = ks < n1   ? s0.a + ks * 8 * kWgPts
                     : ks < n2 ? s1.a + (ks - n1) * 8 * kWgPts
                               : s2.a + (ks - n2) * 8 * kWgPts;
    v[0] = a[o0];
    v[1] = a[o1];
    v[2] = a[o0 + 4 * kWgPts];
    v[3] = a[o1 + 4 * kWgPts];
  };
  int slot = pos % rg.nst;
  uint32_t phase = (pos / rg.nst) & 1;
  float raw[4];
  load(0, raw);
  for (int ks = 0; ks < nsteps; ++ks) {
    // the A operands are written only once the last step's products are
    // done (reading an in-flight wgmma's registers is undefined); the next
    // step's activations are loaded as plain floats meanwhile
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(raw[i], ahi[i], alo[i]);
    if (ks + 1 < nsteps) load(ks + 1, raw);
    while (!mbar_try_wait(rg.full + slot, phase)) {
    }
    const float* b = rg.stages + (size_t)slot * rg.stage_floats;
    const uint64_t bhi = b_desc(b), blo = b_desc(b + N * 8);
    wgmma_fence();
    Wgmma<N>::mma(acc, alo, bhi);
    Wgmma<N>::mma(acc, ahi, blo);
    Wgmma<N>::mma(acc, ahi, bhi);
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(rg.empty + slot);  // the stage is free
    if (++slot == rg.nst) {
      slot = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  pos += nsteps;

  // accumulator i: point m0 + 8 ((i >> 1) & 1), output 8 (i >> 2) + 2 t + (i & 1)
  const float* __restrict__ bias = params + L.b;
  const int ldn = pad8(L.n);
  if (o.h) {
    float* ra = o.semin && o.qw + m0 < o.nq ? o.semin + (size_t)m0 * o.C : nullptr;
    float* rb = o.semin && o.qw + m0 + 8 < o.nq ? o.semin + (size_t)(m0 + 8) * o.C : nullptr;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = n < ldn ? __ldg(bias + n) : 0.f, b1 = n < ldn ? __ldg(bias + n + 1) : 0.f;
      float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
      if (o.relu) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
      }
      o.h[swz(n, m0)] = v[0];
      o.h[swz(n + 1, m0)] = v[1];
      o.h[swz(n, m0 + 8)] = v[2];
      o.h[swz(n + 1, m0 + 8)] = v[3];
      if (ra && n < o.hn) ra[n] = v[0];
      if (ra && n + 1 < o.hn) ra[n + 1] = v[1];
      if (rb && n < o.hn) rb[n] = v[2];
      if (rb && n + 1 < o.hn) rb[n + 1] = v[3];
    }
    __syncwarp();
    if (kStore && o.plane) {  // the warp's 16 points of each row, unswizzled from h
      for (int i = lane; i < o.prow * 4; i += 32) {
        const int k = i >> 2, p = 16 * w + 4 * (i & 3);
        *reinterpret_cast<float4*>(o.plane + k * kLd + p) =
            *reinterpret_cast<const float4*>(o.h + swz(k, p));
      }
    }
    return pos;
  }
  const LayerDesc H = o.head;  // W^T [ldn][pad8(H.n)] fp32, H.n <= kMaxSem
  const float* __restrict__ wt = params + H.w;
  const int ldo = pad8(H.n);
  float s[kMaxSem][2];
#pragma unroll
  for (int c = 0; c < kMaxSem; ++c) s[c][0] = s[c][1] = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      if (n < ldn) {
        const float b = __ldg(bias + n);
        const float va = fmaxf(acc[4 * j + e] + b, 0.f), vb = fmaxf(acc[4 * j + 2 + e] + b, 0.f);
        if (kStore && o.plane) {
          o.plane[n * kLd + m0] = va;
          o.plane[n * kLd + m0 + 8] = vb;
        }
#pragma unroll
        for (int c = 0; c < kMaxSem; ++c)
          if (c < H.n) {
            const float wv = __ldg(wt + n * ldo + c);
            s[c][0] = fmaf(va, wv, s[c][0]);
            s[c][1] = fmaf(vb, wv, s[c][1]);
          }
      }
    }
#pragma unroll
  for (int c = 0; c < kMaxSem; ++c)
    if (c < H.n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[c][r] += __shfl_xor_sync(0xffffffffu, s[c][r], 1);
        s[c][r] += __shfl_xor_sync(0xffffffffu, s[c][r], 2);
      }
    }
  if (t == 0) {
    const int qa = o.qw + m0, qb = qa + 8;
    for (int c = 0; c < H.n; ++c) {
      const float bc = __ldg(params + H.b + c);
      if (qa < o.nq) o.strip[qa * o.cs + o.col0 + c] = s[c][0] + bc;
      if (qb < o.nq) o.strip[qb * o.cs + o.col0 + c] = s[c][1] + bc;
    }
  }
  return pos;
}

// wg_layer at the layer's ring width N (pack_ring's: 8, 16, 32, 64, 128 or 256)
template <bool kStore>
__device__ __forceinline__ int wg_layer_n(int N, const float* __restrict__ params,
                                          const LayerDesc L, ASeg s0, ASeg s1, ASeg s2,
                                          const WgRing rg, int pos, const WgOut& o) {
  switch (N) {
    case 256: return wg_layer<256, kStore>(params, L, s0, s1, s2, rg, pos, o);
    case 128: return wg_layer<128, kStore>(params, L, s0, s1, s2, rg, pos, o);
    case 64: return wg_layer<64, kStore>(params, L, s0, s1, s2, rg, pos, o);
    case 32: return wg_layer<32, kStore>(params, L, s0, s1, s2, rg, pos, o);
    case 16: return wg_layer<16, kStore>(params, L, s0, s1, s2, rg, pos, o);
    default: return wg_layer<8, kStore>(params, L, s0, s1, s2, rg, pos, o);
  }
}

// The ring's layers in the consumers' order: the trunk, sem_0 (with the
// semantic head), feature, views. Returns their count.
__device__ __forceinline__ int ring_order(const MLPDesc& f, int (&order)[kMaxLayers]) {
  int nl = 0;
  for (int i = 0; i < f.depth; ++i) order[nl++] = i;
  if (f.sem_dim) order[nl++] = f.depth + 4;
  order[nl++] = f.depth + 1;
  order[nl++] = f.depth + 2;
  return nl;
}

// The producer (one thread): every k-slice of every ring layer, tile after
// tile, each into the next free stage by one bulk copy.
__device__ __forceinline__ void ring_producer(const float* __restrict__ ring, const MLPDesc& f,
                                              const RingDesc& rd, const WgRing rg, int ntiles) {
  int order[kMaxLayers];
  const int nl = ring_order(f, order);
  int slot = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < ntiles; ++tile)
    for (int l = 0; l < nl; ++l) {
      const int li = order[l], n = rd.ncols[li], nsl = f.layer[li].k / 8;
      const uint32_t bytes = n * 64;  // 8 rows x n outputs x {hi, lo} x 4 B
      const float* src = ring + rd.off[li];
      for (int s = 0; s < nsl; ++s) {
        while (!mbar_try_wait(rg.empty + slot, phase ^ 1)) {
        }
        mbar_expect_tx(rg.full + slot, bytes);
        bulk_g2s(rg.stages + (size_t)slot * rg.stage_floats, src + (size_t)s * 16 * n, bytes,
                 rg.full + slot);
        if (++slot == rg.nst) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
}

// A CTA of the 128-point tile (K4's kernel, K3's and K6's forward): its
// dynamic shared memory holds the ring's barriers (128 B), rd.stages ring
// stages, the two warpgroups' emb, demb and h tiles and the composite strip.
struct WgCta {
  WgRing rg;
  float* tiles;  // warpgroup w's emb, demb and h at tiles + w * per_wg
  float* strip;
  int per_wg;
};

// Lays out raw, initialises the ring's barriers and zeroes the padding rows
// of emb and demb, which nothing else writes; the caller synchronises.
__device__ __forceinline__ WgCta wg_cta(unsigned char* raw, const MLPDesc& f,
                                        const RingDesc& rd) {
  uint64_t* full = reinterpret_cast<uint64_t*>(raw);
  uint64_t* empty = full + kMaxRingStages;
  float* stages = reinterpret_cast<float*>(raw + 128);
  const int Ep = pad8(f.emb_dim), Edp = pad8(f.demb_dim);
  const int per_wg = (Ep + Edp + rd.hrows) * kWgPts;
  float* tiles = stages + (size_t)rd.stages * rd.stage_floats;
  if (threadIdx.x == 0) {
    for (int i = 0; i < rd.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWgConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 2 * kWgPts) {
    float* mine = tiles + (threadIdx.x / kWgPts) * per_wg;
    const int p = threadIdx.x % kWgPts;
    for (int k = f.emb_dim; k < Ep; ++k) mine[swz(k, p)] = 0.f;
    for (int k = f.demb_dim; k < Edp; ++k) mine[Ep * kWgPts + swz(k, p)] = 0.f;
  }
  return WgCta{WgRing{stages, full, empty, rd.stages, rd.stage_floats}, tiles,
               tiles + 2 * per_wg, per_wg};
}

// After the CTA's barrier: warps 8-11, the producer warpgroup, give up
// their registers (setmaxnreg 40) and one thread streams ntiles tiles'
// weights (ring_producer), and get false; warps 0-7, the two consumer
// warpgroups, take 232 registers a thread (the 128 accumulators of an
// N = 256 layer) and get true.
__device__ __forceinline__ bool wg_consumer(const float* __restrict__ ring, const MLPDesc& f,
                                            const RingDesc& rd, const WgRing rg, int ntiles) {
  if (threadIdx.x >= kWgConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kWgConsumers) ring_producer(ring, f, rd, rg, ntiles);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  return true;
}

// Rows 3.. of a warpgroup's PE buffer whose rows 0-2 hold x: pe_rows's
// values (sin(2^b x_c + h pi/2) in row 3 + 6 b + 3 h + c) in a swizzled tile.
__device__ __forceinline__ void pe_rows_wg(float* buf, int rows) {
  for (int i = threadIdx.x & 127; i < (rows - 3) * kWgPts; i += 128) {
    const int f = i / kWgPts, p = i % kWgPts;
    const int band = f / 6, r = f % 6, c = r % 3;
    const float phase = (r >= 3) ? 1.57079632679489661923f : 0.f;
    const float freq = ldexpf(1.f, band);
    buf[swz(3 + f, p)] = sinf(__fadd_rn(__fmul_rn(freq, buf[swz(c, p)]), phase));
  }
}

// Rows [0, rows) of a warpgroup tile, unswizzled, to a workspace tile [rows][kLd].
__device__ __forceinline__ void wg_store_rows(const float* src, float* dst, int rows) {
  for (int i = threadIdx.x & 127; i < rows * (kWgPts / 4); i += 128) {
    const int k = i / (kWgPts / 4), p = (i % (kWgPts / 4)) * 4;
    *reinterpret_cast<float4*>(dst + k * kLd + p) =
        *reinterpret_cast<const float4*>(src + swz(k, p));
  }
}

// The forward of tile `tile` of a chunk (rays r0.., S samples a ray, nq
// points; z of the chunk at zc) for the calling consumer warpgroup, its
// points qw .. qw + 63 (qw = 128 tile + 64 warpgroup): their inputs and
// PE, the trunk, alpha, sem_0 and sem_1, feature, views and rgb on the
// warpgroup's emb, demb and h tiles at `mine`; sigma, the rgb logits and
// the semantics of point q go to strip[q * (6 + sem) + 0, 2.., 5..].
// K4 (kStore false): with semin, [h; emb] (forward_tile's sem_in row) to
// semin row base + q. K3/K6 (kStore): every activation the reverse sweep
// reads goes to the workspace slice ws, as sub qw / 64 of its planes
// (train_desc's layout: P_EMB, P_DEMB, P_ACT0 + i, P_FEAT, P_HV, and with
// kSemAct the semantic head's hidden activation at P_ACT0 + depth); a
// warpgroup whose points all lie past nq has no sub and stores nothing.
// Returns the ring position after the tile.
template <bool kStore, bool kSemAct>
__device__ __forceinline__ int wg_forward_tile(const float* __restrict__ odv, const float* zc,
                                               int r0, int S, int nq, int tile,
                                               const float* __restrict__ params,
                                               const TrainDesc& d, const RingDesc& rd,
                                               const WgRing rg, int pos, float* mine,
                                               float* strip, float* __restrict__ semin,
                                               long long base, float* ws) {
  const MLPDesc& f = d.f;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, bar = 1 + wg;
  const int depth = f.depth, E = f.emb_dim, Ep = pad8(E), Ed = f.demb_dim, Edp = pad8(Ed);
  const int sem = f.sem_dim, cs = 6 + sem;
  float* emb = mine;
  float* demb = emb + Ep * kWgPts;
  float* h = demb + Edp * kWgPts;
  const int qw = tile * kWgTile + wg * kWgPts;
  const LayerDesc* head = f.layer + depth;  // alpha, feature, views, rgb, sem_0, sem_1
  const bool store = kStore && qw < nq;
  const int sub = qw / kWgPts;

  wg_bar(bar);  // the last tile's reads of emb and demb are done
  for (int i = tid; i < 3 * kWgPts; i += 128) {
    const int ch = i / kWgPts, p = i % kWgPts, q = qw + p;
    float x = 0.f, v = 0.f;
    if (q < nq) {
      const float* ray = odv + (size_t)(r0 + q / S) * 9;
      x = __fadd_rn(ray[ch], __fmul_rn(ray[3 + ch], zc[q]));
      v = ray[6 + ch];
    }
    emb[swz(ch, p)] = x;
    demb[swz(ch, p)] = v;
  }
  wg_bar(bar);
  pe_rows_wg(emb, E);
  pe_rows_wg(demb, Ed);
  wg_bar(bar);
  if (store) {
    wg_store_rows(emb, plane(ws, d, P_EMB, sub), Ep);
    wg_store_rows(demb, plane(ws, d, P_DEMB, sub), Edp);
  }

  // the ring's layers in order (ring_order): the trunk, each output over h;
  // sem_0 on [h; emb] with sem_1 from its accumulators; feature over h;
  // views with rgb from its accumulators. One call site, so the whole tile
  // is one function and ptxas keeps the wgmma pipeline.
  const ASeg none{nullptr, 0};
  const int hn = f.layer[depth - 1].n, hoff = f.skip == depth - 1 ? E : 0;
  const int C = hoff + hn + (f.sem_with_coord ? E : 0);
  int order[kMaxLayers];
  const int nl = ring_order(f, order);
  ASeg in0{emb, Ep}, in1 = none;
  for (int l = 0; l < nl; ++l) {
    const int li = order[l];
    if (l == depth) {
      wg_bar(bar);  // h is whole: the reads below cross warps
      // sem_in's emb columns, then the alpha head (a thread a point)
      if (!kStore && semin != nullptr) {
        const int np = min(kWgPts, nq - qw);
        for (int part = 0; part < 2; ++part) {
          if (part == 0 ? hoff == 0 : !f.sem_with_coord) continue;
          const int off = part == 0 ? 0 : hoff + hn;
          for (int e = tid; e < np * E; e += 128) {
            const int p = e / E, c = e % E;
            semin[(base + qw + p) * C + off + c] = emb[swz(c, p)];
          }
        }
      }
      if (tid < kWgPts && qw + tid < nq) {
        const ASeg segs[2] = {in0, in1};
        const float* __restrict__ wcol = params + head[0].w;
        float acc = 0.f;
#pragma unroll
        for (int sg = 0; sg < 2; ++sg)
          for (int k = 0; k < segs[sg].k; ++k, wcol += 8)
            acc = fmaf(segs[sg].a[swz(k, tid)], __ldg(wcol), acc);
        strip[(qw + tid) * cs] = acc + __ldg(params + head[0].b);
      }
      wg_bar(bar);  // before feature's output overwrites h
    }
    WgOut o{};
    o.strip = strip;
    o.cs = cs;
    o.qw = qw;
    o.nq = nq;
    ASeg a0 = in0, a1 = in1, a2 = none;
    int out = -1;  // the layer's workspace plane (kStore)
    if (l < depth || li == depth + 1) {  // trunk, feature
      o.h = h;
      o.relu = l < depth;
      out = l < depth ? P_ACT0 + l : P_FEAT;
      if (!kStore && l == depth - 1 && semin != nullptr) {
        o.semin = semin + (base + qw) * C + hoff;
        o.C = C;
        o.hn = hn;
      }
    } else if (li == depth + 4) {  // sem_0
      a2 = f.sem_with_coord ? ASeg{emb, Ep} : none;
      o.head = head[5];
      o.col0 = 5;
      if (kSemAct) out = P_ACT0 + depth;
    } else {  // views
      a0 = ASeg{h, pad8(head[1].n)};
      a1 = ASeg{demb, Edp};
      o.head = head[3];
      o.col0 = 2;
      out = P_HV;
    }
    if (store && out >= 0) {
      o.plane = plane(ws, d, out, sub);
      o.prow = d.rows[out];
    }
    pos = wg_layer_n<kStore>(rd.ncols[li], params, f.layer[li], a0, a1, a2, rg, pos, o);
    if (l < depth) {
      const ASeg hs{h, pad8(f.layer[l].n)};
      in0 = l == f.skip ? ASeg{emb, Ep} : hs;
      in1 = l == f.skip ? hs : none;
    }
  }
  return pos;
}

}  // namespace
