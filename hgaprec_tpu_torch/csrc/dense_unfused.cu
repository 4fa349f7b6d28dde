// Kernel #1's unfused route for Hopper (sm_90a): the dense sweep of
// csrc/dense_wgmma.cu, both precisions, for rows of 1024 packed values and
// more (ops/dense_fused.py::UNFUSED_FROM; below them the cluster kernel),
// bound to Python with ctypes (ops/dense_fused.py). It replaces the TPU
// kernel hgaprec_tpu/ops/dense_pallas.py::_kernel at those widths, whose
// three products all run on the TPU's matrix unit (dense_pallas.py:72,
// 86-87).
//
// At these widths little of a row stays on chip (an f32 row's pieces take
// 6 KB a 1024 values, a 64-row stationary tile's output sums kq / 2
// registers a thread), and the fused designs pay for it: the cluster
// kernel spreads a row over up to eight CTAs, the streamed kernel forms S
// again per column window. What fusing S, W and the contractions saves is
// W's trip through HBM, and at these widths that trip is cheap: W is
// written once and read twice, 3 N M (2 or 6) bytes (0.12 ms at ML-1M
// K = 2600 in f32, against a 2.1 ms bound). So the sweep runs unfused, one
// slab of users at a time (ops/dense_fused.py::unfused_plan: whole
// multiples of 128 rows, W's slab within a fixed budget), as three
// GEMM-shaped passes whose issued work is the function's own 6 N M kq
// (x 6 bf16 products on the f32 route):
//   * dense_w_kernel: S = A_slab B^T over [slab users] x [items], then
//     W = Y / max(S, 1e-30) (f32: the IEEE quotient, split into its three
//     bf16 pieces by split_pieces' rule; bf16: bf16(Y rcp.approx(max(S,
//     1e-30))), as the other routes form it), written to an HBM slab,
//     [3, slab, ldw] or [slab, ldw] bf16;
//   * dense_contract_kernel<kP, kWG, 0>: acc_a[slab] = W_slab B, the
//     reduction over the items; W read K-major, B MN-major (as
//     dense_wgmma_kernel reads its moving tile in the contraction);
//   * dense_contract_kernel<kP, kWG, 1>: acc_b += W_slab^T A_slab, the
//     reduction over the slab's users; W read MN-major as the A operand
//     (its columns are the output rows), A_slab MN-major. The slabs add
//     into acc_b one after the other on one stream, in a fixed order.
// One template serves both routes: kP = 1 piece a factor (bf16) or kP = 3
// (f32, the six split products of pair_x / pair_z, smallest first).
//   * Tiles: 64 kWG output rows (kWG consumer warpgroups of 64: three on
//     the bf16 route, two on the f32 route) by 256 (bf16) or 128 (f32)
//     columns, each k-block of 64 along the reduction staged by TMA
//     (128-byte swizzle, both operands, all pieces) into one stage of a
//     ring, 4 stages of 56 KB (bf16) or 2 of 96 KB (f32). A 192-row bf16
//     tile stages 110 FLOP a byte against a 128-row tile's 85, and ran
//     faster at every shape timed (PERF.md, section 6). The CTA is the
//     consumer warpgroups alone: a CTA of nine warps or more gets at most
//     168 registers a thread whatever setmaxnreg says (csrc/dense_wgmma.cu,
//     the f32 route's budget); the f32 sums take 192 of two warpgroups'
//     255, and the bf16 accumulator 128 of three warpgroups' 168. So there
//     is no producer warp: every warp releases a stage once its products
//     on it have retired, and the warp whose release empties the stage
//     loads the k-block kStages ahead into it (SplitLoader's claim).
//   * Products in flight: two wgmma groups at a time, the second issued
//     before the first is waited on (wgmma_wait<1>), and both retired
//     before a stage is released: a product in flight across a branch or
//     the loop's back edge makes ptxas serialize every wgmma (csrc/
//     dense_wgmma.cu, hazard 5). bf16: one m64n256 accumulator (128
//     registers) that every k-block adds into, two k-blocks a step. f32:
//     two m64n64 accumulators (the tile's column halves), one group each
//     a k-block, 6 pairs x 4 k-steps = 24 products from zero, each
//     promoted into compensated (Kahan) f32 sums once retired, the first
//     while the second runs, so no wgmma accumulator sums more than 24
//     products (the tensor cores' adder truncates) and a sum over a slab
//     of users carries the error of a few additions.
//   * Bound: the products, 6 N M kq at 989 TFLOP/s (x 6 on the f32 route,
//     165 TFLOP/s of f32-accurate multiply-adds): per 64-deep k-block a
//     CTA stages 56 KB (bf16) or 96 KB (f32) for 6.3 or 12.6 MFLOP, 110 or
//     128 FLOP a byte, so L2's rate into shared memory is the next limit.
// Every launch checks its error; the entries return the first cudaError_t.

#include "wgmma_common.cuh"   // and through it dense_roles.cuh

namespace {

enum Pass : int { kPassW = 0, kPassA = 1, kPassB = 2 };

// The plan of a CTA of kP pieces (1 bf16, 3 f32): kN output columns in
// accumulators of kG columns, a ring of kStages stages, each one k-block
// of 64 of both operands (the A operand's kRows rows, then the B operand's
// kN rows, each piece a region of its own), then the full and empty
// mbarriers and one claim per stage. Every region on a 1024-byte boundary.
template <int kP, int kWG>
struct UPlan {
  static constexpr int kRows = 64 * kWG;         // output rows of a CTA tile
  static constexpr int kThreads = 128 * kWG;     // no producer warp
  static constexpr int kN = kP == 1 ? 256 : 128;
  static constexpr int kG = kP == 1 ? 256 : 64;
  static constexpr int kABytes = kRows * 128;    // one piece of A's k-block
  static constexpr int kBBytes = kN * 128;       // one piece of B's k-block
  static constexpr int kStageBytes = kP * (kABytes + kBBytes);
  static constexpr int kBarBytes = 128;
  static constexpr int kFit = (kMaxSmem - 1024 - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOff + kBarBytes;
  static_assert(kStages >= 2 && 20 * kStages <= kBarBytes, "the ring");
};

// D[64 x N] (+)= A B: m64nNk16, bf16 inputs, f32 accumulators, N / 2 per
// thread, both operands from shared memory; kTA / kTB = 1 reads A / B
// MN-major, 0 K-major; scale_d = 0 overwrites D.
template <int N, int kTA, int kTB>
__device__ __forceinline__ void wgmma_sst(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 256, "the two accumulator widths");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, "
        "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, "
        "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "
        "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, "
        "p, 1, 1, %131, %132;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
}

// The ring of pass kPass: k-block it in stage it % kStages. The A operand
// is a's rows (pass W, K-major), W's rows (pass A, K-major) or W's
// columns (pass B, MN-major: kWG blocks of 64); the B operand b's rows
// (pass W, K-major) or a factor's columns (passes A and B, MN-major:
// kN / 64 blocks of 64), all loaded through 3-D tensor maps (column, row,
// piece) with 128-byte swizzle.
template <int kP, int kWG, int kPass>
struct URing {
  using P = UPlan<kP, kWG>;
  uint32_t base, bars;
  const CUtensorMap *ma, *mb;
  int a0, b0;   // the A and B operands' first row or column
  int kb0;      // the B operand's first reduction row (pass B: the slab's)
  int nk;       // k-blocks of 64 along the reduction
  int* claims;  // per stage, the k-block last loaded into it
  __device__ __forceinline__ uint32_t stage(int it) const {
    return base + (it % P::kStages) * P::kStageBytes;
  }
  __device__ __forceinline__ uint32_t full(int it) const {
    return bars + 8 * (it % P::kStages);
  }
  __device__ __forceinline__ uint32_t empty(int it) const {
    return bars + 8 * (P::kStages + it % P::kStages);
  }
  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(full(it), (it / P::kStages) & 1);
  }
  __device__ __forceinline__ void load(int it) const {
    const uint32_t st = stage(it), bar = full(it);
    const int k = 64 * it;
    mbar_expect_tx(bar, P::kStageBytes);
    for (int p = 0; p < kP; ++p) {
      const uint32_t sa = st + p * P::kABytes;
      const uint32_t sb = st + kP * P::kABytes + p * P::kBBytes;
      if (kPass == kPassB) {
        for (int i = 0; i < kWG; ++i)
          tma_load_3d(sa + i * 8192, ma, a0 + 64 * i, k, p, bar);
      } else {
        tma_load_3d(sa, ma, k, a0, p, bar);
      }
      if (kPass == kPassW) {
        tma_load_3d(sb, mb, k, b0, p, bar);
      } else {
        for (int j = 0; j < P::kN / 64; ++j)
          tma_load_3d(sb + j * 8192, mb, b0 + 64 * j, kb0 + k, p, bar);
      }
    }
  }
  // every warp, once its products on k-block it have retired: its lane 0
  // arrives on the stage's empty barrier (all the CTA's warps' arrivals
  // empty it); the warp that finds the stage empty claims it and loads
  // k-block it + kStages into it (the claim keeps a second finder from
  // loading it twice)
  __device__ __forceinline__ void release(int it) const {
    if (threadIdx.x % 32 != 0) return;
    const uint32_t e = empty(it);
    mbar_arrive(e);
    const int s = it % P::kStages;
    if (it + P::kStages < nk && mbar_test(e, (it / P::kStages) & 1) &&
        atomicCAS(claims + s, it, it + P::kStages) == it)
      load(it + P::kStages);
  }
};

// The ring's barriers and claims set up, then its first stages loaded.
template <int kP, int kWG, int kPass>
__device__ __forceinline__ URing<kP, kWG, kPass> unf_start(
    unsigned char* base, const CUtensorMap* ma, const CUtensorMap* mb,
    int a0, int b0, int kb0, int nk) {
  using P = UPlan<kP, kWG>;
  const uint32_t s0 = smem_u32(base);
  int* claims = reinterpret_cast<int*>(base + P::kBarOff + 16 * P::kStages);
  const URing<kP, kWG, kPass> ring{s0, s0 + P::kBarOff, ma, mb, a0, b0, kb0,
                                   nk, claims};
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(ring.bars + 8 * s, 1);                      // full
      mbar_init(ring.bars + 8 * (P::kStages + s), 4 * kWG);  // empty: warps
      claims[s] = s;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int it = 0; it < P::kStages && it < nk; ++it) ring.load(it);
  return ring;
}

// Group kH of a k-block in stage st: warpgroup g's 64 rows of the A
// operand against the B operand's columns [kG kH, kG kH + kG), every
// (piece, piece) pair (one on the bf16 route), four k-steps of 16 each.
// K-major: k-steps 32 bytes apart inside the 128-byte rows, 8-row groups
// 1024 bytes apart; MN-major: blocks of 64 columns 8192 bytes apart,
// k-steps of 16 rows 2048 bytes apart. more = 0 starts from zero.
// Committed, not waited on; the caller fences the accumulators before
// the first group it issues (wgmma_fence), not between groups in flight.
template <int kP, int kWG, int kPass, int kH>
__device__ __forceinline__ void unf_issue(
    float (&acc)[UPlan<kP, kWG>::kG / 2], uint32_t st, int g, bool more) {
  using P = UPlan<kP, kWG>;
  constexpr int kTA = kPass == kPassB, kTB = kPass != kPassW;
  const uint64_t da = desc_sw128(st + g * 8192, kTA ? 512 : 1, 64);
  const uint64_t db = desc_sw128(st + kP * P::kABytes + kH * P::kG * 128,
                                 kTB ? 512 : 1, 64);
#pragma unroll
  for (int p = 0; p < (kP == 1 ? 1 : kPairs); ++p)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int px = kP == 1 ? 0 : pair_x(p), pz = kP == 1 ? 0 : pair_z(p);
      wgmma_sst<P::kG, kTA, kTB>(
          acc, da + ((px * P::kABytes + ks * (kTA ? 2048 : 32)) >> 4),
          db + ((pz * P::kBBytes + ks * (kTB ? 2048 : 32)) >> 4),
          more || p > 0 || ks > 0);
    }
  wgmma_commit();
}

// bf16: every k-block's products into one accumulator, two k-blocks a
// step: both groups are issued before either is waited on, and both
// stages are released once both have retired, so that nothing is in
// flight across a branch or the loop's back edge (ptxas serializes every
// wgmma otherwise, csrc/dense_wgmma.cu hazard 5).
template <int kWG, int kPass>
__device__ __forceinline__ void unf_sweep(float (&acc)[128],
                                          const URing<1, kWG, kPass>& ring,
                                          int g) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (; it + 1 < ring.nk; it += 2) {
    ring.wait_full(it);
    ring.wait_full(it + 1);
    fence_regs(acc);
    wgmma_fence();
    unf_issue<1, kWG, kPass, 0>(acc, ring.stage(it), g, it > 0);
    unf_issue<1, kWG, kPass, 0>(acc, ring.stage(it + 1), g, true);
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(it);
    ring.release(it + 1);
  }
  if (it < ring.nk) {
    ring.wait_full(it);
    fence_regs(acc);
    wgmma_fence();
    unf_issue<1, kWG, kPass, 0>(acc, ring.stage(it), g, it > 0);
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(it);
  }
}

// the retired accumulator acc added into columns [kOff, kOff + 64) of the
// sums, compensated
template <int kOff>
__device__ __forceinline__ void kahan_add(float (&sums)[64],
                                          float (&comp)[64],
                                          const float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float y = acc[i] - comp[kOff / 2 + i];
    const float t = sums[kOff / 2 + i] + y;
    comp[kOff / 2 + i] = (t - sums[kOff / 2 + i]) - y;
    sums[kOff / 2 + i] = t;
  }
}

// f32: per k-block two groups of 24 products, one per column half, each
// into its own accumulator from zero: the second is issued before the
// first is waited on (wgmma_wait<1>) and promoted into the sums while the
// second runs; the stage is released once both have retired, so that
// nothing is in flight across a branch or the loop's back edge.
template <int kWG, int kPass>
__device__ __forceinline__ void unf_sweep(float (&sums)[64],
                                          const URing<3, kWG, kPass>& ring,
                                          int g) {
  float comp[64], acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) sums[i] = comp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  for (int it = 0; it < ring.nk; ++it) {
    ring.wait_full(it);
    const uint32_t st = ring.stage(it);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
    unf_issue<3, kWG, kPass, 0>(acc0, st, g, false);
    unf_issue<3, kWG, kPass, 1>(acc1, st, g, false);
    wgmma_wait<1>();   // the first group has retired
    fence_regs(acc0);
    kahan_add<0>(sums, comp, acc0);
    wgmma_wait<0>();
    fence_regs(acc1);
    kahan_add<64>(sums, comp, acc1);
    ring.release(it);
  }
}

// S, W and W's slab for one tile of [slab users] x [items]: grid (item
// tiles of kN, user tiles of 128); a, b the factor tables [kP, rows, kq];
// W's rows are the slab's users (row r is user u0 + r), ldw values apart,
// its pieces rows_cap rows apart. Y is read from HBM in the epilogue
// (two bytes a pair of accumulator elements).
template <int kP, int kWG>
__global__ void __launch_bounds__(128 * kWG, 1)
dense_w_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const uint8_t* __restrict__ y, __nv_bfloat16* __restrict__ w,
               int m, int kq, long long ldy, int u0, int rows, int ldw,
               int rows_cap) {
  using P = UPlan<kP, kWG>;
  constexpr int kE = P::kN / 2;   // accumulator elements a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int row0 = blockIdx.y * P::kRows, col0 = blockIdx.x * P::kN;
  const URing<kP, kWG, kPassW> ring = unf_start<kP, kWG, kPassW>(
      base, &map_a, &map_b, u0 + row0, col0, 0, kq / 64);
  const int tid = threadIdx.x;
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  // accumulator element i sits at row r0 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 q + i % 2 of the warpgroup's 64 rows
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  float s[kE];
  unf_sweep<kWG, kPassW>(s, ring, g);

  // in chunks of kC elements: their Y pairs loaded, then their W stored
  // (8 on the bf16 route, whose accumulator takes 128 registers)
  constexpr int kC = kP == 1 ? 8 : 16;
  const long long piece = (long long)rows_cap * ldw;
#pragma unroll
  for (int c = 0; c < kE; c += kC) {
    uint32_t yv[kC / 2];
#pragma unroll
    for (int i = c; i < c + kC; i += 2) {
      const int row = row0 + 64 * g + r0 + 8 * ((i / 2) % 2);
      const int col = col0 + 8 * (i / 4) + 2 * q;
      yv[(i - c) / 2] = row < rows && col < m
                            ? __ldg(reinterpret_cast<const unsigned short*>(
                                  y + (long long)(u0 + row) * ldy + col))
                            : 0u;
    }
#pragma unroll
    for (int i = c; i < c + kC; i += 2) {
      const int row = row0 + 64 * g + r0 + 8 * ((i / 2) % 2);
      const int col = col0 + 8 * (i / 4) + 2 * q;
      if (row < rows && col < m) {
        const float y0 = widen_u8(yv[(i - c) / 2], 0x7440);
        const float y1 = widen_u8(yv[(i - c) / 2], 0x7441);
        uint32_t* at = reinterpret_cast<uint32_t*>(
            w + (long long)row * ldw + col);
        if constexpr (kP == 1) {
          *at = pack_bf16x2(y0 * rcp_approx(fmaxf(s[i], 1e-30f)),
                            y1 * rcp_approx(fmaxf(s[i + 1], 1e-30f)));
        } else {
          uint32_t p1, p2, p3;
          split3(w_of(y0, fmaxf(s[i], 1e-30f)),
                 w_of(y1, fmaxf(s[i + 1], 1e-30f)), p1, p2, p3);
          at[0] = p1;
          at[piece / 2] = p2;
          at[piece] = p3;
        }
      }
    }
  }
}

// One contraction for one tile of output rows x kN columns of kq: grid
// (column tiles, row tiles). kRole 0: acc_a's rows of the slab's users,
// W_slab B (the reduction over the m items); kRole 1: acc_b's item rows,
// W_slab^T A_slab (the reduction over the slab's rows users), added to
// what the earlier slabs left unless `first`.
template <int kP, int kWG, int kRole>
__global__ void __launch_bounds__(128 * kWG, 1)
dense_contract_kernel(const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_f,
                      float* __restrict__ out, int m, int kq, int u0,
                      int rows, int first) {
  using P = UPlan<kP, kWG>;
  constexpr int kE = P::kN / 2;
  constexpr int kPass = kRole == 0 ? kPassA : kPassB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int row0 = blockIdx.y * P::kRows, col0 = blockIdx.x * P::kN;
  const URing<kP, kWG, kPass> ring = unf_start<kP, kWG, kPass>(
      base, &map_w, &map_f, row0, col0, kRole == 0 ? 0 : u0,
      ((kRole == 0 ? m : rows) + 63) / 64);
  const int tid = threadIdx.x;
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  float s[kE];
  unf_sweep<kWG, kPass>(s, ring, g);

  const int nrows = kRole == 0 ? rows : m;
#pragma unroll
  for (int i = 0; i < kE; i += 2) {
    const int row = row0 + 64 * g + r0 + 8 * ((i / 2) % 2);
    const int col = col0 + 8 * (i / 4) + 2 * q;
    if (row < nrows && col < kq) {
      float2* at = reinterpret_cast<float2*>(
          out + (long long)(kRole == 0 ? u0 + row : row) * kq + col);
      float2 v = make_float2(s[i], s[i + 1]);
      if (kRole == 1 && !first) {
        const float2 was = *at;
        v = make_float2(was.x + v.x, was.y + v.y);
      }
      *at = v;
    }
  }
}

template <typename K>
int opt_in(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The slabs of slab_rows users, in order, each: dense_w_kernel, then the
// two contractions; W's slab (w) holds [kP, slab_rows, ldw] bf16.
template <int kP, int kWG>
int launch_unfused(const void* a, const void* b, const void* y, void* acc_a,
                   void* acc_b, void* w, int n, int m, int kq,
                   long long ldy, int slab_rows, int ldw,
                   cudaStream_t stream) {
  using P = UPlan<kP, kWG>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const uint64_t wrow = (uint64_t)ldw * 2, wpiece = wrow * slab_rows;
  CUtensorMap ma_rows, mb_rows, ma_blk, mb_blk;
  if (!encode_packed(&ma_rows, a, kq, n, kP, P::kRows, 1) ||
      !encode_packed(&mb_rows, b, kq, m, kP, P::kN, 1) ||
      !encode_packed(&ma_blk, a, kq, n, kP, 64, 1) ||
      !encode_packed(&mb_blk, b, kq, m, kP, 64, 1))
    return (int)cudaErrorInvalidValue;
  int err = opt_in(dense_w_kernel<kP, kWG>, P::kSmem);
  if (!err) err = opt_in(dense_contract_kernel<kP, kWG, 0>, P::kSmem);
  if (!err) err = opt_in(dense_contract_kernel<kP, kWG, 1>, P::kSmem);
  if (err) return err;
  const int item_tiles = (m + P::kRows - 1) / P::kRows;
  const int item_wins = (m + P::kN - 1) / P::kN;
  const int col_tiles = (kq + P::kN - 1) / P::kN;
  auto* wb = static_cast<__nv_bfloat16*>(w);
  for (int u0 = 0; u0 < n; u0 += slab_rows) {
    const int rows = n - u0 < slab_rows ? n - u0 : slab_rows;
    const int user_tiles = (rows + P::kRows - 1) / P::kRows;
    CUtensorMap mw_rows, mw_blk;
    if (!encode_bf16(&mw_rows, w, m, rows, kP, wrow, wpiece, P::kRows, 1) ||
        !encode_bf16(&mw_blk, w, m, rows, kP, wrow, wpiece, 64, 1))
      return (int)cudaErrorInvalidValue;
    dense_w_kernel<kP, kWG><<<dim3(item_wins, user_tiles), P::kThreads,
                              P::kSmem, stream>>>(ma_rows, mb_rows,
                                   static_cast<const uint8_t*>(y), wb, m, kq,
                                   ldy, u0, rows, ldw, slab_rows);
    if ((err = (int)cudaGetLastError())) return err;
    dense_contract_kernel<kP, kWG, 0><<<dim3(col_tiles, user_tiles),
                                        P::kThreads, P::kSmem, stream>>>(
        mw_rows, mb_blk, static_cast<float*>(acc_a), m, kq, u0, rows, 1);
    if ((err = (int)cudaGetLastError())) return err;
    dense_contract_kernel<kP, kWG, 1><<<dim3(col_tiles, item_tiles),
                                        P::kThreads, P::kSmem, stream>>>(
        mw_blk, ma_blk, static_cast<float*>(acc_b), m, kq, u0, rows,
        u0 == 0);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// What the entries refuse: the arguments no instantiation takes.
bool bad_unfused(const void* a, const void* b, const void* y, const void* w,
                 int n, int m, int kq, long long ldy, int slab_rows,
                 int ldw) {
  return n <= 0 || m <= 0 || kq <= 0 || kq % 64 != 0 || ldy < m ||
         ldy % 16 != 0 || slab_rows <= 0 || slab_rows % 128 != 0 ||
         ldw < m + (m & 1) || ldw % 8 != 0 ||
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(w)) &
          15) != 0;
}

}  // namespace

// The bf16 route from 1024 packed values: a, b bf16 [n, kq], [m, kq], kq a
// multiple of 64, rows zero-padded past the factors; y u8 [>= n rows, ldy
// >= m], ldy and every base 16-byte aligned; outputs f32 [n, kq] and
// [m, kq]; w the scratch of W's slab, bf16 [slab_rows, ldw] (slab_rows a
// multiple of 128, ldw a multiple of 8 past m). Returns the cudaError_t of
// the launches (0 = success).
extern "C" int hpf_dense_unfused_bf16(const void* a, const void* b,
                                      const void* y, void* acc_a,
                                      void* acc_b, void* w, int n, int m,
                                      int kq, long long ldy, int slab_rows,
                                      int ldw, void* stream) {
  if (bad_unfused(a, b, y, w, n, m, kq, ldy, slab_rows, ldw))
    return (int)cudaErrorInvalidValue;
  return launch_unfused<1, 3>(a, b, y, acc_a, acc_b, w, n, m, kq, ldy,
                              slab_rows, ldw,
                              static_cast<cudaStream_t>(stream));
}

// The f32 route from 1024 packed values: a, b the three bf16 pieces of the
// packed f32 rows, [3, n, kq] and [3, m, kq]; w [3, slab_rows, ldw] bf16;
// the rest as hpf_dense_unfused_bf16.
extern "C" int hpf_dense_unfused_f32(const void* a, const void* b,
                                     const void* y, void* acc_a, void* acc_b,
                                     void* w, int n, int m, int kq,
                                     long long ldy, int slab_rows, int ldw,
                                     void* stream) {
  if (bad_unfused(a, b, y, w, n, m, kq, ldy, slab_rows, ldw))
    return (int)cudaErrorInvalidValue;
  return launch_unfused<kPieces, 2>(a, b, y, acc_a, acc_b, w, n, m, kq, ldy,
                                    slab_rows, ldw,
                                    static_cast<cudaStream_t>(stream));
}
