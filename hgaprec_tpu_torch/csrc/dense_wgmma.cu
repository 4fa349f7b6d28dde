// Fused dense CAVI sweep for Hopper (sm_90a) on the tensor cores: wgmma
// products on TMA-fed tiles, bound to Python with ctypes
// (ops/dense_fused.py). Two kernels replace the TPU kernel
// hgaprec_tpu/ops/dense_pallas.py::_kernel, whose three products all run on
// the TPU's matrix unit (dense_pallas.py:72, 86-87):
//   * dense_wgmma_kernel, its bf16 mode ("default" precision);
//   * dense_split_kernel, its f32 mode ("highest", the default precision
//     of ModelConfig and the CLI) for packed rows up to 128 values (K <= 128,
//     K <= 126 with bias): f32-accurate products from three bf16 pieces, on
//     the same machinery (see "The f32 route" below). csrc/dense_simt.cu
//     takes wider f32 rows.
//
// The bf16 route. For a uint8 count matrix
// Y [N, M] (row stride ldy) and packed factor rows a = [A | ba | 1] bf16
// [N, kq], b = [B | 1 | bb] bf16 [M, kq]:
//
//     S = a b^T,   W = bf16(Y * rcp(max(S, 1e-30))),
//     acc_a = W b   f32 [N, kq],      acc_b = W^T a   f32 [M, kq].
//
// The reciprocal is the hardware's approximate one (rcp.approx.ftz), as the
// TPU kernel's pl.reciprocal(approx=True) (dense_pallas.py:79-82).
//
// Bound on the H100: the two deterministic roles below do 8 N M kq FLOPs
// (both recompute S) against two reads of Y, about 400 FLOPs per byte of Y
// at K = 100, above the card's ~295 bf16 FLOPs per byte: the products bound
// it, at 989 TFLOP/s. The design puts all four products on wgmma (the only
// route to that rate) and keeps the tensor cores fed from a TMA ring:
//   * Roles (csrc/dense_roles.cuh, shared with csrc/dense_simt.cu):
//     item-stationary CTAs own acc_b rows, user-stationary CTAs own acc_a
//     rows; no atomics, so two launches give the same bits. A CTA holds 128
//     stationary rows X (two consumer warpgroups of 64) and sweeps its
//     chunk of moving tiles Z of kTc rows (64; 16 where kq > 128, for
//     registers), with the matching Y tile.
//   * Per moving tile, each consumer warpgroup runs, like FlashAttention-3's
//     forward loop without the softmax:
//       S = X Z^T   wgmma SS: X and Z in shared memory, both K-major;
//       W           from the S accumulator in registers, Y read from the
//                   shared tile at each accumulator element's (row, col);
//       acc += W Z  wgmma RS: A = W, the f32 pairs of S converted in place
//                   to bf16x2 A fragments; B = the same shared Z tile read
//                   through an MN-major descriptor. One copy of Z serves
//                   both products.
//     The S product of tile t + 1 and the contraction of tile t are issued
//     back to back; W(t + 1) is formed, into a second set of fragments,
//     while the contraction still runs (FA3's intra-warpgroup overlap).
//     The two consumer warpgroups run unsynchronised: FA3's ping-pong (named
//     barriers that give them turns on the tensor cores) measured no faster
//     here, and is not used.
//   * One producer warp issues every load with TMA into a ring of kStages
//     (Z tile + Y tile) stages, full/empty mbarriers between it and the
//     consumers; setmaxnreg moves registers from the producer warpgroup to
//     the consumers.
//
// How each hazard of the design was handled:
//   1. Row width. kq = 112 (K = 100) rows are 224 bytes, not a multiple of
//      the 128-byte swizzle atom. The tiles are staged as 128-byte-swizzled
//      k-blocks of 64 values, which both the K-major and the MN-major view
//      of Z read without bank conflicts; the tensor maps take the true
//      width, so TMA zero-fills the last block's 16 missing columns, and the
//      products run at the true width (seven k-steps for S, n = 112 for the
//      contraction). Padding the rows to 128 instead computes 14% more and
//      measured slower at Netflix shape (PERF.md, section 6). The wrapper
//      pads K to 64, 112, 128 or 256 values; chip_smoke.py checks the
//      kq = 128 instantiation bitwise against kq = 112 on zero-padded rows.
//   2. TMA for Y. The Y tensor maps take the true N and M as extents, so
//      TMA zero-fills the ragged edge (no byte masking), and need a row
//      stride and base that are multiples of 16 bytes: the Trainer's
//      layouts are (data/device.py, dense_count_matrix). The wrapper raises
//      a ValueError on any other Y; there is no byte-load fallback.
//   3. Tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//      reached through the runtime's driver entry point (no -lcuda), and
//      passed as __grid_constant__ kernel parameters.
//   4. The W stage widens the u8 counts with one prmt and a magic-number
//      subtract (no I2F) and takes rcp.approx, not a divide. A
//      warp-uniform skip of the reciprocals where Y is zero (about half of
//      a warp's column groups at 1% density; bitwise the same W) measured
//      slower than computing them all, and is not used.
//   5. Registers and wgmma serialization. ptxas serializes every wgmma
//      (an arrive-wait pair around each) when an accumulator or A fragment
//      is spilled, copied or touched while a product may be in flight, or
//      when a product is in flight across a branch or the loop's back
//      edge. So: 64-row moving tiles at kq <= 128 (S 32 f32 per thread,
//      acc 64, two sets of W fragments of 16), the tile loop unrolled by
//      two so that the fragment sets alternate instead of being copied,
//      the last tile peeled off, every product retired inside its
//      iteration, the Y reads as ld.shared at offsets split into a
//      per-thread part and immediates (generic 64-bit addressing spilled),
//      and the warpgroup index through a shuffle so that ptxas keeps the X
//      descriptors in uniform registers. At kq = 256 acc alone is 128
//      registers, so the moving tile shrinks to 16 rows; ptxas still
//      serializes that instantiation (C7512), which is off the main path
//      (K > 126). ptxas (-v in the build flags) reports no spills for any
//      instantiation; chip_smoke.py fails if it does.
//
// Stage probe (kernel #3, csrc/dense_roles.cuh's Stage): the kernel takes
// the stage as a template parameter, built for every stage at kq = 112
// only (K = 100) and launched through hpf_dense_wgmma_probe_bf16;
// hpf_dense_wgmma_bf16 launches kProd, so the probe's prod is this kernel.
// kBf16Recip forms W as bf16x2 (h2rcp, one bf16 multiply); kNoRecip keeps
// the prmt widen and drops the reciprocal and the multiply; kNoYLoad
// issues no Y TMA (the full barrier then expects only the Z tile's bytes)
// and no Y read from shared memory; kMmOnly issues only the S products,
// one group in flight per warpgroup (issue, wait, fold S * 0 into acc),
// and no contraction. Every stage builds without spills and without the
// serialization warnings of hazard 5 (chip_smoke.py checks both): a stage
// that serialized would measure the serialization, not its stage.
//
// The f32 route (dense_split_kernel). The same function as
// csrc/dense_simt.cu, W = Y / max(S, 1e-30) with the IEEE divide (the TPU
// kernel's w = y / sc, dense_pallas.py:84), acc_a = W B, acc_b = W^T A,
// every product f32-accurate. Each f32 value x is split into bf16 pieces
// x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), each difference
// exact in f32 and x - (x1 + x2 + x3) below 2^-27 |x|; a product of two
// split operands is the six bf16 products (1,1), (1,2), (2,1), (1,3),
// (3,1), (2,2), which leave out only terms below 2^-24 of it (tests pin
// 2^-20 per multiply-add; an f32 sum of K = 100 terms may carry 6.0e-6).
//   * Bound on the H100: the 6 products of each of the roles' 8 N M kq
//     FLOPs at 989 TFLOP/s, 165 TFLOP/s of f32-accurate multiply-adds: a
//     floor of 46.4 ms at Netflix shape and kq = 112, against 101.9 ms for
//     the same work on the FP32 pipes at 67 TFLOP/s (csrc/dense_simt.cu).
//   * Pieces. ops/dense_fused.py writes the three piece tables of A and B
//     once per sweep ([3, rows, kq] bf16, torch ops); 3-D tensor maps load
//     one piece per box. W is formed in f32 from the S accumulator with the
//     shared IEEE-divide fast path (quotient, csrc/dense_roles.cuh; never
//     rcp.approx, no divide call: a call makes ptxas serialize every wgmma)
//     and split into three sets of A fragments in registers. The six
//     products of S are SS wgmma on the X and Z pieces, those of the
//     contraction RS on W's pieces and the Z pieces read MN-major: one copy
//     of each Z piece serves both, as on the bf16 route. Pairs are issued
//     smallest first.
//   * Budget at kq = 112 and 128: the stationary pieces take 96 KB of
//     shared memory, a (3 Z pieces + Y) stage 56 KB, so the ring holds 2
//     stages (208 KB in all; 4 at kq = 64). ptxas allocates registers for
//     the launch bounds and not for setmaxnreg: a CTA of nine warps or
//     more (the bf16 kernel's 384 threads, or 288 with a producer warp)
//     gets at most 168 a thread, and the split loop spilled there. So the
//     CTA is the two consumer warpgroups alone (256 threads, up to 255
//     registers; the production loop takes 188 at kq = 112), and the ring
//     is refilled from inside them: when both warpgroups have released a
//     stage, the leader that finds it so loads the tile two ahead into it
//     (SplitLoader). Each warpgroup runs a tile in order: S (32
//     registers), W split into its three fragment sets (48), then the
//     contraction in column chunks of at most 64 (64 and 48 at kq = 112;
//     one chunk's accumulator, at most 32), each retired and promoted
//     into the f32 sums (kq / 2) before the next. The two warpgroups run
//     unsynchronised, so one's W stage and waits overlap the other's
//     products. Keeping the contraction of tile t and S of tile t + 1 in
//     flight together (FA3's overlap) was no faster on the card, and is
//     not used.
//   * Promotion. The tensor cores' adder truncates, so an accumulator that
//     summed a whole moving chunk (up to 7,500 tiles at Netflix shape)
//     would drift by up to one ulp per product. Each chunk of a tile's
//     contraction starts from zero and is added to the f32 sums after it
//     retires: a wgmma accumulator never sums more than one tile's 24
//     products.
//   * Widths 64, 112 and 128; the stages of the probe at kq = 112 (prod,
//     norecip, noyload, mmonly; bf16recip has no meaning in f32). Y comes
//     by TMA as on the bf16 route, so its row stride and base must be
//     multiples of 16 bytes (the wrapper raises ValueError otherwise).
//     ptxas reports no spills and no serialization for any instantiation
//     (chip_smoke.py checks the build log). The bf16 kernel above is not
//     touched by any of this: its machine code is the same instruction for
//     instruction (chip_smoke.py checks it against the recorded digests).

#include <cuda.h>   // CUtensorMap and its enums only; the driver call is
                    // reached through cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_roles.cuh"

namespace {

constexpr int kX = 128;          // stationary rows per CTA
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreadsW = 384;   // and one producer warpgroup
constexpr int kStages = 4;       // depth of the (Z, Y) ring

// Shared-memory plan for width kKq (k-blocks of 64 values, the last one
// zero-filled past kKq): the stationary tile, then
// kStages of (Z tile, Y tile), then the mbarriers. Every region starts on
// a 1024-byte boundary, the period of the 128-byte swizzle.
template <int kKq>
struct Plan {
  static constexpr int kTc = kKq <= 128 ? 64 : 16;    // moving rows per tile
  static constexpr int kBox = kTc < 64 ? kTc : 64;   // rows per factor TMA box
  static constexpr int kBlocks = (kKq + 63) / 64;     // 128-byte k-blocks
  static constexpr int kXBytes = kX * kBlocks * 128;
  static constexpr int kZBlock = kTc * 128;           // one k-block of Z
  static constexpr int kZBytes = kTc * kBlocks * 128;
  static constexpr int kYBytes = kTc * kX;            // uint8
  static constexpr int kStageBytes = kZBytes + kYBytes;
  static constexpr int kBarOff = kXBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOff + (2 * kStages + 1) * 8;
  // contraction products: N = kAccN columns of acc each, kAccChunks of them
  static constexpr int kAccN = kKq < 128 ? kKq : 128;
  static constexpr int kAccChunks = kKq / kAccN;
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed. A wait of more than
// 2^35 cycles (~17 s) can only be a lost arrival: trap, so that the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// 2-D TMA load of one box at (c0 = column, c1 = row), completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous products that own these registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x N] (+)= A B: m64nNk16, bf16 inputs, f32 accumulators, N / 2 per
// thread. SS: A and B from shared memory (both K-major), scale_d = 0
// overwrites D. RS: A from registers (four bf16x2 per thread), B MN-major.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n"
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
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the W stage ---------------------------------------------------------

// byte `sel & 3` of v as an exact f32: prmt builds 0x4B0000yy = 2^23 + y
__device__ __forceinline__ float widen_u8(uint32_t v, uint32_t sel) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, sel)) - 8388608.f;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// W = bf16(Y * rcp(max(S, 1e-30))) for this thread's accumulator elements,
// straight into wgmma A fragments (FlashAttention-3's P V trick): element
// (j, h, e) of S sits at row x + 8 h, column 8 j + 2 q + e, register
// 4 j + 2 h + e, and the pair e = 0, 1 becomes one bf16x2. The Y tile at
// shared address ys is as TMA swizzled it: 16-byte chunk c of row r sits at
// chunk c ^ (r % 8) (128-byte rows), c ^ ((r / 2) % 4) (64-byte rows) or c
// (16-byte rows). The offsets are split so that what varies with j is an
// immediate and the rest is fixed per thread.
template <bool kItem, int kTc, int kStage>
__device__ __forceinline__ void make_w_role(uint32_t (&wf)[kTc / 16][4],
                                            const float (&sacc)[kTc / 2],
                                            uint32_t ys, uint32_t x,
                                            uint32_t q) {
#pragma unroll
  for (int j = 0; j < kTc / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0, y1;
      if constexpr (!stage_reads_y(kStage)) {
        y0 = y1 = 1.f;
      } else if constexpr (!kItem) {
        // Y [x = user][z = item], kTc bytes a row; the pair is two
        // neighbouring bytes of row x + 8 h, which shares row x's key
        const uint32_t key = ((x * kTc) >> 3) & (kTc - 16);
        const uint32_t v =
            lds_u16(ys + (x + 8 * h) * kTc + 2 * q + 8 * (j % 2) +
                    ((16 * (j / 2)) ^ key));
        y0 = widen_u8(v, 0x7440);
        y1 = widen_u8(v, 0x7441);
      } else {
        // Y [z = user][x = item], 128 bytes a row: rows z = 8 j + 2 q + e,
        // whose row bits are 2 q + e
        const uint32_t col = x + 8 * h;
        y0 = widen_u8(lds_u8(ys + (8 * j + 2 * q) * kX +
                             (col ^ ((2 * q) << 4))), 0x7440);
        y1 = widen_u8(lds_u8(ys + (8 * j + 2 * q + 1) * kX +
                             (col ^ ((2 * q + 1) << 4))), 0x7440);
      }
      const float s0 = sacc[4 * j + 2 * h], s1 = sacc[4 * j + 2 * h + 1];
      uint32_t w;
      if constexpr (kStage == kProd) {
        w = pack_bf16x2(y0 * rcp_approx(fmaxf(s0, 1e-30f)),
                        y1 * rcp_approx(fmaxf(s1, 1e-30f)));
      } else if constexpr (kStage == kBf16Recip) {
        const __nv_bfloat162 r =
            h2rcp(__floats2bfloat162_rn(fmaxf(s0, 1e-30f), fmaxf(s1, 1e-30f)));
        const __nv_bfloat162 v = __hmul2(__floats2bfloat162_rn(y0, y1), r);
        w = *reinterpret_cast<const uint32_t*>(&v);
      } else {   // kNoRecip: W = Y; kNoYLoad: W = 1; S kept in use
        w = pack_bf16x2(fmaf(s0, 0.f, y0), fmaf(s1, 0.f, y1));
      }
      wf[j / 2][(j % 2) * 2 + h] = w;
    }
  }
}

// S = X Z^T into sacc: X (descriptor dx) and the Z tile at shared address
// zs, both K-major; k-steps of 16 (32 bytes) inside each 128-byte k-block,
// k-blocks kX * 128 (X) and kZBlock (Z) bytes apart, 8-row groups 1024
// bytes apart. Committed as one group, not waited on.
template <int kKq>
__device__ __forceinline__ void issue_s(float (&sacc)[Plan<kKq>::kTc / 2],
                                        uint64_t dx, uint32_t zs) {
  const uint64_t dz = desc_sw128(zs, 1, 64);
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKq / 16; ++ks) {
    const uint32_t koff = (ks % 4) * 32;
    wgmma_ss<Plan<kKq>::kTc>(
        sacc, dx + (((ks / 4) * kX * 128 + koff) >> 4),
        dz + (((ks / 4) * Plan<kKq>::kZBlock + koff) >> 4), ks > 0);
  }
  wgmma_commit();
}

// acc += W Z for the Z tile at shared address zs: A = the W fragments,
// B = Z read MN-major, 16 moving rows (2048 bytes) per k-step, columns 64
// apart one k-block (kZBlock bytes) apart. Committed, not waited on.
template <int kKq>
__device__ __forceinline__ void issue_c(
    float (&acc)[Plan<kKq>::kAccChunks][Plan<kKq>::kAccN / 2],
    const uint32_t (&wf)[Plan<kKq>::kTc / 16][4], uint32_t zs) {
  using P = Plan<kKq>;
  const uint64_t dz = desc_sw128(zs, P::kZBlock / 16, 64);
#pragma unroll
  for (int c = 0; c < P::kAccChunks; ++c) fence_regs(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int zk = 0; zk < P::kTc / 16; ++zk)
#pragma unroll
    for (int c = 0; c < P::kAccChunks; ++c)
      wgmma_rs<P::kAccN>(
          acc[c], wf[zk],
          dz + ((zk * 2048 + c * (P::kAccN / 64) * P::kZBlock) >> 4));
  wgmma_commit();
}

template <int kTc, int kStage>
__device__ __forceinline__ void make_w(bool item, uint32_t (&wf)[kTc / 16][4],
                                       const float (&sacc)[kTc / 2],
                                       uint32_t ys, uint32_t x, uint32_t q) {
  if (item)
    make_w_role<true, kTc, kStage>(wf, sacc, ys, x, q);
  else
    make_w_role<false, kTc, kStage>(wf, sacc, ys, x, q);
}

// The (Z, Y) ring: tile t sits in stage t % kStages (Z tile, then Y tile);
// the full barriers of the stages, then their empty barriers, from bars.
template <int kKq>
struct Ring {
  uint32_t base, bars;
  __device__ __forceinline__ uint32_t zs(int t) const {
    return base + (t % kStages) * Plan<kKq>::kStageBytes;
  }
  __device__ __forceinline__ uint32_t ys(int t) const {
    return zs(t) + Plan<kKq>::kZBytes;
  }
  __device__ __forceinline__ uint32_t full(int t) const {
    return bars + 8 * (t % kStages);
  }
  __device__ __forceinline__ void wait_full(int t) const {
    mbar_wait(full(t), (t / kStages) & 1);
  }
  // the producer, before loading tile t >= kStages: the consumers have
  // released tile t - kStages
  __device__ __forceinline__ void wait_empty(int t) const {
    mbar_wait(bars + 8 * (kStages + t % kStages), ((t / kStages) + 1) & 1);
  }
  __device__ __forceinline__ void release(int t) const {
    mbar_arrive(bars + 8 * (kStages + t % kStages));
  }
};

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&w)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(w[i][e])::"memory");
}

// Tile t, not the last: the S product of tile t + 1 and the contraction of
// tile t (W(t) in wcur) go to the tensor cores back to back; once S(t + 1)
// retires, W(t + 1) is formed into wnext while the contraction still runs
// (FlashAttention-3's intra-warpgroup overlap). Both retire, and tile t's
// stage is released, before it returns.
template <int kKq, int kStage>
__device__ __forceinline__ void tile_step(
    int t, float (&acc)[Plan<kKq>::kAccChunks][Plan<kKq>::kAccN / 2],
    float (&sacc)[Plan<kKq>::kTc / 2],
    uint32_t (&wcur)[Plan<kKq>::kTc / 16][4],
    uint32_t (&wnext)[Plan<kKq>::kTc / 16][4], uint64_t dx,
    const Ring<kKq>& ring, bool item, uint32_t xrow, uint32_t q) {
  ring.wait_full(t + 1);
  issue_s<kKq>(sacc, dx, ring.zs(t + 1));
  fence_frags(wcur);
  issue_c<kKq>(acc, wcur, ring.zs(t));
  wgmma_wait<1>();   // S(t + 1) has retired; the contraction may not have
  fence_regs(sacc);
  make_w<Plan<kKq>::kTc, kStage>(item, wnext, sacc, ring.ys(t + 1), xrow,
                                 q);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < Plan<kKq>::kAccChunks; ++c) fence_regs(acc[c]);
  fence_frags(wcur);
  ring.release(t);
}

// The last tile's contraction (W in w), waited on.
template <int kKq>
__device__ __forceinline__ void last_tile(
    float (&acc)[Plan<kKq>::kAccChunks][Plan<kKq>::kAccN / 2],
    uint32_t (&w)[Plan<kKq>::kTc / 16][4], uint32_t zs) {
  fence_frags(w);
  issue_c<kKq>(acc, w, zs);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < Plan<kKq>::kAccChunks; ++c) fence_regs(acc[c]);
}

// kMmOnly: the S products of every tile and nothing else, one group in
// flight (issued, waited on, then S * 0 added to acc, so that the outputs
// depend on S and stay zero); nothing is in flight across the loop's back
// edge.
template <int kKq>
__device__ __forceinline__ void s_only(
    int ntiles, float (&acc)[Plan<kKq>::kAccChunks][Plan<kKq>::kAccN / 2],
    float (&sacc)[Plan<kKq>::kTc / 2], uint64_t dx, const Ring<kKq>& ring) {
  static_assert(Plan<kKq>::kTc <= Plan<kKq>::kAccN, "S * 0 lands in acc[0]");
  for (int t = 0; t < ntiles; ++t) {
    ring.wait_full(t);
    issue_s<kKq>(sacc, dx, ring.zs(t));
    wgmma_wait<0>();
    fence_regs(sacc);
#pragma unroll
    for (int i = 0; i < Plan<kKq>::kTc / 2; ++i)
      acc[0][i] = fmaf(sacc[i], 0.f, acc[0][i]);
    ring.release(t);
  }
}

// ---- the kernel ----------------------------------------------------------

template <int kKq, int kStage = kProd>
__global__ void __launch_bounds__(kThreadsW, 1)
dense_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_yu,
                   const __grid_constant__ CUtensorMap map_yi,
                   float* __restrict__ acc_a, float* __restrict__ acc_b,
                   float* __restrict__ part_a, float* __restrict__ part_b,
                   int n, int m, int split_a, int split_b) {
  using P = Plan<kKq>;
  constexpr int kTc = P::kTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t xs = smem_u32(base);          // stationary tile
  const uint32_t bars = xs + P::kBarOff;       // full[], empty[], x
  const Ring<kKq> ring{xs + P::kXBytes, bars};
  const uint32_t xbar = bars + 16 * kStages;

  const Role role = role_of<kX, kTc>(n, m, kKq, split_a, split_b, acc_a,
                                     acc_b, part_a, part_b);
  const int ntiles = (role.z_end - role.z_begin + kTc - 1) / kTc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                          // full
      mbar_init(bars + 8 * (kStages + s), kConsumers);     // empty
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring full -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid != kConsumers) return;
    const CUtensorMap* mx = role.item ? &map_b : &map_a;
    const CUtensorMap* mz = role.item ? &map_a : &map_b;
    mbar_expect_tx(xbar, P::kXBytes);
    for (int b = 0; b < P::kBlocks; ++b)
      for (int r = 0; r < kX; r += P::kBox)
        tma_load(xs + b * kX * 128 + r * 128, mx, 64 * b, role.x0 + r, xbar);
    for (int t = 0; t < ntiles; ++t) {
      if (t >= kStages) ring.wait_empty(t);
      const uint32_t full = ring.full(t), zs = ring.zs(t);
      const int z0 = role.z_begin + t * kTc;
      // a stage that reads no Y must not expect its bytes, or the
      // consumers would wait forever
      mbar_expect_tx(full, stage_reads_y(kStage) ? P::kStageBytes
                                                 : P::kZBytes);
      for (int b = 0; b < P::kBlocks; ++b)
        for (int r = 0; r < kTc; r += P::kBox)
          tma_load(zs + b * P::kZBlock + r * 128, mz, 64 * b, z0 + r, full);
      if constexpr (stage_reads_y(kStage)) {
        if (role.item)   // Y tile [z = users][x = items]
          tma_load(ring.ys(t), &map_yi, role.x0, z0, full);
        else             // Y tile [x = users][z = items]
          tma_load(ring.ys(t), &map_yu, z0, role.x0, full);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 g .. 64 g + 63 of the CTA's tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  // the warpgroup index through a shuffle: ptxas then knows it is uniform
  // across the warp and keeps what derives from it (the X descriptors) in
  // uniform registers
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  // accumulator element (j, h, e) of an m64nN product sits at row
  // r0 + 8 h, column 8 j + 2 q + e, register 4 j + 2 h + e
  const uint32_t r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  const bool item = role.item;
  const uint32_t xa = xs + g * 64 * 128;

  float sacc[kTc / 2];
  float acc[P::kAccChunks][P::kAccN / 2];
  uint32_t wf[kTc / 16][4];   // W as wgmma A fragments, per 16 moving rows
  uint32_t wn[kTc / 16][4];   // the next tile's, formed while wf is in use
#pragma unroll
  for (int i = 0; i < kTc / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < P::kAccChunks; ++c)
#pragma unroll
    for (int i = 0; i < P::kAccN / 2; ++i) acc[c][i] = 0.f;

  const uint64_t dx = desc_sw128(xa, 1, 64);   // this warpgroup's X rows

  // Tile 0's S and W, then tile_step per tile (S of the next tile, the
  // contraction of this one, W of the next) and the last tile's
  // contraction peeled off, so that no branch sits around a product in
  // flight: otherwise ptxas serializes every wgmma (C7514, C7515).
  const uint32_t xrow = 64 * g + r0;
  mbar_wait(xbar, 0);
  if constexpr (kStage == kMmOnly) {
    s_only<kKq>(ntiles, acc, sacc, dx, ring);
  } else {
    if (ntiles > 0) {
      ring.wait_full(0);
      issue_s<kKq>(sacc, dx, ring.zs(0));
      wgmma_wait<0>();
      fence_regs(sacc);
      make_w<kTc, kStage>(item, wf, sacc, ring.ys(0), xrow, q);
    }
    // W(t) sits in wf for even t, in wn for odd t: the loop is unrolled by
    // two so that the fragments in flight are never copied.
    int t = 0;
    for (; t + 2 < ntiles; t += 2) {
      tile_step<kKq, kStage>(t, acc, sacc, wf, wn, dx, ring, item, xrow, q);
      tile_step<kKq, kStage>(t + 1, acc, sacc, wn, wf, dx, ring, item, xrow,
                             q);
    }
    if (t + 1 < ntiles) {
      tile_step<kKq, kStage>(t, acc, sacc, wf, wn, dx, ring, item, xrow, q);
      last_tile<kKq>(acc, wn, ring.zs(t + 1));
    } else if (t < ntiles) {
      last_tile<kKq>(acc, wf, ring.zs(t));
    }
  }

  const int nx = item ? m : n;
#pragma unroll
  for (int c = 0; c < P::kAccChunks; ++c) {
#pragma unroll
    for (int i = 0; i < P::kAccN / 2; i += 2) {
      const int row = role.x0 + 64 * g + r0 + 8 * ((i / 2) % 2);
      const int col = c * P::kAccN + 8 * (i / 4) + 2 * q;
      if (row < nx)
        *reinterpret_cast<float2*>(role.out + (long long)row * kKq + col) =
            make_float2(acc[c][i], acc[c][i + 1]);
    }
  }
}

// ---- the f32 route: split products on wgmma -------------------------------
//
// dense_split_kernel computes the f32 function of csrc/dense_simt.cu on the
// tensor cores (see the note at the top of the file). Each factor x is
// held as three bf16 pieces, x1 = bf16(x), x2 = bf16(x - x1),
// x3 = bf16(x - x1 - x2) (each difference exact in f32), and a product of
// two split operands is the six bf16 products whose pieces' exponents sum
// to at most 4 (1-based): the terms dropped are below 2^-24 of it.

constexpr int kPieces = 3;
constexpr int kPairs = 6;
constexpr int kMaxSmem = 232448;   // shared memory one CTA may opt in to
// two consumer warpgroups and no producer warp: eight warps leave ptxas up
// to 255 registers a thread (a ninth caps them at 168)
constexpr int kThreadsSplit = kConsumers;

// The six (X or W piece, Z piece) pairs, 0-based, smallest first: the
// tensor cores' adder truncates each sum to the accumulator's largest
// term, so the small products are summed among themselves before the
// large one arrives.
__host__ __device__ constexpr int pair_x(int p) {
  return p == 0 ? 1 : p == 1 ? 2 : p == 2 ? 0 : p == 3 ? 1 : 0;
}
__host__ __device__ constexpr int pair_z(int p) {
  return p == 0 ? 1 : p == 1 ? 0 : p == 2 ? 2 : p == 3 ? 0 : p == 4 ? 1 : 0;
}

// Shared-memory plan of the split kernel at width kKq <= 128: the three
// pieces of the stationary tile, then kStages of (three Z pieces, Y tile),
// then the mbarriers, each region on a 1024-byte boundary. The ring is as
// deep as the shared memory allows, at most 4: 2 at kq = 112 and 128.
template <int kKq>
struct SplitPlan {
  static_assert(kKq <= 128, "one contraction product per k-step");
  static constexpr int kTc = 64;                        // moving rows per tile
  static constexpr int kBlocks = (kKq + 63) / 64;       // 128-byte k-blocks
  static constexpr int kXPiece = kX * kBlocks * 128;    // one piece of X
  static constexpr int kZBlock = kTc * 128;             // one k-block of Z
  static constexpr int kZPiece = kTc * kBlocks * 128;   // one piece of Z
  static constexpr int kZBytes = kPieces * kZPiece;
  static constexpr int kYBytes = kTc * kX;              // uint8
  static constexpr int kStageBytes = kZBytes + kYBytes;
  static constexpr int kFree = kMaxSmem - 1024 - kPieces * kXPiece - 8;
  static constexpr int kStages =
      kFree / (kStageBytes + 24) < 4 ? kFree / (kStageBytes + 24) : 4;
  static constexpr int kBarOff = kPieces * kXPiece + kStages * kStageBytes;
  // the barriers, then one int per stage: the tile last loaded into it
  static constexpr int kClaimOff = kBarOff + (2 * kStages + 1) * 8;
  static constexpr int kSmem = 1024 + kClaimOff + 4 * kStages;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "the ring must fit");
};

// The (Z pieces, Y) ring of the split kernel: tile t in stage t % kStages.
template <int kKq>
struct SplitRing {
  using P = SplitPlan<kKq>;
  uint32_t base, bars;
  __device__ __forceinline__ uint32_t zs(int t) const {
    return base + (t % P::kStages) * P::kStageBytes;
  }
  __device__ __forceinline__ uint32_t ys(int t) const {
    return zs(t) + P::kZBytes;
  }
  __device__ __forceinline__ uint32_t full(int t) const {
    return bars + 8 * (t % P::kStages);
  }
  __device__ __forceinline__ void wait_full(int t) const {
    mbar_wait(full(t), (t / P::kStages) & 1);
  }
  __device__ __forceinline__ void wait_empty(int t) const {
    mbar_wait(bars + 8 * (P::kStages + t % P::kStages),
              ((t / P::kStages) + 1) & 1);
  }
  __device__ __forceinline__ uint32_t empty(int t) const {
    return bars + 8 * (P::kStages + t % P::kStages);
  }
};

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// 3-D TMA load of one box at (c0 = column, c1 = row, c2 = piece)
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Fills the ring from inside the consumer warpgroups (there is no
// producer warp): tile t's Z pieces and Y tile into stage t % kStages.
// Thread 0 loads the first kStages tiles; release() the rest.
template <int kKq, int kStage>
struct SplitLoader {
  using P = SplitPlan<kKq>;
  SplitRing<kKq> ring;
  const CUtensorMap *mz, *myu, *myi;
  bool item;
  int x0, z_begin;
  int* claims;   // per stage, the tile last loaded into it
  __device__ __forceinline__ void load(int t) const {
    const uint32_t full = ring.full(t), zs = ring.zs(t);
    const int z0 = z_begin + t * P::kTc;
    mbar_expect_tx(full, stage_reads_y(kStage) ? P::kStageBytes : P::kZBytes);
    for (int p = 0; p < kPieces; ++p)
      for (int b = 0; b < P::kBlocks; ++b)
        tma_load_3d(zs + p * P::kZPiece + b * P::kZBlock, mz, 64 * b, z0, p,
                    full);
    if constexpr (stage_reads_y(kStage)) {
      if (item)   // Y tile [z = users][x = items]
        tma_load(ring.ys(t), myi, x0, z0, full);
      else        // Y tile [x = users][z = items]
        tma_load(ring.ys(t), myu, z0, x0, full);
    }
  }
  // warpgroup g is done with tile t (every product on it retired): its
  // leader arrives on the stage's empty barrier (one arrival per
  // warpgroup); the leader that finds both arrived claims the stage and
  // loads tile t + kStages into it (the last to arrive always finds it;
  // the claim keeps the other from loading it twice)
  __device__ __forceinline__ void release(int t, int g, int ntiles) const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    if (threadIdx.x % 128 != 0) return;
    const uint32_t empty = ring.empty(t);
    mbar_arrive(empty);
    const int s = t % P::kStages;
    if (t + P::kStages < ntiles &&
        mbar_test(empty, (t / P::kStages) & 1) &&
        atomicCAS(claims + s, t, t + P::kStages) == t)
      load(t + P::kStages);
  }
};

// S = X Z^T from the pieces: per pair, X piece px (kXPiece bytes apart
// from dx) against Z piece pz of the tile at zs, k-steps as issue_s.
// Committed as one group, not waited on.
template <int kKq>
__device__ __forceinline__ void issue_s_split(float (&sacc)[32], uint64_t dx,
                                              uint32_t zs) {
  using P = SplitPlan<kKq>;
  const uint64_t dz = desc_sw128(zs, 1, 64);
  // dx through an opaque move, per call: otherwise ptxas hoists all 21 X
  // descriptors (3 pieces x 7 k-steps) out of the tile loop, runs out of
  // uniform registers and spills them
  asm volatile("mov.b64 %0, %0;" : "+l"(dx));
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int ks = 0; ks < kKq / 16; ++ks) {
      const uint32_t koff = (ks % 4) * 32;
      wgmma_ss<64>(
          sacc,
          dx + ((pair_x(p) * P::kXPiece + (ks / 4) * kX * 128 + koff) >> 4),
          dz + ((pair_z(p) * P::kZPiece + (ks / 4) * P::kZBlock + koff) >>
                4),
          p > 0 || ks > 0);
    }
  wgmma_commit();
}

// the m64n48k16 RS product: the contraction's chunks are 64 and 48 columns
// wide at kq = 112 (64 and 64 at kq = 128, one of 64 at kq = 64)
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, "
      "1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc += W Z[:, c0 : c0 + N] from the pieces: A = the fragments of W piece
// pw, B = Z piece pz read MN-major from column c0 (a multiple of 64, so a
// k-block boundary), as issue_c. Committed, not waited on.
template <int kKq, int N>
__device__ __forceinline__ void issue_c_split(
    float (&acc)[N / 2], const uint32_t (&wf)[kPieces][4][4], uint32_t zs,
    int c0) {
  using P = SplitPlan<kKq>;
  const uint64_t dz =
      desc_sw128(zs + (c0 / 64) * P::kZBlock, P::kZBlock / 16, 64);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int zk = 0; zk < 4; ++zk)
      wgmma_rs<N>(acc, wf[pair_x(p)][zk],
                  dz + ((pair_z(p) * P::kZPiece + zk * 2048) >> 4));
  wgmma_commit();
}

// W = y / b for b = max(S, 1e-30) >= 2^-100, with no call (a call in the
// kernel makes ptxas serialize every wgmma): quotient() where it is exact,
// below 2^100; above, the divisor is scaled by 2^-64 and the quotient by
// 2^-64 (both exact, but for a quotient below 2^-126, whose last bit may
// round twice); an infinite S gives 0.
__device__ __forceinline__ float w_of(float y, float b) {
  const bool big = !(b < 0x1p100f);
  const float q = quotient(y, big ? b * 0x1p-64f : b);
  return big ? (b == __int_as_float(0x7f800000) ? 0.f : q * 0x1p-64f) : q;
}

// The three bf16x2 pieces of the pair (lo, hi): p1 = bf16(v),
// p2 = bf16(v - p1), p3 = bf16(v - p1 - p2), each difference exact in f32.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p1,
                                       uint32_t& p2, uint32_t& p3) {
  p1 = pack_bf16x2(lo, hi);
  lo -= __uint_as_float(p1 << 16);
  hi -= __uint_as_float(p1 & 0xFFFF0000u);
  p2 = pack_bf16x2(lo, hi);
  lo -= __uint_as_float(p2 << 16);
  hi -= __uint_as_float(p2 & 0xFFFF0000u);
  p3 = pack_bf16x2(lo, hi);
}

// W for this thread's S elements, split into the A fragments of its three
// pieces. Element (j, h, e) of S and the Y tile's layout as in make_w_role
// (64-row moving tiles). kNoRecip: W = Y; kNoYLoad: W = 1 (S kept in use).
template <bool kItem, int kStage>
__device__ __forceinline__ void make_w_split_role(
    uint32_t (&wf)[kPieces][4][4], const float (&sacc)[32], uint32_t ys,
    uint32_t x, uint32_t q) {
  constexpr int kTc = 64;
#pragma unroll
  for (int j = 0; j < kTc / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0, y1;
      if constexpr (!stage_reads_y(kStage)) {
        y0 = y1 = 1.f;
      } else if constexpr (!kItem) {
        const uint32_t key = ((x * kTc) >> 3) & (kTc - 16);
        const uint32_t v =
            lds_u16(ys + (x + 8 * h) * kTc + 2 * q + 8 * (j % 2) +
                    ((16 * (j / 2)) ^ key));
        y0 = widen_u8(v, 0x7440);
        y1 = widen_u8(v, 0x7441);
      } else {
        const uint32_t col = x + 8 * h;
        y0 = widen_u8(lds_u8(ys + (8 * j + 2 * q) * kX +
                             (col ^ ((2 * q) << 4))), 0x7440);
        y1 = widen_u8(lds_u8(ys + (8 * j + 2 * q + 1) * kX +
                             (col ^ ((2 * q + 1) << 4))), 0x7440);
      }
      const float s0 = sacc[4 * j + 2 * h], s1 = sacc[4 * j + 2 * h + 1];
      float w0, w1;
      if constexpr (kStage == kProd) {
        w0 = w_of(y0, fmaxf(s0, 1e-30f));
        w1 = w_of(y1, fmaxf(s1, 1e-30f));
      } else {
        w0 = fmaf(s0, 0.f, y0);
        w1 = fmaf(s1, 0.f, y1);
      }
      const int f = (j % 2) * 2 + h;
      split3(w0, w1, wf[0][j / 2][f], wf[1][j / 2][f], wf[2][j / 2][f]);
    }
  }
}

template <int kStage>
__device__ __forceinline__ void make_w_split(bool item,
                                             uint32_t (&wf)[kPieces][4][4],
                                             const float (&sacc)[32],
                                             uint32_t ys, uint32_t x,
                                             uint32_t q) {
  if (item)
    make_w_split_role<true, kStage>(wf, sacc, ys, x, q);
  else
    make_w_split_role<false, kStage>(wf, sacc, ys, x, q);
}

template <int N>
__device__ __forceinline__ void fence_split(uint32_t (&w)[kPieces][N][4]) {
#pragma unroll
  for (int p = 0; p < kPieces; ++p) fence_frags(w[p]);
}

// Columns [c0, c0 + N) of tile t's contraction, promoted: the chunk's
// accumulator starts from zero, and once its products retire it is added
// to the f32 sums, so no wgmma accumulator sums more than one tile's 24
// products (the tensor cores' adder truncates: an accumulator that summed
// a whole moving chunk would drift by up to an ulp per product).
template <int kKq, int N>
__device__ __forceinline__ void contract_chunk(
    float (&sums)[kKq / 2], const uint32_t (&wf)[kPieces][4][4],
    uint32_t zs, int c0) {
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  issue_c_split<kKq, N>(acc, wf, zs, c0);
  wgmma_wait<0>();
  fence_regs(acc);
  // element i of the chunk is element i + c0 / 2 of the tile's row
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sums[c0 / 2 + i] += acc[i];
}

// One moving tile: S, W (split into wf), then the contraction in column
// chunks of at most 64, each retired before the next (registers: S 32,
// W's pieces 48, the sums kq / 2 and one chunk's accumulator at most 32),
// then the stage is released. Nothing is in flight across a branch or the
// loop's back edge.
template <int kKq, int kStage>
__device__ __forceinline__ void split_tile(
    int t, float (&sums)[kKq / 2], float (&sacc)[32],
    uint32_t (&wf)[kPieces][4][4], uint64_t dx,
    const SplitLoader<kKq, kStage>& ld, int g, int ntiles,
    bool item, uint32_t xrow, uint32_t q) {
  const SplitRing<kKq>& ring = ld.ring;
  ring.wait_full(t);
  issue_s_split<kKq>(sacc, dx, ring.zs(t));
  wgmma_wait<0>();
  fence_regs(sacc);
  make_w_split<kStage>(item, wf, sacc, ring.ys(t), xrow, q);
  fence_split(wf);
  contract_chunk<kKq, 64>(sums, wf, ring.zs(t), 0);
  if constexpr (kKq > 64)
    contract_chunk<kKq, kKq - 64>(sums, wf, ring.zs(t), 64);
  ld.release(t, g, ntiles);
}

// kMmOnly: the S products of every tile and nothing else, one group in
// flight, S * 0 added to the sums.
template <int kKq, int kStage>
__device__ __forceinline__ void s_only_split(
    int ntiles, float (&sums)[kKq / 2], float (&sacc)[32], uint64_t dx,
    const SplitLoader<kKq, kStage>& ld, int g) {
  for (int t = 0; t < ntiles; ++t) {
    ld.ring.wait_full(t);
    issue_s_split<kKq>(sacc, dx, ld.ring.zs(t));
    wgmma_wait<0>();
    fence_regs(sacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sums[i] = fmaf(sacc[i], 0.f, sums[i]);
    ld.release(t, g, ntiles);
  }
}

// Same grid, roles and consumer warpgroups as dense_wgmma_kernel, and no
// producer warp (SplitLoader); the factor tables are the pieces,
// [3, rows, kq] bf16, loaded through 3-D tensor maps.
template <int kKq, int kStage = kProd>
__global__ void __launch_bounds__(kThreadsSplit, 1)
dense_split_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_yu,
                   const __grid_constant__ CUtensorMap map_yi,
                   float* __restrict__ acc_a, float* __restrict__ acc_b,
                   float* __restrict__ part_a, float* __restrict__ part_b,
                   int n, int m, int split_a, int split_b) {
  using P = SplitPlan<kKq>;
  constexpr int kTc = P::kTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t xs = smem_u32(base);          // the stationary pieces
  const uint32_t bars = xs + P::kBarOff;       // full[], empty[], x
  const SplitRing<kKq> ring{xs + kPieces * P::kXPiece, bars};
  const uint32_t xbar = bars + 16 * P::kStages;

  const Role role = role_of<kX, kTc>(n, m, kKq, split_a, split_b, acc_a,
                                     acc_b, part_a, part_b);
  const int ntiles = (role.z_end - role.z_begin + kTc - 1) / kTc;
  const int tid = threadIdx.x;
  int* claims = reinterpret_cast<int*>(base + P::kClaimOff);
  const SplitLoader<kKq, kStage> ld{ring, role.item ? &map_a : &map_b,
                                    &map_yu, &map_yi, role.item, role.x0,
                                    role.z_begin, claims};
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                          // full
      mbar_init(bars + 8 * (P::kStages + s), 2);           // empty
      claims[s] = s;
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const CUtensorMap* mx = role.item ? &map_b : &map_a;
    mbar_expect_tx(xbar, kPieces * P::kXPiece);
    for (int p = 0; p < kPieces; ++p)
      for (int b = 0; b < P::kBlocks; ++b)
        for (int r = 0; r < kX; r += 64)
          tma_load_3d(xs + p * P::kXPiece + b * kX * 128 + r * 128, mx,
                      64 * b, role.x0 + r, p, xbar);
    for (int t = 0; t < P::kStages && t < ntiles; ++t) ld.load(t);
  }

  // ---- consumer warpgroups: rows 64 g .. 64 g + 63 of the CTA's tile ----
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const uint32_t r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  const bool item = role.item;

  float sacc[32];
  float sums[kKq / 2];   // the promoted sums of the tiles so far
  uint32_t wf[kPieces][4][4];   // W's pieces as A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKq / 2; ++i) sums[i] = 0.f;

  const uint64_t dx = desc_sw128(xs + g * 64 * 128, 1, 64);
  const uint32_t xrow = 64 * g + r0;
  mbar_wait(xbar, 0);
  if constexpr (kStage == kMmOnly) {
    s_only_split<kKq, kStage>(ntiles, sums, sacc, dx, ld, g);
  } else {
    for (int t = 0; t < ntiles; ++t)
      split_tile<kKq, kStage>(t, sums, sacc, wf, dx, ld, g, ntiles, item,
                              xrow, q);
  }

  const int nx = item ? m : n;
#pragma unroll
  for (int i = 0; i < kKq / 2; i += 2) {
    const int row = role.x0 + 64 * g + r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * q;
    if (row < nx)
      *reinterpret_cast<float2*>(role.out + (long long)row * kKq + col) =
          make_float2(sums[i], sums[i + 1]);
  }
}

// ---- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// row-major [rows, cols] at `row_bytes` per row, loaded in boxes of
// box_rows x box_cols; out-of-range elements load as zero
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               uint64_t cols, uint64_t rows, uint64_t row_bytes,
               uint32_t box_cols, uint32_t box_rows, CUtensorMapSwizzle sw) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                   unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kKq, int kStage = kProd>
int launch_wgmma(const void* a, const void* b, const void* y, void* acc_a,
                 void* acc_b, void* part_a, void* part_b, int n, int m,
                 long long ldy, int split_a, int split_b,
                 cudaStream_t stream) {
  using P = Plan<kKq>;
  constexpr int kTc = P::kTc;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ma, mb, myu, myi;
  if (!encode_2d(&ma, bf16, a, kKq, n, kKq * 2, 64, P::kBox, sw128) ||
      !encode_2d(&mb, bf16, b, kKq, m, kKq * 2, 64, P::kBox, sw128) ||
      !encode_2d(&myu, u8, y, m, n, ldy, kTc, kX,
                 kTc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&myi, u8, y, m, n, ldy, kX, kTc, sw128))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_wgmma_kernel<kKq, kStage>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_a = (n + kX - 1) / kX, tiles_b = (m + kX - 1) / kX;
  kernel<<<tiles_a * split_a + tiles_b * split_b, kThreadsW, P::kSmem,
           stream>>>(ma, mb, myu, myi, static_cast<float*>(acc_a),
                     static_cast<float*>(acc_b), static_cast<float*>(part_a),
                     static_cast<float*>(part_b), n, m, split_a, split_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(acc_a, acc_b, part_a, part_b, n, m, kKq, split_a,
                         split_b, stream);
}

// [3, rows, cols] bf16 pieces, row-major, loaded in 64 x 64 boxes of one
// piece with the 128-byte swizzle; out-of-range elements load as zero
bool encode_pieces(CUtensorMap* map, const void* ptr, uint64_t cols,
                   uint64_t rows) {
  const cuuint64_t dims[3] = {cols, rows, kPieces};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kKq, int kStage = kProd>
int launch_split(const void* a, const void* b, const void* y, void* acc_a,
                 void* acc_b, void* part_a, void* part_b, int n, int m,
                 long long ldy, int split_a, int split_b,
                 cudaStream_t stream) {
  using P = SplitPlan<kKq>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap ma, mb, myu, myi;
  if (!encode_pieces(&ma, a, kKq, n) || !encode_pieces(&mb, b, kKq, m) ||
      !encode_2d(&myu, u8, y, m, n, ldy, P::kTc, kX,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(&myi, u8, y, m, n, ldy, kX, P::kTc,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_split_kernel<kKq, kStage>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_a = (n + kX - 1) / kX, tiles_b = (m + kX - 1) / kX;
  kernel<<<tiles_a * split_a + tiles_b * split_b, kThreadsSplit, P::kSmem,
           stream>>>(ma, mb, myu, myi, static_cast<float*>(acc_a),
                     static_cast<float*>(acc_b), static_cast<float*>(part_a),
                     static_cast<float*>(part_b), n, m, split_a, split_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(acc_a, acc_b, part_a, part_b, n, m, kKq, split_a,
                         split_b, stream);
}

// What the entries refuse: the arguments no instantiation takes.
bool bad_args(const void* a, const void* b, const void* y,
              const void* part_a, const void* part_b, int n, int m,
              long long ldy, int split_a, int split_b) {
  return n <= 0 || m <= 0 || ldy < m || ldy % 16 != 0 || split_a < 1 ||
         split_b < 1 || (split_a > 1 && part_a == nullptr) ||
         (split_b > 1 && part_b == nullptr) ||
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(y)) & 15) != 0;
}

}  // namespace

// a: bf16 [n, kq], b: bf16 [m, kq] with kq in {64, 112, 128, 256}, rows zero-
// padded past the factors; y: u8 [>= n rows, ldy >= m], ldy and every base
// 16-byte aligned; outputs f32 [n, kq] and [m, kq]. split_a/split_b cut
// the user/item role's moving tiles into that many chunks; a role with
// split > 1 needs scratch part_* of f32 [split, rows, kq]. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int hpf_dense_wgmma_bf16(const void* a, const void* b,
                                    const void* y, void* acc_a, void* acc_b,
                                    void* part_a, void* part_b, int n, int m,
                                    int kq, long long ldy, int split_a,
                                    int split_b, void* stream) {
  if (bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kq) {
    case 64:
      return launch_wgmma<64>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                              ldy, split_a, split_b, st);
    case 112:
      return launch_wgmma<112>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                               ldy, split_a, split_b, st);
    case 128:
      return launch_wgmma<128>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                               ldy, split_a, split_b, st);
    case 256:
      return launch_wgmma<256>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                               ldy, split_a, split_b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The stage probe: the entry above at kq = 112 (K <= 110 zero-padded, the
// only width its stages are built for) with the kernel built for `stage`
// (0 = prod, 1 = bf16recip, 2 = norecip, 3 = noyload, 4 = mmonly; see
// csrc/dense_roles.cuh). Returns the cudaError_t of the launches.
extern "C" int hpf_dense_wgmma_probe_bf16(const void* a, const void* b,
                                          const void* y, void* acc_a,
                                          void* acc_b, void* part_a,
                                          void* part_b, int n, int m, int kq,
                                          long long ldy, int split_a,
                                          int split_b, int stage,
                                          void* stream) {
  if (kq != 112 ||
      bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kProd:
      return launch_wgmma<112, kProd>(a, b, y, acc_a, acc_b, part_a, part_b,
                                      n, m, ldy, split_a, split_b, st);
    case kBf16Recip:
      return launch_wgmma<112, kBf16Recip>(a, b, y, acc_a, acc_b, part_a,
                                           part_b, n, m, ldy, split_a,
                                           split_b, st);
    case kNoRecip:
      return launch_wgmma<112, kNoRecip>(a, b, y, acc_a, acc_b, part_a,
                                         part_b, n, m, ldy, split_a, split_b,
                                         st);
    case kNoYLoad:
      return launch_wgmma<112, kNoYLoad>(a, b, y, acc_a, acc_b, part_a,
                                         part_b, n, m, ldy, split_a, split_b,
                                         st);
    case kMmOnly:
      return launch_wgmma<112, kMmOnly>(a, b, y, acc_a, acc_b, part_a,
                                        part_b, n, m, ldy, split_a, split_b,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 route ("highest") up to 128 packed values: a, b: the three bf16
// pieces of the packed f32 factor rows, [3, n, kq] and [3, m, kq] with kq
// in {64, 112, 128}, rows zero-padded past the factors (ops/dense_fused.py
// writes them); y, outputs, splits and scratch as hpf_dense_wgmma_bf16.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int hpf_dense_split_f32(const void* a, const void* b,
                                   const void* y, void* acc_a, void* acc_b,
                                   void* part_a, void* part_b, int n, int m,
                                   int kq, long long ldy, int split_a,
                                   int split_b, void* stream) {
  if (bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kq) {
    case 64:
      return launch_split<64>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                              ldy, split_a, split_b, st);
    case 112:
      return launch_split<112>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                               ldy, split_a, split_b, st);
    case 128:
      return launch_split<128>(a, b, y, acc_a, acc_b, part_a, part_b, n, m,
                               ldy, split_a, split_b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 route's stage probe: the entry above at kq = 112 with the kernel
// built for `stage` (0 = prod, 2 = norecip, 3 = noyload, 4 = mmonly;
// 1 = bf16recip is a bf16 stage and is refused).
extern "C" int hpf_dense_split_probe_f32(const void* a, const void* b,
                                         const void* y, void* acc_a,
                                         void* acc_b, void* part_a,
                                         void* part_b, int n, int m, int kq,
                                         long long ldy, int split_a,
                                         int split_b, int stage,
                                         void* stream) {
  if (kq != 112 ||
      bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kProd:
      return launch_split<112, kProd>(a, b, y, acc_a, acc_b, part_a, part_b,
                                      n, m, ldy, split_a, split_b, st);
    case kNoRecip:
      return launch_split<112, kNoRecip>(a, b, y, acc_a, acc_b, part_a,
                                         part_b, n, m, ldy, split_a,
                                         split_b, st);
    case kNoYLoad:
      return launch_split<112, kNoYLoad>(a, b, y, acc_a, acc_b, part_a,
                                         part_b, n, m, ldy, split_a,
                                         split_b, st);
    case kMmOnly:
      return launch_split<112, kMmOnly>(a, b, y, acc_a, acc_b, part_a,
                                        part_b, n, m, ldy, split_a, split_b,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
