// Fused dense CAVI sweep for Hopper (sm_90a) on the tensor cores: wgmma
// products on TMA-fed tiles, bound to Python with ctypes
// (ops/dense_fused.py). Four kernels replace the TPU kernel
// hgaprec_tpu/ops/dense_pallas.py::_kernel, whose three products all run on
// the TPU's matrix unit (dense_pallas.py:72, 86-87):
//   * dense_wgmma_kernel, its bf16 mode ("default" precision) up to 256
//     packed values;
//   * dense_split_kernel, its f32 mode ("highest", the default precision
//     of ModelConfig and the CLI) for packed rows up to 128 values (K <= 128,
//     K <= 126 with bias): f32-accurate products from three bf16 pieces, on
//     the same machinery (see "The f32 route" below);
//   * dense_res_kernel, the wide rows whose stationary tile fits in shared
//     memory: f32 rows of 129-320 packed values, bf16 rows of 257-384 (see
//     "the resident design");
//   * dense_cluster_kernel, the same design on a thread-block cluster that
//     splits the row between its CTAs: built for f32 rows of 321-2560 and
//     bf16 rows of 385-3072, taken up to 960 (see "the cluster design" at
//     the end of the file); from 1024 values csrc/dense_unfused.cu's
//     unfused route takes both modes.
// dense_wide_kernel (see "wide rows") takes both modes at any width and
// csrc/dense_simt.cu the f32 mode up to 256 values on the FP32 pipes; no
// route takes either, and chip_smoke.py times the unfused route and the
// f32 routes against them.
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
#include "wgmma_common.cuh"

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

// two consumer warpgroups and no producer warp: eight warps leave ptxas up
// to 255 registers a thread (a ninth caps them at 168)
constexpr int kThreadsSplit = kConsumers;

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

template <int kKq, int kStage = kProd>
int launch_split(const void* a, const void* b, const void* y, void* acc_a,
                 void* acc_b, void* part_a, void* part_b, int n, int m,
                 long long ldy, int split_a, int split_b,
                 cudaStream_t stream) {
  using P = SplitPlan<kKq>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap ma, mb, myu, myi;
  if (!encode_packed(&ma, a, kKq, n, kPieces, 64, 1) ||
      !encode_packed(&mb, b, kKq, m, kPieces, 64, 1) ||
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

// ---- wide rows: the streamed design, on no route ---------------------------
//
// dense_wide_kernel takes packed rows of any width; no route sends it any
// (csrc/dense_unfused.cu takes the widest rows), and chip_smoke.py times
// the unfused route beside it. It took the rows wider than
// dense_cluster_kernel (below) holds: f32 rows past 2560 values, bf16 rows
// past 3072. Neither
// narrow kernel can hold them: a wgmma makes at most 256 output columns,
// the bf16 kernel's accumulator already takes 128 registers a thread at
// kq = 256, and the split kernel's resident stationary pieces (96 KB at
// kq = 128) would pass the 227 KB a block may use at kq = 320. It
// replaces the TPU kernel dense_pallas.py::_kernel at those widths, which
// the JAX package takes at any width (K padded to 128-lane multiples).
// At Netflix shape and K = 300 it would stage 4.9 (f32) and 3.4 (bf16)
// times the resident kernel's bytes (chip_smoke.py prints both plans). One template serves both routes: kP = 1 piece a
// factor (bf16, W = bf16(Y * rcp.approx(max(S, 1e-30))) as
// dense_wgmma_kernel forms it) or kP = 3 pieces (f32, W = Y / max(S,
// 1e-30) with the IEEE divide's fast path and six split products, as
// dense_split_kernel). Rows are zero-padded to a multiple of 64 values
// (whole 128-byte k-blocks).
//   * Grid: (role block, column window). The role blocks are
//     csrc/dense_roles.cuh's (blockIdx.x: stationary tile and split
//     chunk, two deterministic roles, reduce_splits for split > 1); the
//     window (blockIdx.y) is the output columns [kWn y, kWn y + kWn) of
//     the stationary rows, at most 256 for bf16 and 128 for f32.
//   * Per moving tile of 64 rows each CTA forms S = X Z^T over the full kq,
//     one k-block of 64 values at a time, with the stationary and the
//     moving k-blocks both streamed by TMA through the ring (the stationary
//     tile no longer stays resident), then W once, then contracts W into
//     its window's columns only, read as their own boxes of the moving
//     tile together with the Y tile. S is formed once per window: the
//     kernel issues 4 N M kq (nwin + 1) products (x 6 bf16 products on the
//     f32 route) where the function needs 6 N M K.
//   * Promotion. Each k-block's S products (4, x 6 on the f32 route) start
//     from zero and are added to the f32 S sums once retired; each 64-column
//     chunk of the contraction the same into the window's f32 sums. No wgmma
//     accumulator sums more than 24 products, so the tensor cores'
//     truncating adder does not drift over a wide row or a long moving
//     chunk.
//   * Ring. Each stage holds one item of a tile's sequence: kb = kq / 64
//     S items (the k-block's stationary and moving pieces), then one C item
//     (the window's moving k-blocks and Y). The CTA is the two consumer
//     warpgroups (256 threads, up to 255 registers a thread; see hazard 5
//     above and the split kernel's budget), and the ring is refilled from
//     inside them as in SplitLoader. Every product retires inside its item,
//     so nothing is in flight across a branch or the loop's back edge: the
//     k-block loop is a runtime loop and one instantiation per route serves
//     every width.
// Registers: the window's sums (kWn / 2), S's sums and one k-block's
// products (32 each) during S, W's fragments (16 kP) and one chunk's
// accumulator (32) after it: ptxas allocates 209 a thread on the bf16
// route and 179 on the f32 route, with no spills and no serialized wgmma
// (chip_smoke.py checks both).

namespace {

constexpr int kWideWnBf16 = 256;   // window columns, bf16 route
constexpr int kWideWnF32 = 128;    // window columns, f32 route

template <int kP>
__host__ __device__ constexpr int wide_pairs() {
  return kP == 1 ? 1 : kPairs;
}
template <int kP>
__host__ __device__ constexpr int wide_x(int p) {
  return kP == 1 ? 0 : pair_x(p);
}
template <int kP>
__host__ __device__ constexpr int wide_z(int p) {
  return kP == 1 ? 0 : pair_z(p);
}

// Shared-memory plan of the wide kernel: kStages stages of the larger item
// (S item: the stationary k-block's kP pieces, then the moving k-block's;
// C item: the window's moving k-blocks, kP pieces each, then the Y tile),
// then the full and empty mbarriers and one claim per stage, each stage on
// a 1024-byte boundary. 5 stages of 40 KB on the bf16 route, 3 of 72 KB on
// the f32 route.
template <int kP, int kWn>
struct WidePlan {
  static constexpr int kTc = 64;                     // moving rows per tile
  static constexpr int kXBlock = kX * 128;           // X k-block, one piece
  static constexpr int kZBlock = kTc * 128;          // Z k-block, one piece
  static constexpr int kWinBlocks = kWn / 64;
  static constexpr int kZOff = kP * kXBlock;         // S item: X, then Z
  static constexpr int kSBytes = kP * (kXBlock + kZBlock);
  static constexpr int kYOff = kP * kWinBlocks * kZBlock;   // C item: Z, Y
  static constexpr int kCBytes = kYOff + kTc * kX;
  static constexpr int kStageBytes = kSBytes > kCBytes ? kSBytes : kCBytes;
  static constexpr int kFit = (kMaxSmem - 1024) / (kStageBytes + 20);
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kClaimOff = kBarOff + 2 * kStages * 8;
  static constexpr int kSmem = 1024 + kClaimOff + 4 * kStages;
  static_assert(kWn % 64 == 0 && kStageBytes % 1024 == 0,
                "whole k-blocks on 1024-byte stages");
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "the ring must fit");
};

// The wide kernel's ring: item it (of tile it / (kb + 1)) in stage
// it % kStages, loaded by TMA from inside the consumer warpgroups.
template <int kP, int kWn>
struct WideRing {
  using P = WidePlan<kP, kWn>;
  uint32_t base, bars;
  const CUtensorMap *mx, *mz, *myu, *myi;
  bool item;
  int x0, z_begin;
  int kb;       // k-blocks of a row (S items per tile)
  int c0;       // the window's first column
  int nchunk;   // its k-blocks (fewer than kWn / 64 in a last window)
  int* claims;  // per stage, the item last loaded into it
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
    const int t = it / (kb + 1), j = it - t * (kb + 1);
    const int z0 = z_begin + t * P::kTc;
    const uint32_t st = stage(it), bar = full(it);
    if (j < kb) {   // S item: k-block j of the stationary and moving rows
      mbar_expect_tx(bar, P::kSBytes);
      for (int p = 0; p < kP; ++p) {
        for (int r = 0; r < kX; r += 64)
          tma_load_3d(st + p * P::kXBlock + r * 128, mx, 64 * j, x0 + r, p,
                      bar);
        tma_load_3d(st + P::kZOff + p * P::kZBlock, mz, 64 * j, z0, p, bar);
      }
    } else {        // C item: the window's moving k-blocks and the Y tile
      mbar_expect_tx(bar, kP * nchunk * P::kZBlock + P::kTc * kX);
      for (int p = 0; p < kP; ++p)
        for (int c = 0; c < nchunk; ++c)
          tma_load_3d(st + (p * P::kWinBlocks + c) * P::kZBlock, mz,
                      c0 + 64 * c, z0, p, bar);
      if (item)   // Y tile [z = users][x = items]
        tma_load(st + P::kYOff, myi, x0, z0, bar);
      else        // Y tile [x = users][z = items]
        tma_load(st + P::kYOff, myu, z0, x0, bar);
    }
  }
  // as SplitLoader::release: the leader that finds both warpgroups done
  // with item it loads item it + kStages into its stage
  __device__ __forceinline__ void release(int it, int g, int nitems) const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    if (threadIdx.x % 128 != 0) return;
    const uint32_t e = empty(it);
    mbar_arrive(e);
    const int s = it % P::kStages;
    if (it + P::kStages < nitems && mbar_test(e, (it / P::kStages) & 1) &&
        atomicCAS(claims + s, it, it + P::kStages) == it)
      load(it + P::kStages);
  }
};

// S item it, k-block j: S's products over this k-block, from zero, retired
// and added to the S sums s.
template <int kP, int kWn>
__device__ __forceinline__ void wide_s_block(float (&s)[32],
                                             float (&sacc)[32],
                                             const WideRing<kP, kWn>& ring,
                                             int it, int g, int nitems) {
  using P = WidePlan<kP, kWn>;
  ring.wait_full(it);
  const uint32_t st = ring.stage(it);
  const uint64_t dx = desc_sw128(st + g * 64 * 128, 1, 64);
  const uint64_t dz = desc_sw128(st + P::kZOff, 1, 64);
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < wide_pairs<kP>(); ++p)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<64>(sacc, dx + ((wide_x<kP>(p) * P::kXBlock + ks * 32) >> 4),
                   dz + ((wide_z<kP>(p) * P::kZBlock + ks * 32) >> 4),
                   p > 0 || ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] += sacc[i];
  ring.release(it, g, nitems);
}

// Chunk c (64 columns) of the window's contraction, W's fragments against
// the C item's moving k-block c (MN-major), from zero, retired and added
// to the window's sums.
template <int kP, int kWn>
__device__ __forceinline__ void wide_chunk(float (&sums)[kWn / 2],
                                           const uint32_t (&wf)[kP][4][4],
                                           uint32_t st, int c) {
  using P = WidePlan<kP, kWn>;
  const uint64_t dz =
      desc_sw128(st + c * P::kZBlock, P::kZBlock / 16, 64);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < wide_pairs<kP>(); ++p)
#pragma unroll
    for (int zk = 0; zk < 4; ++zk)
      wgmma_rs<64>(acc, wf[wide_x<kP>(p)][zk],
                   dz + ((wide_z<kP>(p) * P::kWinBlocks * P::kZBlock +
                          zk * 2048) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) sums[32 * c + i] += acc[i];
}

// The C item it: W from the S sums and the Y tile, then the window's
// chunks, each retired before the next.
template <int kP, int kWn>
__device__ __forceinline__ void wide_contract(
    float (&sums)[kWn / 2], const float (&s)[32], uint32_t (&wf)[kP][4][4],
    const WideRing<kP, kWn>& ring, int it, int g, int nitems, bool item,
    uint32_t xrow, uint32_t q) {
  using P = WidePlan<kP, kWn>;
  ring.wait_full(it);
  const uint32_t st = ring.stage(it);
  if constexpr (kP == 1)
    make_w<64, kProd>(item, wf[0], s, st + P::kYOff, xrow, q);
  else
    make_w_split<kProd>(item, wf, s, st + P::kYOff, xrow, q);
#pragma unroll
  for (int p = 0; p < kP; ++p) fence_frags(wf[p]);
#pragma unroll
  for (int c = 0; c < P::kWinBlocks; ++c)
    if (c < ring.nchunk) wide_chunk<kP, kWn>(sums, wf, st, c);
  ring.release(it, g, nitems);
}

// Grid (role blocks, windows); the factor tables are [kP, rows, kq] bf16
// (the pieces on the f32 route, the bf16 rows on the other), loaded
// through 3-D tensor maps.
template <int kP, int kWn>
__global__ void __launch_bounds__(kThreadsSplit, 1)
dense_wide_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_yu,
                  const __grid_constant__ CUtensorMap map_yi,
                  float* __restrict__ acc_a, float* __restrict__ acc_b,
                  float* __restrict__ part_a, float* __restrict__ part_b,
                  int n, int m, int kq, int split_a, int split_b) {
  using P = WidePlan<kP, kWn>;
  constexpr int kTc = P::kTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring0 = smem_u32(base);
  const uint32_t bars = ring0 + P::kBarOff;

  const Role role = role_of<kX, kTc>(n, m, kq, split_a, split_b, acc_a,
                                     acc_b, part_a, part_b);
  const int kb = kq / 64;
  const int c0 = blockIdx.y * kWn;
  const int nchunk = (kq - c0 < kWn ? kq - c0 : kWn) / 64;
  const int ntiles = (role.z_end - role.z_begin + kTc - 1) / kTc;
  const int nitems = ntiles * (kb + 1);
  const int tid = threadIdx.x;
  int* claims = reinterpret_cast<int*>(base + P::kClaimOff);
  const WideRing<kP, kWn> ring{ring0, bars,
                               role.item ? &map_b : &map_a,
                               role.item ? &map_a : &map_b,
                               &map_yu, &map_yi, role.item, role.x0,
                               role.z_begin, kb, c0, nchunk, claims};
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                          // full
      mbar_init(bars + 8 * (P::kStages + s), 2);           // empty
      claims[s] = s;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < P::kStages && it < nitems; ++it) ring.load(it);

  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const uint32_t r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  const uint32_t xrow = 64 * g + r0;

  float sums[kWn / 2];        // the window's promoted sums
  float s[32], sacc[32];      // S's promoted sums, one k-block's products
  uint32_t wf[kP][4][4];      // W (its pieces) as A fragments
#pragma unroll
  for (int i = 0; i < kWn / 2; ++i) sums[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int it0 = t * (kb + 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int j = 0; j < kb; ++j)
      wide_s_block<kP, kWn>(s, sacc, ring, it0 + j, g, nitems);
    wide_contract<kP, kWn>(sums, s, wf, ring, it0 + kb, g, nitems,
                           role.item, xrow, q);
  }

  const int nx = role.item ? m : n;
#pragma unroll
  for (int c = 0; c < P::kWinBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = role.x0 + 64 * g + r0 + 8 * ((i / 2) % 2);
      const int col = c0 + 64 * c + 8 * (i / 4) + 2 * q;
      if (c < nchunk && row < nx)
        *reinterpret_cast<float2*>(role.out + (long long)row * kq + col) =
            make_float2(sums[32 * c + i], sums[32 * c + i + 1]);
    }
}

template <int kP, int kWn>
int launch_wide(const void* a, const void* b, const void* y, void* acc_a,
                void* acc_b, void* part_a, void* part_b, int n, int m,
                int kq, long long ldy, int split_a, int split_b,
                cudaStream_t stream) {
  using P = WidePlan<kP, kWn>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap ma, mb, myu, myi;
  if (!encode_packed(&ma, a, kq, n, kP, 64, 1) ||
      !encode_packed(&mb, b, kq, m, kP, 64, 1) ||
      !encode_2d(&myu, u8, y, m, n, ldy, P::kTc, kX,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(&myi, u8, y, m, n, ldy, kX, P::kTc,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_wide_kernel<kP, kWn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_a = (n + kX - 1) / kX, tiles_b = (m + kX - 1) / kX;
  const dim3 grid(tiles_a * split_a + tiles_b * split_b,
                  (kq + kWn - 1) / kWn);
  kernel<<<grid, kThreadsSplit, P::kSmem, stream>>>(
      ma, mb, myu, myi, static_cast<float*>(acc_a),
      static_cast<float*>(acc_b), static_cast<float*>(part_a),
      static_cast<float*>(part_b), n, m, kq, split_a, split_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(acc_a, acc_b, part_a, part_b, n, m, kq, split_a,
                         split_b, stream);
}

}  // namespace

// The bf16 route's wide kernel: a, b bf16 [n, kq], [m, kq] with kq a
// multiple of 64 (any width; ops/dense_fused.py sends it rows past 256
// values), rows zero-padded past the factors; y, outputs, splits and
// scratch as hpf_dense_wgmma_bf16. Returns the cudaError_t of the launches.
extern "C" int hpf_dense_wide_bf16(const void* a, const void* b,
                                   const void* y, void* acc_a, void* acc_b,
                                   void* part_a, void* part_b, int n, int m,
                                   int kq, long long ldy, int split_a,
                                   int split_b, void* stream) {
  if (kq <= 0 || kq % 64 != 0 ||
      bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  return launch_wide<1, kWideWnBf16>(a, b, y, acc_a, acc_b, part_a, part_b,
                                     n, m, kq, ldy, split_a, split_b,
                                     static_cast<cudaStream_t>(stream));
}

// The f32 route's wide kernel: a, b the three bf16 pieces of the packed
// f32 rows, [3, n, kq] and [3, m, kq], kq a multiple of 64; the rest as
// hpf_dense_wide_bf16.
extern "C" int hpf_dense_wide_f32(const void* a, const void* b,
                                  const void* y, void* acc_a, void* acc_b,
                                  void* part_a, void* part_b, int n, int m,
                                  int kq, long long ldy, int split_a,
                                  int split_b, void* stream) {
  if (kq <= 0 || kq % 64 != 0 ||
      bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  return launch_wide<kPieces, kWideWnF32>(
      a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy, split_a,
      split_b, static_cast<cudaStream_t>(stream));
}

// ---- wide rows: the resident design ----------------------------------------
//
// dense_res_kernel takes kernel #1's wide routes up to the widths whose
// stationary tile fits in shared memory whole: bf16 rows of 257-384 packed
// values (kq = 320, 384) and f32 rows of 129-320 (kq = 192, 256, 320);
// dense_cluster_kernel below and the streamed dense_wide_kernel above
// take wider rows. It replaces the TPU kernel dense_pallas.py::_kernel at
// those widths.
//
// What bounds the streamed design is the bytes it stages from L2 into
// shared memory: per 64-row moving tile it restages the stationary
// k-blocks (240 KB of the 416 KB an f32 tile moves at kq = 320), and per
// column window it restages the moving tile and forms S again. This design
// stages each operand once and forms S once:
//   * A CTA holds 64 stationary rows X, every k-block of every piece,
//     resident in shared memory (loaded once), and sweeps its chunk of
//     moving tiles Z of kTm rows (64 bf16, 32 f32: an f32 tile's pieces
//     take 6 bytes a value, and X takes 120 KB at kq = 320). Each k-block
//     of a tile (all its pieces in one TMA box) lands in a slot of a ring
//     of k-block slots and serves both S (K-major) and the contraction
//     (MN-major), as in the narrow kernels; its Y tile lands in a ring of
//     its own.
//   * S is formed once per tile, split in half by k-steps between the two
//     consumer warpgroups, and the output columns are split in half the
//     other way: warpgroup 0 forms S's partial over the upper half of the
//     k-steps and owns the lower half of the columns, warpgroup 1 the
//     reverse (ResHalf), so both issue the same products and hold kq / 4
//     f32 sums a thread. Where kq / 2 is not a multiple of 64 (kq = 192,
//     320) the middle k-block is shared: its S k-steps split 2 + 2, its
//     columns 32 + 32 (an m64n32 contraction whose MN-major descriptor
//     starts 64 bytes into the swizzled rows). The two partials meet in
//     shared memory (one f32 tile each, two named barriers a tile); each
//     warpgroup adds the other's (the same sum in both: IEEE addition
//     commutes), forms W for the whole tile in registers and contracts it
//     (wgmma RS) into its own columns, one 64- or 32-column chunk (one
//     slot, read MN-major) at a time.
//   * Products in flight: on the f32 route S's products come in groups of
//     two k-steps (12 products, an RS wgmma each, A = X's pieces loaded
//     by ldmatrix once per k-step and used by every pair of the piece: an
//     SS m64n32 product reads 3 KB of shared memory per 16 tensor clocks),
//     each group to one of two accumulator and fragment sets, group g + 1
//     issued before g retires and is promoted into the f32 partial; on the
//     bf16 route a warpgroup's S products (at most 12) are one group, and
//     its contraction chunks alternate two accumulator sets (chunk i + 1
//     issued before chunk i retires). The f32 contraction does the same
//     where the warpgroup's columns are whole chunks, and retires each
//     chunk before the next where one is a half chunk (two sets measured
//     slower there, at 254 registers). Issuing tile t + 1's S before tile
//     t's W, where the ring holds two tiles, measured no faster here
//     (PERF.md, section 6), and is not used: the two warpgroups meet at
//     the exchange every tile (the cluster kernel does, to meet the other
//     CTAs late). Every product retires before a barrier, a release of
//     a slot or the tile loop's back edge, and a phase's slots are waited
//     on before its first product (hazard 5 above).
//   * Promotion. No accumulator sums more than 24 products: an f32 group
//     of S (6 pairs x 2 k-steps), a bf16 warpgroup's S (at most 12
//     k-steps), a contraction chunk (6 pairs x 2 k-steps f32, 4 bf16),
//     each added into f32 sums once retired; on the f32 route the
//     contraction's additions are compensated (Kahan), so that a sum over
//     thousands of 32-row tiles carries the error of a few additions.
//   * Ring. Each warp releases a slot once its products on it have retired
//     (its S-only k-blocks after S, its contraction k-blocks after the
//     contraction; a Y tile after W); the release that empties a slot
//     loads the item kSlots ahead into it (SplitLoader's claim). The CTA
//     is the two consumer warpgroups (256 threads, up to 255 registers a
//     thread).
//   * Issued work: 8 N M kq products (x 6 bf16 on the f32 route), S once
//     per tile and role; bytes staged per sweep: each role's X once a CTA
//     and, per (64-row stationary tile, moving tile), the moving tile's
//     pieces and its Y tile (dense_fused.wide_plan; chip_smoke.py prints
//     both beside the streamed design's).

#include <type_traits>
#include <utility>

namespace {

// m64n32k16 SS: the f32 route's S over 32 moving rows
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

constexpr int kXr = 64;     // stationary rows per CTA
constexpr int kResY = 2;    // depth of the Y ring

// Shared-memory plan of the resident kernel, kP pieces (1 bf16, 3 f32),
// kKb k-blocks of 64 values, kTm moving rows a tile: X (kKb k-blocks, each
// [kP][64 rows][128 B]), the two S partials (f32, [2][kTm / 2][128
// threads]), kResY Y tiles, then the ring of k-block slots ([kP][kTm
// rows][128 B] each; as many as fit, at most three tiles' worth), then
// the mbarriers and the claims. Every TMA destination sits on a 1024-byte
// boundary.
template <int kP, int kKb, int kTm>
struct ResPlan {
  static constexpr int kKq = 64 * kKb;
  static constexpr int kE = kTm / 2;                 // S elements a thread
  static constexpr int kXBlock = kP * kXr * 128;     // X k-block, all pieces
  static constexpr int kPiece = kTm * 128;           // one piece of a slot
  static constexpr int kSlot = kP * kPiece;
  static constexpr int kYBytes = kXr * kTm;          // uint8
  static constexpr int kXchOff = kKb * kXBlock;
  static constexpr int kYOff = kXchOff + 2 * kE * 128 * 4;
  static constexpr int kSlotOff = kYOff + kResY * kYBytes;
  static constexpr int kBarBytes = 512;
  static constexpr int kFit = (kMaxSmem - 1024 - kSlotOff - kBarBytes) / kSlot;
  static constexpr int kSlots = kFit < 3 * kKb ? kFit : 3 * kKb;
  static constexpr int kBarOff = kSlotOff + kSlots * kSlot;
  // full[kSlots], empty[kSlots], yfull[kResY], yempty[kResY], x; claims;
  // last, the cluster kernel's two handoff barriers
  static constexpr int kXBar = 8 * (2 * kSlots + 2 * kResY);
  static constexpr int kClaimOff = kXBar + 8;
  static constexpr int kHandOff = kBarBytes - 16;
  static constexpr int kSmem = 1024 + kBarOff + kBarBytes;
  static_assert(kSlots >= kKb, "a tile's k-blocks must fit in the ring");
  static_assert(kClaimOff + 4 * (kSlots + kResY) <= kHandOff, "barriers");
  static_assert(kSlotOff % 1024 == 0 && kSlot % 1024 == 0, "alignment");
  static_assert(kSmem <= kMaxSmem, "the plan must fit");
};

// The resident kernel's rings: item it (k-block it % kKb of tile
// it / kKb) in slot it % kSlots, tile t's Y in stage t % kResY; loaded by
// TMA from inside the consumer warpgroups.
template <int kP, int kKb, int kTm>
struct ResRing {
  using P = ResPlan<kP, kKb, kTm>;
  uint32_t slots, ys, bars;
  const CUtensorMap *mz, *myu, *myi;
  bool item;
  int x0, z_begin, ntiles;
  int* claims;   // per slot, then per Y stage: the item last loaded into it
  int col0;      // the first column of the CTA's k-blocks (the cluster
                 // kernel's share; 0 in the resident kernel)
  __device__ __forceinline__ uint32_t slot(int it) const {
    return slots + (it % P::kSlots) * P::kSlot;
  }
  __device__ __forceinline__ uint32_t full(int it) const {
    return bars + 8 * (it % P::kSlots);
  }
  __device__ __forceinline__ uint32_t empty(int it) const {
    return bars + 8 * (P::kSlots + it % P::kSlots);
  }
  __device__ __forceinline__ uint32_t yslot(int t) const {
    return ys + (t % kResY) * P::kYBytes;
  }
  __device__ __forceinline__ uint32_t yfull(int t) const {
    return bars + 8 * (2 * P::kSlots + t % kResY);
  }
  __device__ __forceinline__ uint32_t yempty(int t) const {
    return bars + 8 * (2 * P::kSlots + kResY + t % kResY);
  }
  __device__ __forceinline__ void load(int it) const {
    const int t = it / kKb, j = it - t * kKb;
    mbar_expect_tx(full(it), P::kSlot);
    tma_load_3d(slot(it), mz, col0 + 64 * j, z_begin + t * kTm, 0, full(it));
  }
  __device__ __forceinline__ void load_y(int t) const {
    const int z0 = z_begin + t * kTm;
    mbar_expect_tx(yfull(t), P::kYBytes);
    if (item)   // Y tile [z = users][x = items]
      tma_load(yslot(t), myi, x0, z0, yfull(t));
    else        // Y tile [x = users][z = items]
      tma_load(yslot(t), myu, z0, x0, yfull(t));
  }
  // items [it0, it0 + kN) have landed
  template <int kN>
  __device__ __forceinline__ void wait(int it0) const {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      mbar_wait(full(it0 + j), ((it0 + j) / P::kSlots) & 1);
  }
  __device__ __forceinline__ void wait_y(int t) const {
    mbar_wait(yfull(t), (t / kResY) & 1);
  }
  // this warp is done with item it: lane 0 arrives on the slot's empty
  // barrier (eight arrivals a phase, one per warp); the arrival that
  // empties it claims the slot and loads item it + kSlots into it
  __device__ __forceinline__ void release(int it) const {
    if (threadIdx.x % 32 != 0) return;
    const uint32_t e = empty(it);
    mbar_arrive(e);
    const int s = it % P::kSlots;
    if (it + P::kSlots < ntiles * kKb &&
        mbar_test(e, (it / P::kSlots) & 1) &&
        atomicCAS(claims + s, it, it + P::kSlots) == it)
      load(it + P::kSlots);
  }
  __device__ __forceinline__ void release_y(int t) const {
    if (threadIdx.x % 32 != 0) return;
    const uint32_t e = yempty(t);
    mbar_arrive(e);
    const int s = P::kSlots + t % kResY;
    if (t + kResY < ntiles && mbar_test(e, (t / kResY) & 1) &&
        atomicCAS(claims + s, t, t + kResY) == t)
      load_y(t + kResY);
  }
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// f(std::integral_constant<int, i>{}) for i = 0 .. kN - 1, in order: a
// loop whose index is a constant expression in each step
template <class F, int... kI>
__device__ __forceinline__ void unroll_seq(F&& f,
                                           std::integer_sequence<int, kI...>) {
  (f(std::integral_constant<int, kI>{}), ...);
}
template <int kN, class F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_seq(f, std::make_integer_sequence<int, kN>{});
}

// m64n32k16 RS: a half chunk (32 output columns) of the contraction
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, "
      "%18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// What one warpgroup of the resident kernel does with a tile: S's partial
// over k-steps [kK0, kK1) (16 values each) and the output columns of half
// chunks [kH0, kH1) (32 columns each). Warpgroup 0 takes the upper half of
// the k-steps and the lower half of the columns, warpgroup 1 the reverse;
// the k-block that a half splits (kq = 192, 320) is shared.
template <int kKb, int kK0, int kK1, int kH0, int kH1>
struct ResHalf {
  static constexpr int kSA = kK0 / 4, kSB = (kK1 - 1) / 4;   // S k-blocks
  static constexpr int kCA = kH0 / 2, kCB = (kH1 - 1) / 2;   // C k-blocks
  static constexpr int kSN = kSB - kSA + 1, kCN = kCB - kCA + 1;
  static constexpr int kHalves = kH1 - kH0, kSteps = kK1 - kK0;
  static constexpr int kHFirst = kH0, kKFirst = kK0;
  // k-steps of S k-block kSA + i in the range
  __host__ __device__ static constexpr int s_lo(int i) {
    return 4 * (kSA + i) > kK0 ? 4 * (kSA + i) : kK0;
  }
  __host__ __device__ static constexpr int s_hi(int i) {
    return 4 * (kSA + i) + 4 < kK1 ? 4 * (kSA + i) + 4 : kK1;
  }
  // half chunks of C k-block kCA + i in the range
  __host__ __device__ static constexpr int c_lo(int i) {
    return 2 * (kCA + i) > kH0 ? 2 * (kCA + i) : kH0;
  }
  __host__ __device__ static constexpr int c_hi(int i) {
    return 2 * (kCA + i) + 2 < kH1 ? 2 * (kCA + i) + 2 : kH1;
  }
  // whether S k-block j is also one of the warpgroup's C k-blocks
  __host__ __device__ static constexpr bool in_c(int j) {
    return j >= kCA && j <= kCB;
  }
};

// The bf16 route's S partial of the tile whose first item is it0 into s:
// every k-step of the warpgroup's range, one group from zero (at most 24
// products). Committed, not waited on.
template <int kKb, class H>
__device__ __forceinline__ void res_s_bf16(float (&s)[32], uint64_t dx,
                                           const ResRing<1, kKb, 64>& ring,
                                           int it0) {
  using P = ResPlan<1, kKb, 64>;
  static_assert(H::kSteps <= 24, "one accumulator sums <= 24 products");
  fence_regs(s);
  wgmma_fence();
  unroll<H::kSN>([&](auto ic) {
    constexpr int i = decltype(ic)::value, j = H::kSA + i;
    const uint64_t dz = desc_sw128(ring.slot(it0 + j), 1, 64);
#pragma unroll
    for (int ks = H::s_lo(i); ks < H::s_hi(i); ++ks)
      wgmma_ss<64>(s, dx + ((j * P::kXBlock + (ks % 4) * 32) >> 4),
                   dz + (((ks % 4) * 32) >> 4), ks > H::s_lo(0));
  });
  wgmma_commit();
}

// m64n32k16 RS with B K-major: the f32 route's S products, X's fragment in
// registers (D (+)= A B, scale_d = 0 overwrites D)
__device__ __forceinline__ void wgmma_rs_k32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, "
      "%18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// this warp's 16 x 16 bf16 block of a wgmma A operand (rows 16 w ..
// 16 w + 15 of the warpgroup's 64): four 8 x 8 matrices, lane l giving the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The f32 route's S group kG: k-steps kKFirst + 2 kG and the next (two of
// the warpgroup's range) of the tile whose first item is it0, into a from
// zero, six pairs each, pair by pair smallest first (12 products). A =
// the X pieces' fragments, loaded into xf first (ldmatrix from the
// 128-byte-swizzled resident k-blocks: row r's 16-byte chunk c at
// 128 r + 16 (c ^ r % 8)), each used by every pair of its piece; B = the
// Z pieces K-major. Committed, not waited on.
template <int kKb, class H, int kG>
__device__ __forceinline__ void res_s_f32(float (&a)[16],
                                          uint32_t (&xf)[3][2][4],
                                          uint32_t xrow, uint32_t chunk,
                                          const ResRing<3, kKb, 32>& ring,
                                          int it0) {
  using P = ResPlan<3, kKb, 32>;
  constexpr int k0 = H::kKFirst + 2 * kG;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int px = 0; px < kPieces; ++px)
      ldsm_x4(xf[px][kk], xrow + ((k0 + kk) / 4) * P::kXBlock +
                              px * kXr * 128 +
                              (((2 * ((k0 + kk) % 4)) * 16) ^ chunk));
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = k0 + kk;
      const uint64_t dz = desc_sw128(ring.slot(it0 + ks / 4), 1, 64);
      wgmma_rs_k32(a, xf[pair_x(p)][kk],
                   dz + ((pair_z(p) * P::kPiece + (ks % 4) * 32) >> 4),
                   p > 0 || kk > 0);
    }
  wgmma_commit();
}

// This warpgroup's partial of S = X Z^T over its k-steps of the tile whose
// first item is it0, into s (retired and promoted). On the f32 route one
// group a k-block in two sets: k-block i + 1 is issued before k-block i
// retires and is promoted.
template <int kP, int kKb, int kTm, class H>
__device__ __forceinline__ void res_s(float (&s)[kTm / 2], uint32_t xs,
                                      const ResRing<kP, kKb, kTm>& ring,
                                      int it0) {
  if constexpr (kP == 1) {
    uint64_t dx = desc_sw128(xs, 1, 64);
    // an opaque move per call, so that ptxas does not hoist every X
    // descriptor out of the tile loop into uniform registers
    asm volatile("mov.b64 %0, %0;" : "+l"(dx));
    res_s_bf16<kKb, H>(s, dx, ring, it0);
    wgmma_wait<0>();
    fence_regs(s);
  } else {
    // groups of two k-steps in two sets (accumulators and X fragments):
    // group g + 1 is issued before group g retires and is promoted
    static_assert(kTm == 32 && H::kSteps % 2 == 0, "two k-steps a group");
    constexpr int kG = H::kSteps / 2;
    const uint32_t lane = threadIdx.x % 32;
    // this lane's ldmatrix row (of the 64) and the 16-byte chunk bits
    // that the row's swizzle and the lane's matrix put on its address
    const uint32_t row =
        16 * ((threadIdx.x % 128) / 32) + 8 * ((lane / 8) % 2) + lane % 8;
    const uint32_t chunk = ((lane / 16) * 16) ^ ((lane % 8) * 16);
    float a[2][16];
    uint32_t xf[2][3][2][4];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    unroll<kG>([&](auto gc) {
      constexpr int g = decltype(gc)::value;
      res_s_f32<kKb, H, g>(a[g % 2], xf[g % 2], xs + row * 128, chunk, ring,
                           it0);
      if constexpr (g > 0) {
        wgmma_wait<1>();
        fence_regs(a[(g - 1) % 2]);
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] += a[(g - 1) % 2][e];
      }
    });
    wgmma_wait<0>();
    fence_regs(a[(kG - 1) % 2]);
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] += a[(kG - 1) % 2][e];
  }
}

// W for the whole tile from S and the Y tile at ys, as wgmma A fragments
// (its pieces on the f32 route). Element (j, h, e) of S sits at stationary
// row x + 8 h, moving row z = 8 j + 2 q + e. The user role's Y tile is
// [x][z], kTm bytes a row (64: the 64-byte swizzle, chunk c of row r at
// c ^ ((r / 2) % 4); 32: unswizzled), the item role's [z][x], 64 bytes a
// row with the 64-byte swizzle (chunk c of row z at c ^ ((z / 2) % 4) =
// c ^ q).
template <int kP, int kTm>
__device__ __forceinline__ void res_w(uint32_t (&wf)[kP][kTm / 16][4],
                                      const float (&s)[kTm / 2], uint32_t ys,
                                      bool item, uint32_t x, uint32_t q) {
  const uint32_t key = kTm == 64 ? ((x >> 1) & 3) << 4 : 0;
#pragma unroll
  for (int j = 0; j < kTm / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0, y1;
      if (!item) {
        const uint32_t v = lds_u16(ys + (x + 8 * h) * kTm + 2 * q +
                                   8 * (j % 2) + ((16 * (j / 2)) ^ key));
        y0 = widen_u8(v, 0x7440);
        y1 = widen_u8(v, 0x7441);
      } else {
        const uint32_t col = (x + 8 * h) ^ (q << 4);
        y0 = widen_u8(lds_u8(ys + (8 * j + 2 * q) * kXr + col), 0x7440);
        y1 = widen_u8(lds_u8(ys + (8 * j + 2 * q + 1) * kXr + col), 0x7440);
      }
      const float s0 = s[4 * j + 2 * h], s1 = s[4 * j + 2 * h + 1];
      const int f = (j % 2) * 2 + h;
      if constexpr (kP == 1) {
        wf[0][j / 2][f] = pack_bf16x2(y0 * rcp_approx(fmaxf(s0, 1e-30f)),
                                      y1 * rcp_approx(fmaxf(s1, 1e-30f)));
      } else {
        split3(w_of(y0, fmaxf(s0, 1e-30f)), w_of(y1, fmaxf(s1, 1e-30f)),
               wf[0][j / 2][f], wf[1][j / 2][f], wf[2][j / 2][f]);
      }
    }
  }
}

// Chunk i of the warpgroup's contraction (C k-block j = kCA + i; its half
// chunks [c_lo(i), c_hi(i))) into acc from zero: A = W's fragments, B =
// Z's slot j read MN-major from the chunk's first column (a half chunk
// starts 64 bytes into the 128-byte rows). Committed, not waited on.
template <int kP, int kKb, int kTm, class H, int kI, int kN>
__device__ __forceinline__ void res_chunk(float (&acc)[kN / 2],
                                          const uint32_t (&wf)[kP][kTm / 16][4],
                                          const ResRing<kP, kKb, kTm>& ring,
                                          int it0) {
  using P = ResPlan<kP, kKb, kTm>;
  constexpr int j = H::kCA + kI;
  const uint64_t dz =
      desc_sw128(ring.slot(it0 + j) + 64 * (H::c_lo(kI) - 2 * j),
                 P::kPiece / 16, 64);
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < wide_pairs<kP>(); ++p)
#pragma unroll
    for (int kk = 0; kk < kTm / 16; ++kk)
      wgmma_rs<kN>(acc, wf[wide_x<kP>(p)][kk],
                   dz + ((wide_z<kP>(p) * P::kPiece + kk * 2048) >> 4));
  wgmma_commit();
}

// The bf16 contraction: chunk i + 1 issued before chunk i retires and is
// added into its sums (two accumulator sets); once all have retired,
// `retired()`, then the chunks' slots are released.
template <int kKb, class H, class F>
__device__ __forceinline__ void res_c_bf16(float (&sums)[H::kHalves][16],
                                           const uint32_t (&wf)[1][4][4],
                                           const ResRing<1, kKb, 64>& ring,
                                           int it0, const F& retired) {
  float acc[2][32];
  float acch[16];   // a half chunk's
  auto promote = [&](auto ic) {
    constexpr int i = decltype(ic)::value;
    constexpr int h0 = H::c_lo(i) - H::kHFirst;
    constexpr int nh = H::c_hi(i) - H::c_lo(i);
    if constexpr (nh == 2) {
      fence_regs(acc[i % 2]);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        sums[h0][e] += acc[i % 2][e];
        sums[h0 + 1][e] += acc[i % 2][16 + e];
      }
    } else {
      fence_regs(acch);
#pragma unroll
      for (int e = 0; e < 16; ++e) sums[h0][e] += acch[e];
    }
  };
  unroll<H::kCN>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    if constexpr (H::c_hi(i) - H::c_lo(i) == 2)
      res_chunk<1, kKb, 64, H, i, 64>(acc[i % 2], wf, ring, it0);
    else
      res_chunk<1, kKb, 64, H, i, 32>(acch, wf, ring, it0);
    if constexpr (i > 0) {
      wgmma_wait<1>();
      promote(std::integral_constant<int, i - 1>{});
    }
  });
  wgmma_wait<0>();
  promote(std::integral_constant<int, H::kCN - 1>{});
  retired();
  unroll<H::kCN>([&](auto ic) {
    ring.release(it0 + H::kCA + decltype(ic)::value);
  });
}

// sums += v[kO .. kO + 15], compensated (Kahan): comp carries the
// rounding error of the last addition, as bf16 pairs, into the next
template <int kO, int kN>
__device__ __forceinline__ void kahan16(float (&sums)[16], uint32_t (&comp)[8],
                                        const float (&v)[kN]) {
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    const uint32_t c = comp[e / 2];
    const float y0 = v[kO + e] + __uint_as_float(c << 16);
    const float y1 = v[kO + e + 1] + __uint_as_float(c & 0xFFFF0000u);
    const float t0 = sums[e] + y0, t1 = sums[e + 1] + y1;
    comp[e / 2] = pack_bf16x2(y0 - (t0 - sums[e]), y1 - (t1 - sums[e + 1]));
    sums[e] = t0;
    sums[e + 1] = t1;
  }
}

// The f32 contraction, the chunks last first. Each chunk's products (six
// pairs x 2 k-steps) start from zero and are added into the f32 sums by
// compensated (Kahan) summation, the compensation kept as bf16 pairs: a
// sum over thousands of tiles then carries the rounding error of a few
// additions, not of thousands. A warpgroup whose columns are whole chunks
// issues chunk i - 1 (on a second accumulator set) before chunk i retires
// and is added in; one with a half chunk (kq / 2 not a multiple of 64)
// retires each chunk before it issues the next (two sets with a half
// chunk's measured slower on the card, at 254 registers: PERF.md,
// section 6). A chunk's slot is released once it has retired, and
// `retired()` runs after the last chunk is added in.
template <int kKb, class H, class F>
__device__ __forceinline__ void res_c_f32(float (&sums)[H::kHalves][16],
                                          uint32_t (&comp)[H::kHalves][8],
                                          const uint32_t (&wf)[3][2][4],
                                          const ResRing<3, kKb, 32>& ring,
                                          int it0, const F& retired) {
  // chunk i, retired, into the sums (a: a chunk's 32 or a half chunk's 16)
  auto add = [&](auto ic, const auto& a) {
    constexpr int i = decltype(ic)::value;
    constexpr int h0 = H::c_lo(i) - H::kHFirst;
    ring.release(it0 + H::kCA + i);
    kahan16<0>(sums[h0], comp[h0], a);
    if constexpr (std::extent<std::remove_reference_t<decltype(a)>>::value ==
                  32)
      kahan16<16>(sums[h0 + 1], comp[h0 + 1], a);
    if constexpr (i == 0) retired();
  };
  if constexpr (H::kHalves % 2 == 0 && H::kCN > 1) {
    float acc[2][32];
    unroll<H::kCN>([&](auto nc) {
      constexpr int n = decltype(nc)::value, i = H::kCN - 1 - n;
      res_chunk<3, kKb, 32, H, i, 64>(acc[n % 2], wf, ring, it0);
      if constexpr (n > 0) {
        wgmma_wait<1>();
        fence_regs(acc[(n - 1) % 2]);
        add(std::integral_constant<int, i + 1>{}, acc[(n - 1) % 2]);
      }
    });
    wgmma_wait<0>();
    fence_regs(acc[(H::kCN - 1) % 2]);
    add(std::integral_constant<int, 0>{}, acc[(H::kCN - 1) % 2]);
    return;
  }
  float acc[32];    // a chunk's
  float acch[16];   // a half chunk's
  unroll<H::kCN>([&](auto nc) {
    constexpr int i = H::kCN - 1 - decltype(nc)::value;
    if constexpr (H::c_hi(i) - H::c_lo(i) == 2) {
      res_chunk<3, kKb, 32, H, i, 64>(acc, wf, ring, it0);
      wgmma_wait<0>();
      fence_regs(acc);
      add(std::integral_constant<int, i>{}, acc);
    } else {
      res_chunk<3, kKb, 32, H, i, 32>(acch, wf, ring, it0);
      wgmma_wait<0>();
      fence_regs(acch);
      add(std::integral_constant<int, i>{}, acch);
    }
  });
}

// The S partial of tile t over the warpgroup's k-steps into s (retired),
// and the tile's S k-blocks its contraction does not read released.
template <int kP, int kKb, int kTm, class H>
__device__ __forceinline__ void res_s_tile(float (&s)[kTm / 2], uint32_t xs,
                                           const ResRing<kP, kKb, kTm>& ring,
                                           int t) {
  const int it0 = t * kKb;
  ring.template wait<H::kSN>(it0 + H::kSA);
  res_s<kP, kKb, kTm, H>(s, xs, ring, it0);
  unroll<H::kSN>([&](auto ic) {   // the S k-blocks C does not read
    constexpr int j = H::kSA + decltype(ic)::value;
    if constexpr (!H::in_c(j)) ring.release(it0 + j);
  });
}

struct NoOp {
  __device__ __forceinline__ void operator()() const {}
};

// Tile t after S: W from the S totals s and the Y tile, then the
// contraction into the warpgroup's columns (sums, and comp on the f32
// route); the Y tile and the contraction's k-blocks are released.
// `retired()` runs once the contraction's products have retired: on the
// bf16 route before its slots are released (a release fence just after
// the loads that a release starts waits for them), on the f32 route at
// the end (its ring, one tile ahead, wants the next loads started first;
// PERF.md, section 6).
template <int kP, int kKb, int kTm, class H, class F = NoOp>
__device__ __forceinline__ void res_wc_tile(
    float (&sums)[H::kHalves][16],
    uint32_t (&comp)[kP == 1 ? 1 : H::kHalves][8], const float (&s)[kTm / 2],
    const ResRing<kP, kKb, kTm>& ring, int t, uint32_t r0, uint32_t q,
    const F& retired = F()) {
  const int it0 = t * kKb;
  uint32_t wf[kP][kTm / 16][4];
  ring.wait_y(t);
  res_w<kP, kTm>(wf, s, ring.yslot(t), ring.item, r0, q);
  __syncwarp();
  ring.release_y(t);
#pragma unroll
  for (int p = 0; p < kP; ++p) fence_frags(wf[p]);
  ring.template wait<H::kCN>(it0 + H::kCA);
  if constexpr (kP == 1)
    res_c_bf16<kKb, H>(sums, wf, ring, it0, retired);
  else
    res_c_f32<kKb, H>(sums, comp, wf, ring, it0, retired);
}

// The warpgroup's sums into `out` (rows of ldo values; the CTA's columns
// start at col0): half chunk h is columns 32 (kH0 + h) + 8 j + 2 q + e,
// element (j, hh, e) at register 4 j + 2 hh + e, row r0 + 8 hh.
template <class H>
__device__ __forceinline__ void res_store(const float (&sums)[H::kHalves][16],
                                          const Role& role, int nx,
                                          uint32_t r0, uint32_t q, int col0,
                                          int ldo) {
#pragma unroll
  for (int h = 0; h < H::kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int row = role.x0 + r0 + 8 * ((i / 2) % 2);
      const int col = col0 + 32 * (H::kHFirst + h) + 8 * (i / 4) + 2 * q;
      if (row < nx)
        *reinterpret_cast<float2*>(role.out + (long long)row * ldo + col) =
            make_float2(sums[h][i], sums[h][i + 1]);
    }
}

// One warpgroup's sweep (H: its k-steps and half chunks). xch: the S
// partials, f32 [2 warpgroups][kTm / 2][128 threads].
template <int kP, int kKb, int kTm, class H>
__device__ __forceinline__ void res_sweep(const ResRing<kP, kKb, kTm>& ring,
                                          uint32_t xs, uint32_t xch, int g,
                                          uint32_t r0, uint32_t q,
                                          const Role& role, int nx) {
  using P = ResPlan<kP, kKb, kTm>;
  constexpr int kE = P::kE, kNh = H::kHalves;
  // element e of warpgroup w's partial for thread i (of 128) sits at
  // xch + 4 (128 (w kE + e) + i): a warp touches 32 consecutive words
  const uint32_t mine = xch + 4 * (g * kE * 128 + threadIdx.x % 128);
  const uint32_t theirs = xch + 4 * ((1 - g) * kE * 128 + threadIdx.x % 128);
  float sums[kNh][16];                    // per half chunk of 32 columns
  uint32_t comp[kP == 1 ? 1 : kNh][8];    // f32: the sums' compensation
  float s[kE];
#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e) sums[h][e] = 0.f;
#pragma unroll
  for (int h = 0; h < (kP == 1 ? 1 : kNh); ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) comp[h][e] = 0u;
#pragma unroll
  for (int e = 0; e < kE; ++e) s[e] = 0.f;

  for (int t = 0; t < ring.ntiles; ++t) {
    res_s_tile<kP, kKb, kTm, H>(s, xs, ring, t);
    // the partials meet: barrier 1, the other warpgroup has read the last
    // tile's; barrier 2, both are written
    named_sync(1);
#pragma unroll
    for (int e = 0; e < kE; ++e) sts_f32(mine + 512 * e, s[e]);
    named_sync(2);
#pragma unroll
    for (int e = 0; e < kE; ++e) s[e] += lds_f32(theirs + 512 * e);
    res_wc_tile<kP, kKb, kTm, H>(sums, comp, s, ring, t, r0, q);
  }
  res_store<H>(sums, role, nx, r0, q, 0, P::kKq);
}

// The resident and the cluster kernels' start: thread 0 initialises the
// rings' barriers, then (after the CTA's barrier) loads the CTA's kKb
// stationary k-blocks from column col0 (mx: boxes of 64 rows) and the
// first moving k-blocks (mz: boxes of kTm rows) and Y tiles. Returns the
// ring.
template <int kP, int kKb, int kTm>
__device__ __forceinline__ ResRing<kP, kKb, kTm> res_start(
    uint32_t xs, uint32_t bars, uint32_t xbar, int* claims, const Role& role,
    const CUtensorMap* mx, const CUtensorMap* mz, const CUtensorMap* myu,
    const CUtensorMap* myi, int col0) {
  using P = ResPlan<kP, kKb, kTm>;
  const int ntiles = (role.z_end - role.z_begin + kTm - 1) / kTm;
  const ResRing<kP, kKb, kTm> ring{
      xs + P::kSlotOff, xs + P::kYOff, bars, mz, myu, myi, role.item,
      role.x0, role.z_begin, ntiles, claims, col0};
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < P::kSlots; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full
      mbar_init(bars + 8 * (P::kSlots + s), 8);         // empty: 8 warps
      claims[s] = s;
    }
    for (int s = 0; s < kResY; ++s) {
      mbar_init(ring.yfull(s), 1);
      mbar_init(ring.yempty(s), 8);
      claims[P::kSlots + s] = s;
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(xbar, kKb * P::kXBlock);
    for (int j = 0; j < kKb; ++j)
      tma_load_3d(xs + j * P::kXBlock, mx, col0 + 64 * j, role.x0, 0, xbar);
    for (int it = 0; it < P::kSlots && it < ntiles * kKb; ++it) ring.load(it);
    for (int t = 0; t < kResY && t < ntiles; ++t) ring.load_y(t);
  }
  return ring;
}

// Grid: the role blocks of csrc/dense_roles.cuh over 64-row stationary
// tiles. The factor tables are [kP, rows, kq] bf16 (the f32 route's
// pieces, or the bf16 rows), each through two 3-D tensor maps: boxes of
// 64 rows (x, the stationary tile) and of kTm rows (z, a moving tile).
template <int kP, int kKb, int kTm>
__global__ void __launch_bounds__(kThreadsSplit, 1)
dense_res_kernel(const __grid_constant__ CUtensorMap map_ax,
                 const __grid_constant__ CUtensorMap map_bx,
                 const __grid_constant__ CUtensorMap map_az,
                 const __grid_constant__ CUtensorMap map_bz,
                 const __grid_constant__ CUtensorMap map_yu,
                 const __grid_constant__ CUtensorMap map_yi,
                 float* __restrict__ acc_a, float* __restrict__ acc_b,
                 float* __restrict__ part_a, float* __restrict__ part_b,
                 int n, int m, int split_a, int split_b) {
  using P = ResPlan<kP, kKb, kTm>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t xs = smem_u32(base);
  const uint32_t bars = xs + P::kBarOff;
  const uint32_t xbar = bars + P::kXBar;
  int* claims = reinterpret_cast<int*>(base + P::kBarOff + P::kClaimOff);
  const uint32_t xch = xs + P::kXchOff;

  const Role role = role_of<kXr, kTm>(n, m, P::kKq, split_a, split_b, acc_a,
                                      acc_b, part_a, part_b);
  const ResRing<kP, kKb, kTm> ring = res_start<kP, kKb, kTm>(
      xs, bars, xbar, claims, role, role.item ? &map_bx : &map_ax,
      role.item ? &map_az : &map_bz, &map_yu, &map_yi, 0);
  const int tid = threadIdx.x;
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const uint32_t r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  const int nx = role.item ? m : n;
  mbar_wait(xbar, 0);
  // kq / 16 k-steps of S and kq / 32 half chunks of output columns
  if (g == 0)
    res_sweep<kP, kKb, kTm, ResHalf<kKb, 2 * kKb, 4 * kKb, 0, kKb>>(
        ring, xs, xch, 0, r0, q, role, nx);
  else
    res_sweep<kP, kKb, kTm, ResHalf<kKb, 0, 2 * kKb, kKb, 2 * kKb>>(
        ring, xs, xch, 1, r0, q, role, nx);
}

template <int kP, int kKb, int kTm>
int launch_res(const void* a, const void* b, const void* y, void* acc_a,
               void* acc_b, void* part_a, void* part_b, int n, int m,
               long long ldy, int split_a, int split_b, cudaStream_t stream) {
  using P = ResPlan<kP, kKb, kTm>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap mxa, mxb, mza, mzb, myu, myi;
  if (!encode_packed(&mxa, a, P::kKq, n, kP, kXr, kP) ||
      !encode_packed(&mxb, b, P::kKq, m, kP, kXr, kP) ||
      !encode_packed(&mza, a, P::kKq, n, kP, kTm, kP) ||
      !encode_packed(&mzb, b, P::kKq, m, kP, kTm, kP) ||
      !encode_2d(&myu, u8, y, m, n, ldy, kTm, kXr,
                 kTm == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&myi, u8, y, m, n, ldy, kXr, kTm,
                 CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_res_kernel<kP, kKb, kTm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_a = (n + kXr - 1) / kXr, tiles_b = (m + kXr - 1) / kXr;
  kernel<<<tiles_a * split_a + tiles_b * split_b, kThreadsSplit, P::kSmem,
           stream>>>(mxa, mxb, mza, mzb, myu, myi, static_cast<float*>(acc_a),
                     static_cast<float*>(acc_b), static_cast<float*>(part_a),
                     static_cast<float*>(part_b), n, m, split_a, split_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(acc_a, acc_b, part_a, part_b, n, m, P::kKq, split_a,
                         split_b, stream);
}

}  // namespace

// The bf16 route's resident wide kernel: a, b bf16 [n, kq], [m, kq] with kq
// in {320, 384}, rows zero-padded past the factors; y, outputs, splits
// (of 64-row stationary tiles) and scratch as hpf_dense_wgmma_bf16.
// Returns the cudaError_t of the launches.
extern "C" int hpf_dense_res_bf16(const void* a, const void* b, const void* y,
                                  void* acc_a, void* acc_b, void* part_a,
                                  void* part_b, int n, int m, int kq,
                                  long long ldy, int split_a, int split_b,
                                  void* stream) {
  if (bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kq) {
    case 320:
      return launch_res<1, 5, 64>(a, b, y, acc_a, acc_b, part_a, part_b, n,
                                  m, ldy, split_a, split_b, st);
    case 384:
      return launch_res<1, 6, 64>(a, b, y, acc_a, acc_b, part_a, part_b, n,
                                  m, ldy, split_a, split_b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 route's resident wide kernel: a, b the three bf16 pieces of the
// packed f32 rows, [3, n, kq] and [3, m, kq] with kq in {192, 256, 320};
// the rest as hpf_dense_res_bf16.
extern "C" int hpf_dense_res_f32(const void* a, const void* b, const void* y,
                                 void* acc_a, void* acc_b, void* part_a,
                                 void* part_b, int n, int m, int kq,
                                 long long ldy, int split_a, int split_b,
                                 void* stream) {
  if (bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kq) {
    case 192:
      return launch_res<kPieces, 3, 32>(a, b, y, acc_a, acc_b, part_a,
                                        part_b, n, m, ldy, split_a, split_b,
                                        st);
    case 256:
      return launch_res<kPieces, 4, 32>(a, b, y, acc_a, acc_b, part_a,
                                        part_b, n, m, ldy, split_a, split_b,
                                        st);
    case 320:
      return launch_res<kPieces, 5, 32>(a, b, y, acc_a, acc_b, part_a,
                                        part_b, n, m, ldy, split_a, split_b,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- wide rows: the cluster design -----------------------------------------
//
// dense_cluster_kernel takes kernel #1's wide routes past the resident
// kernel's widths, up to the widest a cluster of 8 CTAs holds: f32 rows
// of 321-2560 packed values, bf16 rows of 385-3072; the route sends it
// rows up to 960 values and the unfused route (csrc/dense_unfused.cu) the
// wider ones. It replaces the TPU kernel dense_pallas.py::_kernel at
// those widths.
//
// What stops dense_res_kernel past 320 f32 / 384 bf16 values is one CTA's
// room: its 64 resident stationary rows take 6 bytes a value on the f32
// route (120 KB at kq = 320 of the 227 KB a block may use), and on the
// bf16 route each warpgroup holds kq / 4 f32 sums a thread. A thread-block
// cluster of c CTAs, which read each other's shared memory, splits the
// row between them:
//   * Layout. The c CTAs of a cluster share one role block of
//     csrc/dense_roles.cuh (role_at of the cluster's index: one 64-row
//     stationary tile and one chunk of moving tiles, the two deterministic
//     roles, reduce_splits for split > 1). The packed row is c shares of
//     kKb k-blocks, c = max(2, ceil(kq / 320)) on the f32 route and
//     max(2, ceil(kq / 384)) on the bf16 route (the wrapper pads kq to
//     c kKb 64 values). CTA r, the cluster's rank r, runs dense_res_kernel
//     on share r: it holds the share's stationary k-blocks resident (at
//     most 120 KB of pieces f32), stages only the share's k-blocks of each
//     moving tile (32 rows f32, 64 bf16) into its ring, read K-major for S
//     and MN-major for the contraction, and its two warpgroups split the
//     share's S k-steps and output columns as ResHalf does.
//   * S. The CTAs' partials of S meet through distributed shared memory
//     (ClusterXch): in each CTA warpgroup 1 stores its partial and hands
//     it over through an mbarrier (it does not wait), warpgroup 0 adds it
//     to its own and stores the CTA's partial in one of two buffers; the
//     cluster meets at a barrier (barrier.cluster.arrive / wait.acquire),
//     and every warpgroup reads the c partials (its own CTA's locally, the
//     others' by mapa and ld.shared::cluster, a float4 a load; on the f32
//     route with two CTAs the other's is fetched before the combine) and
//     adds them in the same order, CTA 0 to c - 1: all 2c warpgroups hold
//     the same bits of S and form the same W. A split arrive / wait keeps
//     the meeting off the path: a warpgroup arrives once its CTA's partial
//     of tile t + 1 is stored and it has read and used tile t's (after
//     the tile's contraction, bf16 before it releases the contraction's
//     slots: warpgroup 0's arrival releases its stores, and its fence
//     waits for the stores and loads just issued; warpgroup 1 stores
//     nothing the other CTAs read, and arrives relaxed), and waits on
//     that phase only after it has formed the partial of tile t + 2, by
//     when the other CTAs are there. Forming tile t + 1's S before tile
//     t's W needs the ring to hold two tiles' k-blocks and the registers
//     one more phase: an f32 share of five k-blocks (120 KB resident)
//     leaves room for 7, a bf16 share of six spilled, and there the tile's
//     S, the meeting and W follow each other. Clusters of more CTAs on
//     smaller shares, and one-warpgroup CTAs two an SM, measured slower
//     (PERF.md, section 6).
//   * Y and the contraction. Each CTA loads the tile's Y (2 KB f32, 4 KB
//     bf16) by TMA itself, beside its share of the moving tile (kKb times
//     12 KB f32, 8 KB bf16), and contracts W into its share's output
//     columns only: no column is summed across CTAs, there are no atomics,
//     and two launches give the same bits.
//   * Promotion and precision as dense_res_kernel: no wgmma accumulator
//     sums more than 24 products; on the f32 route the contraction's sums
//     are compensated.
//   * Issued work 8 N M kq products (x 6 bf16 on the f32 route), S once per
//     tile; staged: each factor once (a stationary tile's k-blocks once
//     across its cluster, each moving tile's share once per CTA), Y c times
//     (dense_fused.wide_plan).

namespace {

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared-memory address `addr` of this CTA as the same offset in the
// shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void sts_v4(uint32_t addr, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void lds_v4(uint32_t addr, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ld_cluster_v4(uint32_t addr, float* v) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

// Where a cluster's S partials meet: in each CTA two buffers (tile t in
// buffer t % 2, the resident kernel's exchange area) of its partial, f32
// [kE / 4][128 threads][4]: elements 4 i .. 4 i + 3 of thread j at
// 16 (128 i + j), so that each access is a float4 and a warp's are
// consecutive.
template <int kE>
struct ClusterXch {
  uint32_t mine;   // this thread's first float4 in buffer 0
  uint32_t hand;   // the handoff barriers, one a buffer
  int g, c, rank;
  __device__ __forceinline__ ClusterXch(uint32_t xch, uint32_t bars, int wg,
                                        int ctas, int cta)
      : mine(xch + 16 * (threadIdx.x % 128)), hand(bars), g(wg), c(ctas),
        rank(cta) {}
  __device__ __forceinline__ uint32_t at(int t) const {
    return mine + (t % 2) * kE * 512;
  }
  // the CTA's partial of tile t into its buffer: warpgroup 1 stores its
  // own and hands it over (each warp arrives on the buffer's handoff
  // barrier, and does not wait), warpgroup 0 waits for it, adds it to its
  // own and stores the sum in its place
  __device__ __forceinline__ void combine(float (&s)[kE], int t) const {
    const uint32_t a = at(t), bar = hand + 8 * (t % 2);
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < kE / 4; ++i) sts_v4(a + 2048 * i, s + 4 * i);
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(bar);
    } else {
      mbar_wait(bar, (t / 2) & 1);
#pragma unroll
      for (int i = 0; i < kE / 4; ++i) {
        float v[4];
        lds_v4(a + 2048 * i, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * i + e] += v[e];
        sts_v4(a + 2048 * i, s + 4 * i);
      }
    }
  }
  // the other CTA's partial of tile t into pf, for a cluster of two: its
  // loads are in flight while the caller does other work
  __device__ __forceinline__ void fetch(float (&pf)[kE], int t) const {
    const uint32_t a = at_rank(at(t), 1 - rank);
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) ld_cluster_v4(a + 2048 * i, pf + 4 * i);
  }
  // S of tile t in a cluster of two, the other CTA's partial fetched into
  // pf: the sum of two (IEEE addition commutes: the same in both CTAs)
  __device__ __forceinline__ void total(float (&s)[kE], int t,
                                        const float (&pf)[kE]) const {
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) {
      float v[4];
      lds_v4(at(t) + 2048 * i, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * i + e] = v[e] + pf[4 * i + e];
    }
  }
  // S of tile t: the c CTAs' partials added in the order CTA 0 .. c - 1,
  // the same in every CTA (its own read from its own shared memory)
  __device__ __forceinline__ void total(float (&s)[kE], int t) const {
    for (int r = 0; r < c; ++r) {
      const uint32_t a = r == rank ? at(t) : at_rank(at(t), r);
#pragma unroll
      for (int i = 0; i < kE / 4; ++i) {
        float v[4];
        if (r == rank)
          lds_v4(a + 2048 * i, v);
        else
          ld_cluster_v4(a + 2048 * i, v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * i + e] = r == 0 ? v[e] : s[4 * i + e] + v[e];
      }
    }
  }
  // this thread has stored what the other CTAs read (warpgroup 0: the
  // CTA's partial; release) or only read (warpgroup 1: the values are in
  // its registers; relaxed)
  __device__ __forceinline__ void arrive() const {
    if (g == 0)
      cluster_arrive();
    else
      cluster_arrive_relaxed();
  }
};

// One warpgroup's sweep in a cluster (H: its k-steps and half chunks of
// the CTA's share). The cluster meets at a barrier once a tile; each
// phase A(t) ends when every thread of the cluster has arrived after its
// CTA's partial of tile t is stored and the partials of tile t - 1 are
// read (each buffer is then free two tiles later). kAhead: tile t + 1's S
// partial is formed and stored before tile t's totals are read, so that
// the wait on A(t) finds the other CTAs there already; it needs the ring
// to hold two tiles' k-blocks (tile t's contraction has not released
// them), else the tile's S, the meeting and W follow each other.
template <int kP, int kKb, int kTm, class H, bool kAhead>
__device__ __forceinline__ void cluster_sweep(
    const ResRing<kP, kKb, kTm>& ring, uint32_t xs,
    const ClusterXch<kTm / 2>& xch, uint32_t r0, uint32_t q,
    const Role& role, int nx, int col0, int ldo) {
  constexpr int kE = kTm / 2, kNh = H::kHalves;
  static_assert(!kAhead || ResPlan<kP, kKb, kTm>::kSlots >= 2 * kKb,
                "two tiles' k-blocks in the ring");
  float sums[kNh][16];
  uint32_t comp[kP == 1 ? 1 : kNh][8];
  float s[kE];
#pragma unroll
  for (int h = 0; h < kNh; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e) sums[h][e] = 0.f;
#pragma unroll
  for (int h = 0; h < (kP == 1 ? 1 : kNh); ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) comp[h][e] = 0u;
#pragma unroll
  for (int e = 0; e < kE; ++e) s[e] = 0.f;

  const int n = ring.ntiles;
  if constexpr (kAhead) {
    if (n > 0) {
      res_s_tile<kP, kKb, kTm, H>(s, xs, ring, 0);
      xch.combine(s, 0);
      xch.arrive();                           // A(0)
    }
    for (int t = 0; t < n; ++t) {
      const bool next = t + 1 < n;
      if (next) res_s_tile<kP, kKb, kTm, H>(s, xs, ring, t + 1);
      cluster_wait();                         // A(t)
      // f32, two CTAs: the other CTA's partial of tile t is fetched before
      // the combine (its registers are what bf16 has not to spare)
      constexpr bool kFetch = kP == 3;
      float pf[kE];
      if (kFetch && xch.c == 2) xch.fetch(pf, t);
      if (next) xch.combine(s, t + 1);
      if (kFetch && xch.c == 2)
        xch.total(s, t, pf);
      else
        xch.total(s, t);
      // A(t + 1), once W and the contraction have run: by then the stores
      // that warpgroup 0's release orders are long done, and its fence
      // costs little
      res_wc_tile<kP, kKb, kTm, H>(sums, comp, s, ring, t, r0, q,
                                   [&] { xch.arrive(); });
    }
    if (n > 0) cluster_wait();    // no CTA leaves while its buffers are read
  } else {
    for (int t = 0; t < n; ++t) {
      res_s_tile<kP, kKb, kTm, H>(s, xs, ring, t);
      xch.combine(s, t);
      xch.arrive();                           // A(t)
      cluster_wait();
      xch.total(s, t);
      res_wc_tile<kP, kKb, kTm, H>(sums, comp, s, ring, t, r0, q);
    }
    if (n > 0) {                  // no CTA leaves while its buffers are read
      cluster_arrive_relaxed();
      cluster_wait();
    }
  }
  res_store<H>(sums, role, nx, r0, q, col0, ldo);
}

// Grid: c CTAs (one cluster) per role block of csrc/dense_roles.cuh over
// 64-row stationary tiles; tensor maps as dense_res_kernel's, over the
// whole packed row of c kKb k-blocks.
template <int kP, int kKb, int kTm>
__global__ void __launch_bounds__(kThreadsSplit, 1)
dense_cluster_kernel(const __grid_constant__ CUtensorMap map_ax,
                     const __grid_constant__ CUtensorMap map_bx,
                     const __grid_constant__ CUtensorMap map_az,
                     const __grid_constant__ CUtensorMap map_bz,
                     const __grid_constant__ CUtensorMap map_yu,
                     const __grid_constant__ CUtensorMap map_yi,
                     float* __restrict__ acc_a, float* __restrict__ acc_b,
                     float* __restrict__ part_a, float* __restrict__ part_b,
                     int n, int m, int split_a, int split_b) {
  using P = ResPlan<kP, kKb, kTm>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t xs = smem_u32(base);
  const uint32_t bars = xs + P::kBarOff;
  const uint32_t xbar = bars + P::kXBar;
  int* claims = reinterpret_cast<int*>(base + P::kBarOff + P::kClaimOff);
  const uint32_t xch = xs + P::kXchOff;

  const int c = cluster_ctas(), rank = cluster_rank();
  const int kq = c * P::kKq, col0 = rank * P::kKq;
  const Role role = role_at<kXr, kTm>(cluster_index(), n, m, kq, split_a,
                                      split_b, acc_a, acc_b, part_a, part_b);
  const uint32_t hand = bars + P::kHandOff;
  if (threadIdx.x == 0)       // before res_start's fence and barrier
    for (int b = 0; b < 2; ++b) mbar_init(hand + 8 * b, 4);   // 4 warps
  const ResRing<kP, kKb, kTm> ring = res_start<kP, kKb, kTm>(
      xs, bars, xbar, claims, role, role.item ? &map_bx : &map_ax,
      role.item ? &map_az : &map_bz, &map_yu, &map_yi, col0);
  const int tid = threadIdx.x;
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;
  const uint32_t r0 = 16 * ((tid % 128) / 32) + lane / 4, q = lane % 4;
  const int nx = role.item ? m : n;
  const ClusterXch<P::kE> x(xch, hand, g, c, rank);
  mbar_wait(xbar, 0);
  // ahead where the ring holds two tiles and the registers one more
  // phase (the bf16 share of six k-blocks, 96 sums a thread, spilled)
  constexpr bool kAhead = P::kSlots >= 2 * kKb && !(kP == 1 && kKb == 6);
  if (g == 0)
    cluster_sweep<kP, kKb, kTm, ResHalf<kKb, 2 * kKb, 4 * kKb, 0, kKb>,
                  kAhead>(ring, xs, x, r0, q, role, nx, col0, kq);
  else
    cluster_sweep<kP, kKb, kTm, ResHalf<kKb, 0, 2 * kKb, kKb, 2 * kKb>,
                  kAhead>(ring, xs, x, r0, q, role, nx, col0, kq);
}

template <int kP, int kKb, int kTm>
int launch_cluster(const void* a, const void* b, const void* y, void* acc_a,
                   void* acc_b, void* part_a, void* part_b, int n, int m,
                   int c, long long ldy, int split_a, int split_b,
                   cudaStream_t stream) {
  using P = ResPlan<kP, kKb, kTm>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const int kq = c * P::kKq;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap mxa, mxb, mza, mzb, myu, myi;
  if (!encode_packed(&mxa, a, kq, n, kP, kXr, kP) ||
      !encode_packed(&mxb, b, kq, m, kP, kXr, kP) ||
      !encode_packed(&mza, a, kq, n, kP, kTm, kP) ||
      !encode_packed(&mzb, b, kq, m, kP, kTm, kP) ||
      !encode_2d(&myu, u8, y, m, n, ldy, kTm, kXr,
                 kTm == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&myi, u8, y, m, n, ldy, kXr, kTm,
                 CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  auto kernel = dense_cluster_kernel<kP, kKb, kTm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_a = (n + kXr - 1) / kXr, tiles_b = (m + kXr - 1) / kXr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles_a * split_a + tiles_b * split_b) * c);
  cfg.blockDim = dim3(kThreadsSplit);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mxa, mxb, mza, mzb, myu, myi,
                           static_cast<float*>(acc_a),
                           static_cast<float*>(acc_b),
                           static_cast<float*>(part_a),
                           static_cast<float*>(part_b), n, m, split_a,
                           split_b);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(acc_a, acc_b, part_a, part_b, n, m, kq, split_a,
                         split_b, stream);
}

// The cluster of a packed width: c = max(2, ceil(kq / (64 max_kb))) CTAs of
// kq / (64 c) k-blocks each; false where kq is not c whole shares or needs
// more than 8 CTAs (the portable most). ops/dense_fused.py::cluster_shape
// pads a width to such a row.
bool cluster_shape(int kq, int max_kb, int* c, int* kb) {
  if (kq <= 0 || kq % 64 != 0) return false;
  const int blocks = kq / 64;
  *c = (blocks + max_kb - 1) / max_kb;
  if (*c < 2) *c = 2;
  *kb = blocks / *c;
  return *c <= 8 && *c * *kb == blocks;
}

}  // namespace

// The bf16 route's cluster kernel: a, b bf16 [n, kq], [m, kq], rows
// zero-padded past the factors, kq = c kb 64 values for a cluster of
// c = max(2, ceil(kq / 384)) <= 8 CTAs of kb in {4, 5, 6} k-blocks each
// (512-3072 values; ops/dense_fused.py pads to such a width); y, outputs,
// splits (of 64-row stationary tiles) and scratch as hpf_dense_wgmma_bf16.
// Returns the cudaError_t of the launches.
extern "C" int hpf_dense_cluster_bf16(const void* a, const void* b,
                                      const void* y, void* acc_a,
                                      void* acc_b, void* part_a,
                                      void* part_b, int n, int m, int kq,
                                      long long ldy, int split_a,
                                      int split_b, void* stream) {
  int c, kb;
  if (!cluster_shape(kq, 6, &c, &kb) ||
      bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kb) {
    case 4:
      return launch_cluster<1, 4, 64>(a, b, y, acc_a, acc_b, part_a, part_b,
                                      n, m, c, ldy, split_a, split_b, st);
    case 5:
      return launch_cluster<1, 5, 64>(a, b, y, acc_a, acc_b, part_a, part_b,
                                      n, m, c, ldy, split_a, split_b, st);
    case 6:
      return launch_cluster<1, 6, 64>(a, b, y, acc_a, acc_b, part_a, part_b,
                                      n, m, c, ldy, split_a, split_b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 route's cluster kernel: a, b the three bf16 pieces of the packed
// f32 rows, [3, n, kq] and [3, m, kq], kq = c kb 64 values for a cluster of
// c = max(2, ceil(kq / 320)) <= 8 CTAs of kb in {3, 4, 5} k-blocks each
// (384-2560 values); the rest as hpf_dense_cluster_bf16.
extern "C" int hpf_dense_cluster_f32(const void* a, const void* b,
                                     const void* y, void* acc_a,
                                     void* acc_b, void* part_a,
                                     void* part_b, int n, int m, int kq,
                                     long long ldy, int split_a,
                                     int split_b, void* stream) {
  int c, kb;
  if (!cluster_shape(kq, 5, &c, &kb) ||
      bad_args(a, b, y, part_a, part_b, n, m, ldy, split_a, split_b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kb) {
    case 3:
      return launch_cluster<kPieces, 3, 32>(a, b, y, acc_a, acc_b, part_a,
                                            part_b, n, m, c, ldy, split_a,
                                            split_b, st);
    case 4:
      return launch_cluster<kPieces, 4, 32>(a, b, y, acc_a, acc_b, part_a,
                                            part_b, n, m, c, ldy, split_a,
                                            split_b, st);
    case 5:
      return launch_cluster<kPieces, 5, 32>(a, b, y, acc_a, acc_b, part_a,
                                            part_b, n, m, c, ldy, split_a,
                                            split_b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
