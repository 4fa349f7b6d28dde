// Fused dense CAVI sweep in bf16 for Hopper (sm_90a): wgmma products on
// TMA-fed tiles, bound to Python with ctypes (ops/dense_fused.py).
//
// Replaces the TPU kernel hgaprec_tpu/ops/dense_pallas.py::_kernel in its
// bf16 mode ("default" precision, the main path). For a uint8 count matrix
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

// What both entries refuse: the arguments no instantiation takes.
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
