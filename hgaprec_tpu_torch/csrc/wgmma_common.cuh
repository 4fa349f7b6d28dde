// What the dense sweep's wgmma kernels share (csrc/dense_wgmma.cu,
// csrc/dense_unfused.cu): the PTX wrappers of TMA, mbarriers and wgmma,
// the W stage's conversions, the f32 route's split pieces and pairs, and
// the host's tensor-map encoder.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums only; cuTensorMapEncodeTiled
                    // is reached through the runtime (encoder below)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_roles.cuh"

namespace {

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

constexpr int kPieces = 3;
constexpr int kPairs = 6;
constexpr int kMaxSmem = 232448;   // shared memory one CTA may opt in to

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

// [pieces, rows, cols] bf16, rows row_bytes and pieces piece_bytes apart,
// loaded in boxes of 64 columns x box_rows rows x box_pieces pieces with
// the 128-byte swizzle; out-of-range elements load as zero
bool encode_bf16(CUtensorMap* map, const void* ptr, uint64_t cols,
                 uint64_t rows, uint64_t pieces, uint64_t row_bytes,
                 uint64_t piece_bytes, uint32_t box_rows,
                 uint32_t box_pieces) {
  const cuuint64_t dims[3] = {cols, rows, pieces};
  const cuuint64_t strides[2] = {row_bytes, piece_bytes};
  const cuuint32_t box[3] = {64, box_rows, box_pieces};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_bf16 of packed [pieces, rows, cols] tables (the factor rows and
// their pieces)
bool encode_packed(CUtensorMap* map, const void* ptr, uint64_t cols,
                   uint64_t rows, uint64_t pieces, uint32_t box_rows,
                   uint32_t box_pieces) {
  return encode_bf16(map, ptr, cols, rows, pieces, cols * 2,
                     rows * cols * 2, box_rows, box_pieces);
}

}  // namespace
