// Fused dense CAVI sweep in bf16 on mma.sync (the earlier bf16 design) and
// the stage probe built on it; sm_90a, bound to Python with ctypes.
//
// Replaces the TPU kernel hgaprec_tpu/ops/dense_pallas.py::_kernel. For a
// uint8 count matrix Y [N, M] (row stride ldy >= M) and factor tables
// A [N, kq], B [M, kq], with S = A B^T and W = Y / max(S, 1e-30):
//
//     acc_a = W B      [N, kq]        acc_b = W^T A      [M, kq]
//
// W never leaves the chip. Bias variants arrive packed by the caller as
// A = [A | ba | 1], B = [B | 1 | bb], so rowsum(W) and colsum(W) come back
// in columns k and k+1 of the same outputs. The caller zero-pads the
// factor width to kq (a multiple of 16), so every row loads in 16-byte
// chunks; padding columns produce zero outputs.
//
// Design: two deterministic roles in one launch, no atomics. The TPU
// kernel keeps acc_b resident across user tiles because its grid runs in
// order; CTAs here run in no order, so every output row is owned by one CTA.
//   * user role (pass A): one CTA per 64-user tile loops over all item
//     tiles, recomputes S and W in shared memory and accumulates acc_a.
//   * item role (pass B): one CTA per 64-item tile loops over all user
//     tiles, recomputes S and W and accumulates acc_b.
// Item-role CTAs take the low block indices: their loops over N are the
// longest jobs, so they are scheduled first. Where a shape gives too few
// CTAs to fill the card (ML-1M: 96 + 58 tiles), the caller cuts each
// role's moving loop into chunks; the chunks' partial sums are added in a
// fixed order by reduce_splits, so the result stays deterministic. The
// kernel loads the next moving tile (its factor rows and its Y block) into
// registers while it computes the current one, so a tile's memory latency
// hides behind the previous tile's products.
//
// Bound on the H100: a sweep costs 8 N M kq FLOPs (four products of
// 2 N M kq, since both roles recompute S) against two uint8 reads of Y,
// about 8 * 100 / 2 = 400 FLOPs per byte at K = 100: compute-bound. So the
// products run on the tensor cores through mma.sync, with bf16 A and B, W
// rounded to bf16 before the two contractions as the TPU kernel does, and
// f32 accumulation.
// The production routes no longer run this kernel: bf16 runs the
// wgmma/TMA design in csrc/dense_wgmma.cu, f32 ("highest") the FP32
// register-tiled kernel in csrc/dense_simt.cu. The mma.sync kernel here
// stays as the stage probe's base (below) and behind its own production
// entry, hpf_dense_fused_sweep_bf16, which the probe's prod stage is checked
// against bit for bit.
//
// Ragged edges are masked in the kernel: Y is read in place at its own
// row stride, never padded or copied. Rows of A or B past N or M load as
// zero, so S = 0 there and the clamp gives W = 0 because Y = 0.
//
// Stage probe (replaces the TPU kernel scripts/dense_mfu_probe.py::
// _kernel_variant): the bf16 kernel takes a compile-time stage. kProd is
// the production kernel, the only instantiation the production entry
// points use; each other stage removes one stage of the W computation so
// that a timing against kProd says what that stage costs:
//   * kBf16Recip: max(S, 1e-30) rounded to bf16, an approximate reciprocal
//     rounded to bf16, times Y in bf16;
//   * kNoRecip:   W = Y (no reciprocal);
//   * kNoYLoad:   W = 1, and Y is never read;
//   * kMmOnly:    only the S products; W and the contraction are skipped.
// Where a stage no longer needs S, S * 0 is added to what it computes, as
// the TPU probe's s * 0.0: the products stay (IEEE arithmetic does not let
// nvcc fold x * 0 without fast-math), and the outputs do not change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_roles.cuh"

namespace {

constexpr int kTile = 64;      // users per user tile = items per item tile
constexpr int kThreads = 256;
constexpr int kYStride = kTile + 4;
constexpr int kYQuads = kTile * kTile / 4 / kThreads;   // 4-byte groups/thread

// ---- Y tile: user-major [64][64] uint8, masked at N and M ---------------
//
// Thread t holds row t / 4, bytes (t % 4) * 16 .. +16 of the tile, as four
// 4-byte words. Rows whose stride and base are 16-byte aligned (the layout
// data/device.py builds) load with one 16-byte load; any other stride
// falls back to byte loads.

__device__ __forceinline__ uint32_t keep_low_bytes(uint32_t x, int nbytes) {
  return nbytes >= 4 ? x : nbytes <= 0 ? 0u : (x & ((1u << (8 * nbytes)) - 1u));
}

__device__ __forceinline__ void load_y(uint32_t (&v)[kYQuads],
                                       const uint8_t* __restrict__ y,
                                       long long ldy, int n, int m, int u0,
                                       int c0, int tid) {
  const int r = tid / 4, c = c0 + (tid % 4) * 16;
#pragma unroll
  for (int i = 0; i < kYQuads; ++i) v[i] = 0u;
  if (u0 + r >= n || c >= m) return;
  const uint8_t* row = y + (long long)(u0 + r) * ldy + c;
  const int valid = m - c;   // bytes of this 16-byte run inside M
  if (((ldy | reinterpret_cast<uintptr_t>(y)) & 15) == 0) {
    // c and ldy are multiples of 16 and c < m <= ldy, so the 16-byte run
    // ends inside this row's stride
    const uint4 w = *reinterpret_cast<const uint4*>(row);
    v[0] = keep_low_bytes(w.x, valid);
    v[1] = keep_low_bytes(w.y, valid - 4);
    v[2] = keep_low_bytes(w.z, valid - 8);
    v[3] = keep_low_bytes(w.w, valid - 12);
    return;
  }
#pragma unroll
  for (int i = 0; i < kYQuads; ++i) {
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * i + e < valid) w |= (uint32_t)row[4 * i + e] << (8 * e);
    v[i] = w;
  }
}

__device__ __forceinline__ void store_y(uint8_t* ys,
                                        const uint32_t (&v)[kYQuads],
                                        int tid) {
  const int r = tid / 4, c = (tid % 4) * 16;
#pragma unroll
  for (int i = 0; i < kYQuads; ++i)
    *reinterpret_cast<uint32_t*>(ys + r * kYStride + c + 4 * i) = v[i];
}

// ---- factor rows: 64 rows x kq in 16-byte chunks, zero past `rows` -------

template <int kChunks, int kPerChunk, typename T>
__device__ __forceinline__ void load_rows(uint4 (&v)[kChunks],
                                          const T* __restrict__ src,
                                          int rows, int r0, int kq, int tid) {
  const int cpr = kq / kPerChunk;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / cpr, q = c - r * cpr;
    v[i] = (r < kTile && r0 + r < rows)
               ? *reinterpret_cast<const uint4*>(
                     src + (long long)(r0 + r) * kq + q * kPerChunk)
               : make_uint4(0, 0, 0, 0);
  }
}

// =========================================================================
// bf16 on tensor cores: the three products as mma.sync m16n8k16 (bf16
// inputs, f32 accumulate), the TPU kernel's own arithmetic.
// =========================================================================

constexpr int kBfPad = 8;                  // bf16 elements of row padding
constexpr int kLdT = kTile + kBfPad;       // row stride of the W tile

// The stage probe's variants (values as ops/dense_probe.py names them).
enum Stage : int {
  kProd = 0,
  kBf16Recip = 1,
  kNoRecip = 2,
  kNoYLoad = 3,
  kMmOnly = 4
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices, transposed on the way: lane l gives the address
// of row l % 8 of matrix l / 8 (16-byte aligned).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

size_t smem_bytes_bf16(int kq) {
  const size_t ldk = kq + kBfPad;
  return sizeof(__nv_bfloat16) * (2 * kTile * ldk     // stationary, moving
                                  + kTile * kLdT)      // W tile
         + (size_t)kTile * kYStride;                   // Y tile (uint8)
}

// chunks -> row-major rows rows[r][k] (row stride ldk)
template <int kChunks>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* rows, int ldk,
                                                const uint4 (&v)[kChunks],
                                                int kq, int tid) {
  const int cpr = kq / 8;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / cpr, q = c - r * cpr;
    if (r < kTile) *reinterpret_cast<uint4*>(rows + r * ldk + q * 8) = v[i];
  }
}

// Thread layout (8 warps): warp w owns the 16 rows rb = w % 4 of the 64-row
// tile; for S it owns columns (w / 4) * 32 .. +32 of the 64-wide moving
// tile, for the contraction the n-tiles (w / 4) * KP_MAX / 16 .. of kq.
template <int KP_MAX, int kStage>
__global__ void __launch_bounds__(kThreads, KP_MAX <= 128 ? 2 : 1)
dense_fused_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        const uint8_t* __restrict__ y,
                        float* __restrict__ acc_a, float* __restrict__ acc_b,
                        float* __restrict__ part_a, float* __restrict__ part_b,
                        int n, int m, int kq, long long ldy, int split_a,
                        int split_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = kq + kBfPad;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* zs = xs + kTile * ldk;     // [z][k]
  __nv_bfloat16* ws = zs + kTile * ldk;     // [x][z]
  uint8_t* ys = reinterpret_cast<uint8_t*>(ws + kTile * kLdT);

  const Role role = role_of<kTile, kTile>(n, m, kq, split_a, split_b, acc_a,
                                          acc_b, part_a, part_b);
  const bool item_role = role.item;
  const __nv_bfloat16* xsrc = item_role ? b : a;
  const __nv_bfloat16* zsrc = item_role ? a : b;
  float* out = role.out;
  const int nx = item_role ? m : n;
  const int nz = item_role ? n : m;
  const int x0 = role.x0;
  const int tid = threadIdx.x;
  constexpr int kChunks = kTile * KP_MAX / 8 / kThreads;
  constexpr bool kReadsY = kStage <= kNoRecip;

  uint4 vz[kChunks];
  load_rows<kChunks, 8>(vz, xsrc, nx, x0, kq, tid);
  store_rows_bf16(xs, ldk, vz, kq, tid);
  uint32_t vy[kYQuads];
  const int zb = role.z_begin;
  load_rows<kChunks, 8>(vz, zsrc, nz, zb, kq, tid);
  if (kReadsY)
    load_y(vy, y, ldy, n, m, item_role ? zb : x0, item_role ? x0 : zb, tid);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // mma fragment coordinates
  const int rb = (warp % 4) * 16;           // this warp's 16 rows
  const int half = warp / 4;
  constexpr int kNt = KP_MAX / 16;          // n-tiles of 8 per warp
  float acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int z0 = role.z_begin; z0 < role.z_end; z0 += kTile) {
    __syncthreads();  // previous tile's readers are done (and xs is stored)
    store_rows_bf16(zs, ldk, vz, kq, tid);
    if (kReadsY) store_y(ys, vy, tid);
    __syncthreads();
    const int zn = z0 + kTile;
    if (zn < role.z_end) {  // next tile's loads fly while this computes
      load_rows<kChunks, 8>(vz, zsrc, nz, zn, kq, tid);
      if (kReadsY)
        load_y(vy, y, ldy, n, m, item_role ? zn : x0, item_role ? x0 : zn,
               tid);
    }

    // S[x][z] for x in rb..rb+16, z in half*32..+32
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int k0 = 0; k0 < kq; k0 += 16) {
      const __nv_bfloat16* xr = xs + (rb + g) * ldk + k0 + 2 * t;
      const uint32_t fa[4] = {ld32(xr), ld32(xr + 8 * ldk), ld32(xr + 8),
                              ld32(xr + 8 * ldk + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* zr =
            zs + (half * 32 + j * 8 + g) * ldk + k0 + 2 * t;
        const uint32_t fb[2] = {ld32(zr), ld32(zr + 8)};
        mma_bf16(s[j], fa, fb);
      }
    }
    if constexpr (kStage == kMmOnly) {
      // the outputs depend on S (and stay zero); no W, no contraction
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(s[j][e], 0.f, acc[j][e]);
      continue;
    }
    // W = Y / max(S, 1e-30), rounded to bf16. The correctly rounded
    // reciprocal times Y is within an f32 ulp of the quotient, far below
    // the bf16 rounding that follows, and costs a fraction of an IEEE
    // divide, which was the kernel's largest single cost.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = rb + g + 8 * h;
        const int z = half * 32 + j * 8 + 2 * t;
        float w[2];
        __nv_bfloat16 wb[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[j][2 * h + e];
          float yv = 1.f;
          if constexpr (kReadsY)
            yv = (float)(item_role ? ys[(z + e) * kYStride + x]
                                   : ys[x * kYStride + z + e]);
          if constexpr (kStage == kProd) {
            w[e] = yv * __frcp_rn(fmaxf(sv, 1e-30f));
          } else if constexpr (kStage == kBf16Recip) {
            const __nv_bfloat16 sc = __float2bfloat16_rn(fmaxf(sv, 1e-30f));
            const __nv_bfloat16 r =
                __float2bfloat16_rn(__fdividef(1.f, __bfloat162float(sc)));
            wb[e] = __hmul(__float2bfloat16_rn(yv), r);
          } else {    // kNoRecip: W = Y; kNoYLoad: W = 1; S kept live
            w[e] = fmaf(sv, 0.f, yv);
          }
        }
        __nv_bfloat162 w2;
        if constexpr (kStage == kBf16Recip)
          w2 = __halves2bfloat162(wb[0], wb[1]);
        else
          w2 = __floats2bfloat162_rn(w[0], w[1]);
        *reinterpret_cast<__nv_bfloat162*>(ws + x * kLdT + z) = w2;
      }
    }
    __syncthreads();

    // acc[x][kk] += sum_z W[x][z] Z[z][kk]; the B fragments (k = z,
    // n = kk) come straight from the row-major zs through ldmatrix.trans,
    // two n-tiles per load (lanes 16-31 address the second)
    for (int zk = 0; zk < kTile; zk += 16) {
      const __nv_bfloat16* wr = ws + (rb + g) * kLdT + zk + 2 * t;
      const uint32_t fa[4] = {ld32(wr), ld32(wr + 8 * kLdT), ld32(wr + 8),
                              ld32(wr + 8 * kLdT + 8)};
#pragma unroll
      for (int j = 0; j < kNt; j += 2) {
        const int nt = half * kNt + j;
        if (nt * 8 >= kq) break;            // warp-uniform
        uint32_t fb[4];
        ldsm_x4_trans(fb, zs + (zk + lane % 16) * ldk + nt * 8 +
                              (lane / 16) * 8);
        const uint32_t b0[2] = {fb[0], fb[1]};
        const uint32_t b1[2] = {fb[2], fb[3]};
        mma_bf16(acc[j], fa, b0);
        if ((nt + 1) * 8 < kq) mma_bf16(acc[j + 1], fa, b1);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    const int col = (half * kNt + j) * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gx = x0 + rb + g + 8 * (e / 2);
      const int c = col + (e % 2);
      if (gx < nx && c < kq) out[(long long)gx * kq + c] = acc[j][e];
    }
  }
}

// =========================================================================
// launchers
// =========================================================================

template <typename Kernel>
int launch_kernel(Kernel kernel, size_t smem, const void* a, const void* b,
                  const void* y, void* acc_a, void* acc_b, void* part_a,
                  void* part_b, int n, int m, int kq, long long ldy,
                  int split_a, int split_b, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_a = (n + kTile - 1) / kTile;
  const int tiles_b = (m + kTile - 1) / kTile;
  kernel<<<tiles_a * split_a + tiles_b * split_b, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const uint8_t*>(y),
      static_cast<float*>(acc_a), static_cast<float*>(acc_b),
      static_cast<float*>(part_a), static_cast<float*>(part_b), n, m, kq, ldy,
      split_a, split_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(acc_a, acc_b, part_a, part_b, n, m, kq, split_a,
                         split_b, stream);
}

template <int kStage = kProd>
int launch(const void* a, const void* b, const void* y, void* acc_a,
           void* acc_b, void* part_a, void* part_b, int n, int m, int kq,
           long long ldy, int split_a, int split_b, void* stream) {
  // the probe's stages are built for rows of up to 128 values only
  const int kq_max = kStage == kProd ? 256 : 128;
  if (n <= 0 || m <= 0 || kq <= 0 || kq > kq_max || kq % 16 != 0 ||
      ldy < m || split_a < 1 || split_b < 1 ||
      (split_a > 1 && part_a == nullptr) ||
      (split_b > 1 && part_b == nullptr) ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes_bf16(kq);
  if constexpr (kStage != kProd)
    return launch_kernel(dense_fused_bf16_kernel<128, kStage>, smem, a, b, y,
                         acc_a, acc_b, part_a, part_b, n, m, kq, ldy, split_a,
                         split_b, st);
  return kq <= 128
             ? launch_kernel(dense_fused_bf16_kernel<128, kProd>, smem, a, b,
                             y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy,
                             split_a, split_b, st)
             : launch_kernel(dense_fused_bf16_kernel<256, kProd>, smem, a, b,
                             y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy,
                             split_a, split_b, st);
}

}  // namespace

// a: bf16 [n, kq], b: bf16 [m, kq] (kq % 16 == 0, 16-byte aligned), y: u8
// [>= n rows, ldy >= m]; outputs f32 [n, kq] and [m, kq]; W is rounded to
// bf16 before the contractions. split_a/split_b cut the user/item role's
// moving tiles into that many chunks; a role with split > 1 needs scratch
// part_* of f32 [split, rows, kq]. Returns the cudaError_t of the launches
// (0 = success).
extern "C" int hpf_dense_fused_sweep_bf16(const void* a, const void* b,
                                          const void* y, void* acc_a,
                                          void* acc_b, void* part_a,
                                          void* part_b, int n, int m, int kq,
                                          long long ldy, int split_a,
                                          int split_b, void* stream) {
  return launch(a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy, split_a,
                split_b, stream);
}

// The stage probe: the bf16 entry above with the kernel built for stage
// `stage` (0 = production, 1 = bf16recip, 2 = norecip, 3 = noyload,
// 4 = mmonly; see the top of this file), kq <= 128 only.
extern "C" int hpf_dense_probe_bf16(const void* a, const void* b,
                                    const void* y, void* acc_a, void* acc_b,
                                    void* part_a, void* part_b, int n, int m,
                                    int kq, long long ldy, int split_a,
                                    int split_b, int stage, void* stream) {
  switch (stage) {
    case kProd:
      return launch<kProd>(a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq, ldy,
                           split_a, split_b, stream);
    case kBf16Recip:
      return launch<kBf16Recip>(a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq,
                                ldy, split_a, split_b, stream);
    case kNoRecip:
      return launch<kNoRecip>(a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq,
                              ldy, split_a, split_b, stream);
    case kNoYLoad:
      return launch<kNoYLoad>(a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq,
                              ldy, split_a, split_b, stream);
    case kMmOnly:
      return launch<kMmOnly>(a, b, y, acc_a, acc_b, part_a, part_b, n, m, kq,
                             ldy, split_a, split_b, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
