// Sparse-tail half-sweep for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel hgaprec_tpu/ops/pallas_tail.py::_kernel. One
// half of the hybrid sweep's tail: a stream of nonzeros sorted by its
// primary side, with primary ids p (ascending), other-side ids o, counts
// y, and factor tables P [rows_p, kq], O [rows_o, kq] (bias-augmented by
// the caller, kq a whole number of 16-byte chunks):
//
//     out[r] = sum_{j: p_j = r} w_j * P[r] (.) O[o_j],
//     w_j = y_j / max(<P[r], O[o_j]>, 1e-30)
//
// in f32. This file is the f32 route: the row sweep of row_sweep.cuh in
// its kDot mode, where the design is set out. The bf16 route, with tables
// widened on load, is tail_bf16.cu.
//
// The TPU kernel selects primary rows with one-hot matrix products, keeps
// a VMEM accumulator ring it flushes in windows, and streams other-side
// rows gathered beforehand by XLA: all of that works around a TPU core
// that cannot gather inside a kernel. Hopper gathers, so this kernel
// reads O[o_j] itself and never materialises the gathered stream.
//
// Bound on the H100: the random row gathers, one other-side row per
// nonzero (kq * 4 bytes) plus 12 bytes of ids and y.

#include "row_sweep.cuh"

// p, o: int32 [nnz], p ascending; y: f32 [nnz]; ptab: f32 [rows_p, kq],
// otab: f32 [rows_o, kq] (kq % 4 == 0, kq <= 256, 16-byte aligned); out:
// f32 [rows_p, kq], zeroed by the caller; brow: int32 [2 W], bacc: f32
// [2 W, kq] scratch, W = ceil(nnz / range) warps (range % 32 == 0).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int hpf_tail_half_sweep_f32(const void* p, const void* o,
                                       const void* y, const void* ptab,
                                       const void* otab, void* out,
                                       void* brow, void* bacc,
                                       long long nnz, int kq, int range,
                                       void* stream) {
  if (bad_row_args(ptab, otab, out, bacc, nnz, kq, range, 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kq <= 128
             ? launch_row_sweep<float, 1, kDot>(p, o, y, nullptr, nullptr,
                                                ptab, otab, out, brow, bacc,
                                                nnz, kq, range, st)
             : launch_row_sweep<float, 2, kDot>(p, o, y, nullptr, nullptr,
                                                ptab, otab, out, brow, bacc,
                                                nnz, kq, range, st);
}
