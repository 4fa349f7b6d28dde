// CSR segment sweep for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel docs/design/pallas_csr_sweep.py::
// _sweep_pass_kernel (entry sweep_pallas). One whole CAVI sweep over the
// dual-sorted COO of data/device.py, in two passes over all nonzeros, with
// f32 tables A = [A | ba | 1] [n, kq] and B = [B | 1 | bb] [m, kq]:
//
//   user pass, stream sorted by user (u ascending, i, y):
//     w_j = y_j / max(<A[u_j], B[i_j]>, 1e-30), stored at w[j];
//     acc_a[u] = sum_{j: u_j = u} w_j * A[u] (.) B[i_j]
//   item pass, stream sorted by item (i ascending, u, position in the
//   user-sorted stream item_order):
//     acc_b[i] = sum_{t: i_t = i} w[item_order[t]] * B[i] (.) A[u_t]
//
// Columns k and k + 1 of the augmented tables deliver the bias sums:
// acc_a[:, k] and acc_b[:, k + 1]. The item pass reads each weight through
// item_order itself: it never recomputes the dot product, and no permuted
// copy of w is written.
//
// The TPU kernel gives one grid step per 256-row tile, which its in-order
// core runs one after another. On a parallel grid that shape would leave
// the item pass to the few tiles holding the popular items (at EchoNest
// 4,096 of 381k items hold 81% of the nonzeros) while the rest of the card
// idles. So both passes cut the sorted stream into fixed ranges of
// nonzeros, one warp each, whatever the rows: the row sweep of
// row_sweep.cuh (kDotStore for the user pass, kGather for the item pass),
// whose fix-up adds the rows cut by a range in a fixed order. No float
// atomics, and two launches give the same bits.
//
// Bound on the H100: the random row gathers, twice per nonzero: B[i_j]
// (kq * 4 bytes) and 12 bytes of ids and y in the user pass; A[u_t]
// (kq * 4 bytes), 12 bytes of ids and order, and a random 4-byte w read
// (a 32-byte sector) in the item pass. Padding entries (y = 0, ids = last
// row) get w = 0 and add nothing.
//
// Precision: f32 tables always, as the JAX segment path (it ignores the
// matmul precision flag).

#include "row_sweep.cuh"

namespace {

template <int kNch>
int sweep_both(const void* u, const void* i, const void* y,
               const void* item_order, const void* i_sorted,
               const void* u_by_item, const void* atab, const void* btab,
               void* acc_a, void* acc_b, void* w, void* brow, void* bacc,
               long long nnz, int kq, int range, cudaStream_t st) {
  const int err = launch_row_sweep<float, kNch, kDotStore>(
      u, i, y, nullptr, w, atab, btab, acc_a, brow, bacc, nnz, kq, range,
      st);
  if (err != 0) return err;
  // the same stream orders the item pass after the user pass: the weights
  // are complete and the scratch slots free again
  return launch_row_sweep<float, kNch, kGather>(
      i_sorted, u_by_item, w, item_order, nullptr, btab, atab, acc_b, brow,
      bacc, nnz, kq, range, st);
}

}  // namespace

// u, i: int32 [nnz] user-sorted (u ascending); y: f32 [nnz]; item_order:
// int32 [nnz], the user-sorted positions in item order; i_sorted,
// u_by_item: int32 [nnz] the ids in that order (i ascending). atab: f32
// [n, kq], btab: f32 [m, kq] (kq % 4 == 0, kq <= 256, 16-byte aligned);
// acc_a: f32 [n, kq], acc_b: f32 [m, kq], zeroed by the caller; w: f32
// [nnz] scratch; brow: int32 [2 W], bacc: f32 [2 W, kq] scratch, W =
// ceil(nnz / range) warps (range % 32 == 0). Returns the cudaError_t of
// the launches (0 = success).
extern "C" int hpf_segment_sweep_f32(const void* u, const void* i,
                                     const void* y, const void* item_order,
                                     const void* i_sorted,
                                     const void* u_by_item, const void* atab,
                                     const void* btab, void* acc_a,
                                     void* acc_b, void* w, void* brow,
                                     void* bacc, long long nnz, int kq,
                                     int range, void* stream) {
  if (bad_row_args(atab, btab, acc_a, bacc, nnz, kq, range, 4) ||
      (reinterpret_cast<uintptr_t>(acc_b) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kq <= 128 ? sweep_both<1>(u, i, y, item_order, i_sorted, u_by_item,
                                   atab, btab, acc_a, acc_b, w, brow, bacc,
                                   nnz, kq, range, st)
                   : sweep_both<2>(u, i, y, item_order, i_sorted, u_by_item,
                                   atab, btab, acc_a, acc_b, w, brow, bacc,
                                   nnz, kq, range, st);
}
