// CSR -> dense materialization for Hopper (sm_90a).
//
// Replaces the TPU kernel dmlc_core_tpu/ops/pallas_kernels.py::
// _csr_scatter_kernel (launched through _csr_to_dense_call and
// csr_to_dense_pallas). Same function: dense[r, c] += val for every
// nonzero, full f32 accumulation, duplicates summed, nonzeros with
// r outside [0, num_rows) (PaddedBatch padding has r == num_rows) or c
// outside [0, num_features) dropped, no row order assumed.
//
// Design. The TPU version recasts the scatter as a one-hot matmul on the
// MXU because the TPU has no fast random writes. Hopper has fast global
// atomics, so this is the direct form: the output is zeroed with
// cudaMemsetAsync, then one thread per nonzero loads its row id, column
// id and value at once (three independent loads, none waiting on
// another) and adds the value with atomicAdd (a fire-and-forget RED into
// L2, since the result is unused). The loads are streaming (__ldcs,
// evict-first): the inputs are read once, and the output's lines, which
// the REDs update, stay in L2. Both steps go on the caller's stream; the
// function allocates nothing.
//
// Why two steps and atomics: a one-pass design that writes each cell once
// in the order of the nonzeros needs a grid barrier to learn whether that
// order holds, and on an H100 the barrier costs what the zeroing saves
// (experiments/csr_to_dense_ordered/ times it beside this kernel).
//
// Bound. The work is memory traffic: each nonzero's row id is read, the
// column id where the row is in range and the value where the nonzero is
// kept, and the [num_rows, num_features] f32 output is written once. At
// the training shape, 65,536 rows x 28 features (1,835,008 kept nonzeros)
// in a 2,097,152-entry nnz bucket, that is 4 B x 2,097,152 + 8 B x
// 1,835,008 = 23.1 MB of reads and 7.3 MB of output, 30.4 MB or about
// 9.1 us at the H100 SXM's 3.35 TB/s. This kernel also reads the
// padding's column ids and values (2.1 MB there) and zeroes the output
// first (7.3 MB more). The f32 adds (one per kept nonzero) are far below
// the card's rate. Atomics make the order of duplicate sums vary from run
// to run; with no duplicates each cell gets exactly one add onto zero and
// the result is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    csr_to_dense_f32_kernel(const int* __restrict__ row,
                            const int* __restrict__ col,
                            const float* __restrict__ val, long long nnz,
                            int num_rows, int num_features,
                            float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nnz) return;
  const int r = __ldcs(row + i);
  const int c = __ldcs(col + i);
  const float v = __ldcs(val + i);
  if ((unsigned)r < (unsigned)num_rows &&
      (unsigned)c < (unsigned)num_features)
    atomicAdd(out + (long long)r * num_features + c, v);
}

}  // namespace

// Zeroes `out` ([num_rows, num_features] f32) and scatters the nonzeros
// into it, both on `stream`; returns the first CUDA error (0 when both
// were accepted). With nnz == 0 only the zeroing runs.
extern "C" int dct_csr_to_dense_f32(const void* row, const void* col,
                                    const void* val, long long nnz,
                                    int num_rows, int num_features,
                                    void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * (size_t)num_rows * (size_t)num_features, st);
  if (err == cudaSuccess && nnz > 0) {
    const long long blocks = (nnz + kThreads - 1) / kThreads;
    csr_to_dense_f32_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int*>(row), static_cast<const int*>(col),
        static_cast<const float*>(val), nnz, num_rows, num_features,
        static_cast<float*>(out));
    err = cudaGetLastError();
  }
  return (int)err;
}
