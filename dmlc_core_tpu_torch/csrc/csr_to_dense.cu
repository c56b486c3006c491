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
// atomics, so this is the direct form: a grid-stride loop, one thread per
// nonzero, an atomicAdd (a fire-and-forget RED, since the result is
// unused) into an output the caller has zeroed. The kernel allocates
// nothing and launches on the caller's stream.
//
// Bound. The work is memory traffic: each nonzero's row id is read, the
// column id only where the row is in range and the value only where the
// nonzero is kept, and the [num_rows, num_features] f32 output is written
// once (and zeroed once before, by the caller). At the training shape,
// 65,536 rows x 28 features (1,835,008 kept nonzeros) in a 2,097,152-entry
// nnz bucket, that is 4 B x 2,097,152 + 8 B x 1,835,008 = 23.1 MB of
// reads and 7.3 MB of output, 30.4 MB or about 9.1 us at the H100 SXM's
// 3.35 TB/s (11.3 us counting the zeroing pass). The f32 adds (one per
// kept nonzero) are far below the card's rate. Atomics make the order of
// duplicate sums vary from run to run; with no duplicates each cell gets
// exactly one add onto zero and the result is exact.

#include <cuda_runtime.h>

namespace {

__global__ void csr_to_dense_f32_kernel(const int* __restrict__ row,
                                        const int* __restrict__ col,
                                        const float* __restrict__ val,
                                        long long nnz, int num_rows,
                                        int num_features,
                                        float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nnz; i += stride) {
    const int r = row[i];
    if ((unsigned)r >= (unsigned)num_rows) continue;  // padding or invalid
    const int c = col[i];
    if ((unsigned)c < (unsigned)num_features) {
      atomicAdd(out + (long long)r * num_features + c, val[i]);
    }
  }
}

}  // namespace

// Launches the scatter on `stream`; returns cudaGetLastError() (0 when the
// launch was accepted). nnz must be > 0.
extern "C" int dct_csr_to_dense_f32(const void* row, const void* col,
                                    const void* val, long long nnz,
                                    int num_rows, int num_features,
                                    void* out, void* stream) {
  const int threads = 256;
  long long blocks = (nnz + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest
  if (blocks > 132 * 64) blocks = 132 * 64;
  csr_to_dense_f32_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const int*)row, (const int*)col, (const float*)val, nnz, num_rows,
      num_features, (float*)out);
  return (int)cudaGetLastError();
}
