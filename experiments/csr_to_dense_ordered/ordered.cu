// An experiment, not on any path of the package: the one-pass CSR -> dense
// design that writes each output cell once, with no zeroing pass and no
// atomics when the nonzeros come in the order of their cells, and falls
// back to zero + atomic scatter otherwise. compare.py in this directory
// builds it for sm_90a and times it beside the package's kernel
// (dmlc_core_tpu_torch/csrc/csr_to_dense.cu) on the same inputs.
//
// Same function as the package's kernel: dense[r, c] += val for every
// nonzero, f32, duplicates summed, r outside [0, R) or c outside [0, F)
// dropped, any order accepted.
//
// Design: one cooperative launch of 1,024-thread blocks, all resident.
//  1. The ordered path. Each nonzero has a key: twice the cell it sorts to
//     in the row-major output, plus one if it is kept (a dropped one sorts
//     to where it would lie: 0 for a negative row, the end for padding,
//     its row's start or end for a bad column). When the keys never go
//     back, as in a PaddedBatch of a libsvm file (rows in order, columns
//     ascending in each row, padding last), every nonzero owns the cells
//     from the one after its predecessor's up to its own: it writes zeros
//     to the cells between and its own cell's value. A warp takes 128
//     nonzeros a step, four neighbours a lane, one 16-byte streaming load
//     of each array a lane, the next step's loads in flight while this one
//     is written; a lane's first and last entries meet their neighbours by
//     warp shuffles. Four consecutive aligned cells go out as one 16-byte
//     store; runs of up to kLaneGap zero cells are written by their lane,
//     longer ones by the whole warp. A cell's duplicates are neighbours:
//     the first sums the run in index order (from the later lanes, then
//     from device memory past the step), the others write nothing.
//  2. A block that finds its keys going back, a run of more than kMaxRun
//     adds, or more than kMaxGap zero cells owned by one nonzero stops and
//     raises its flag in block_flags; every block meets at a grid barrier
//     and reads every flag.
//  3. If any flag is up (or the caller forced it), the general path: zero
//     the output, a grid barrier, one thread per nonzero with atomicAdd.
// path_counts[0] / [1] count launches that took the ordered / general path.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;
namespace {
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 128; // entries a warp takes a step, 4 a lane
constexpr long long kLaneGap = 256; // longest run of zero cells a lane writes alone
constexpr long long kMaxGap = 1 << 15; // most zero cells one entry owns
constexpr int kMaxRun = 32; // most adds one cell takes in order
constexpr unsigned kAll = 0xffffffffu;
// Entry (r, c)'s key: twice the cell it sorts to in the row-major R x F
// output, plus one if it is kept (then it adds to that cell). Key is int
// when 2 R F + 1 fits, else long long.
template <typename Key>
__device__ __forceinline__ Key key_of(int r, int c, int R, int F) {
  if (r < 0) return 0;
  if (r >= R) return (Key)R * F * 2;
  const Key start = (Key)r * F;
  if (c < 0) return start * 2;
  if (c >= F) return (start + F) * 2;
  return (start + c) * 2 + 1;
}

// Entries i .. i+3 of p (`fill` past nnz): one 16-byte load when the
// arrays are 16-byte aligned. The bytes past nnz share an aligned 16-byte
// line with entry i, so they lie in the same allocation.
template <typename T, typename T4>
__device__ __forceinline__ void load4(const T* __restrict__ p, long long i,
                                      long long nnz, bool vec, T fill,
                                      T (&x)[4]) {
  if (vec && i < nnz) {
    const T4 q = __ldcs(reinterpret_cast<const T4*>(p + i));
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = i + j < nnz ? __ldg(p + i + j) : fill;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j >= nnz) x[j] = fill;
}

// Zeroes out[a, b) with the whole warp: 16-byte stores where aligned.
__device__ __forceinline__ void warp_zero(float* out, long long a,
                                          long long b, int lane) {
  const long long head = min(
      b - a, (long long)((4 - ((reinterpret_cast<uintptr_t>(out + a) >> 2) &
                               3)) & 3));
  if (lane < head) out[a + lane] = 0.f;
  a += head;
  const long long body = (b - a) / 4;
  float4* const q = reinterpret_cast<float4*>(out + a);
  for (long long k = lane; k < body; k += 32)
    q[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  a += 4 * body;
  if (a + lane < b) out[a + lane] = 0.f;
}

// Zeroes out[a, b) with one lane: 16-byte stores where aligned.
__device__ __forceinline__ void lane_zero(float* out, long long a, long long b) {
  for (; a < b && (reinterpret_cast<uintptr_t>(out + a) & 15); ++a) out[a] = 0.f;
  for (; a + 4 <= b; a += 4)
    *reinterpret_cast<float4*>(out + a) = make_float4(0.f, 0.f, 0.f, 0.f);
  for (; a < b; ++a) out[a] = 0.f;
}

// Goes on summing a run of `key`'s adds in index order from entry `next`,
// eight loads at a time, while the entries add to the same cell; `n` adds
// so far. False if the run is longer than kMaxRun.
template <typename Key>
__device__ bool sum_run(const int* __restrict__ row,
                        const int* __restrict__ col,
                        const float* __restrict__ val, long long nnz, int R,
                        int F, Key key, long long next, int n, float& sum) {
  for (;; next += 8) {
    int r[8], c[8];
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = next + u < nnz;
      r[u] = in ? __ldg(row + next + u) : R;
      c[u] = in ? __ldg(col + next + u) : 0;
      v[u] = in ? __ldg(val + next + u) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (key_of<Key>(r[u], c[u], R, F) != key) return true;
      if (++n > kMaxRun) return false;
      sum += v[u];
    }
  }
}

// Loads one step: the lane's four entries, and (lanes 0 and 31) the row and
// column ids of the entries just before and just after the step.
template <typename Key>
__device__ __forceinline__ void load_step(
    const int* __restrict__ row, const int* __restrict__ col,
    const float* __restrict__ val, long long nnz, int R, bool vec,
    long long base, int lane, int (&r)[4], int (&c)[4], float (&v)[4],
    int& re, int& ce) {
  const long long i0 = base + 4 * lane;
  load4<int, int4>(row, i0, nnz, vec, R, r);
  load4<int, int4>(col, i0, nnz, vec, 0, c);
  load4<float, float4>(val, i0, nnz, vec, 0.f, v);
  const long long e = lane == 0 ? base - 1 : base + kSpan;
  re = e < 0 ? -1 : R;
  ce = 0;
  if ((lane == 0 || lane == 31) && e >= 0 && e < nnz) {
    re = __ldg(row + e);
    ce = __ldg(col + e);
  }
}

// Checks and writes one loaded step (see the design above); raises s_bad
// and returns without writing if the keys go back.
template <typename Key>
__device__ __forceinline__ void process_step(
    const int* __restrict__ row, const int* __restrict__ col,
    const float* __restrict__ val, long long nnz, int R, int F,
    float* __restrict__ out, long long base, int lane, const int (&r)[4],
    const int (&c)[4], const float (&v)[4], int re, int ce, int& s_bad) {
  Key k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) k[j] = key_of<Key>(r[j], c[j], R, F);
  const Key edge = key_of<Key>(re, ce, R, F);
  Key before = __shfl_up_sync(kAll, k[3], 1);
  Key after = __shfl_down_sync(kAll, k[0], 1);
  if (lane == 0) before = edge;
  if (lane == 31) after = edge;
  // each entry against the one before: a duplicate of a kept cell, or a
  // place no earlier than the first cell it may own, not too far on
  Key from[4];
  bool dup[4], bad = false, big = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Key p = j ? k[j - 1] : before;
    dup[j] = (k[j] & 1) && k[j] == p;
    from[j] = (p >> 1) + (p & 1);
    const Key gap = (k[j] >> 1) - from[j];
    if (!dup[j]) {
      bad |= gap < 0 || gap > kMaxGap;
      big |= gap > kLaneGap;
    }
  }
  if (__any_sync(kAll, bad)) {
    if (lane == 0) s_bad = 1;
    return;
  }
  // the zero cells each entry owns: short runs by their lane, long ones
  // by the whole warp
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Key gap = (k[j] >> 1) - from[j];
    if (!dup[j] && gap <= kLaneGap) lane_zero(out, from[j], from[j] + gap);
  }
  for (unsigned m = __ballot_sync(kAll, big); m; m &= m - 1) {
    const int src = __ffs(m) - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Key a = __shfl_sync(kAll, from[j], src);
      const Key b = __shfl_sync(kAll, k[j] >> 1, src);
      if (!__shfl_sync(kAll, (int)dup[j], src) && b - a > kLaneGap)
        warp_zero(out, a, b, lane);
    }
  }
  // each cell's value: the first of its run sums the run in index
  // order; a run that goes on past the lane is summed from the lanes
  // after it, and past the step from device memory
  Key cur = 0;
  float sum = 0.f;
  int n = 0;
  // four consecutive cells, 16-byte aligned, no run going on: one store
  const bool quad = (k[0] & 1) && !dup[0] && k[1] == k[0] + 2 && k[2] == k[0] + 4 &&
         k[3] == k[0] + 6 && after != k[3] &&
         ((reinterpret_cast<uintptr_t>(out + (k[0] >> 1)) & 15) == 0);
  if (quad)
    *reinterpret_cast<float4*>(out + (k[0] >> 1)) =
        make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (quad) break;
    if (!(k[j] & 1)) continue;
    if (!dup[j]) {
      if (n) out[cur >> 1] = sum;
      cur = k[j], sum = v[j], n = 1;
    } else if (n) {
      sum += v[j], ++n;
    }
  }
  bool open = n && k[3] == cur && after == cur;
  if (n && !open) out[cur >> 1] = sum;
  for (int t = 1; __any_sync(kAll, open); ++t) {
    Key nk[4];
    float nv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nk[j] = __shfl_down_sync(kAll, k[j], t);
      nv[j] = __shfl_down_sync(kAll, v[j], t);
    }
    if (!open) continue;
    if (lane + t > 31) {
      if (!sum_run<Key>(row, col, val, nnz, R, F, cur, base + kSpan, n,
                        sum))
        s_bad = 1;
      open = false;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!open) break;
        if (nk[j] != cur) {
          open = false;
        } else if (++n > kMaxRun) {
          s_bad = 1;
          open = false;
        } else {
          sum += nv[j];
        }
      }
    }
    if (!open) out[cur >> 1] = sum;
  }
}

template <typename Key>
__device__ __forceinline__ void general_path(
    const int* __restrict__ row, const int* __restrict__ col,
    const float* __restrict__ val, long long nnz, int R, int F,
    float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const long long cells = (long long)R * F;
  // zero, barrier, one thread per nonzero (two a step, their loads
  // independent)
  const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gstride = (long long)gridDim.x * kThreads;
  const long long c4 =
      (reinterpret_cast<uintptr_t>(out) & 15) == 0 ? cells / 4 : 0;
  for (long long q = gtid; q < c4; q += gstride)
    reinterpret_cast<float4*>(out)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = 4 * c4 + gtid; i < cells; i += gstride) out[i] = 0.f;
  grid.sync();
  for (long long i = gtid; i < nnz; i += 2 * gstride) {
    const long long i2 = i + gstride;
    const int r0 = row[i], c0 = col[i];
    const float v0 = val[i];
    const int r1 = i2 < nnz ? row[i2] : -1, c1 = i2 < nnz ? col[i2] : -1;
    const float v1 = i2 < nnz ? val[i2] : 0.f;
    if ((unsigned)r0 < (unsigned)R && (unsigned)c0 < (unsigned)F)
      atomicAdd(out + (long long)r0 * F + c0, v0);
    if ((unsigned)r1 < (unsigned)R && (unsigned)c1 < (unsigned)F)
      atomicAdd(out + (long long)r1 * F + c1, v1);
  }
}

template <typename Key>
__global__ void __launch_bounds__(kThreads, 1)
    csr_to_dense_f32_kernel(const int* __restrict__ row, const int* __restrict__ col,
                            const float* __restrict__ val, long long nnz, int R, int F,
                            float* __restrict__ out, int* __restrict__ block_flags,
                            unsigned long long* __restrict__ path_counts, int force_general) {
  __shared__ int s_bad;
  if (threadIdx.x == 0) s_bad = force_general;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool vec = ((reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(col) |
                     reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  const long long stride = (long long)gridDim.x * kWarps * kSpan;
  long long base = ((long long)(threadIdx.x / 32) * gridDim.x + blockIdx.x) * kSpan;
  int r[4], c[4]; float v[4]; int re, ce;
  if (base <= nnz) load_step<Key>(row, col, val, nnz, R, vec, base, lane, r, c, v, re, ce);
  for (; base <= nnz; base += stride) {
    if (__shfl_sync(kAll, *reinterpret_cast<volatile int*>(&s_bad), 0)) break;
    int nr[4], nc[4]; float nv[4]; int nre = R, nce = 0;
    const long long nb = base + stride;
    if (nb <= nnz) load_step<Key>(row, col, val, nnz, R, vec, nb, lane, nr, nc, nv, nre, nce);
    process_step<Key>(row, col, val, nnz, R, F, out, base, lane, r, c, v, re, ce, s_bad);
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = nr[j], c[j] = nc[j], v[j] = nv[j];
    re = nre, ce = nce;
  }
  __syncthreads();
  if (threadIdx.x == 0) block_flags[blockIdx.x] = s_bad;
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  int any = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) any |= __ldcg(block_flags + b);
  const bool general = __syncthreads_or(any);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(path_counts + (general ? 1 : 0), 1ull);
  if (!general) return;
  general_path<Key>(row, col, val, nnz, R, F, out);
}

}  // namespace

// Blocks the card holds at once: the largest cooperative grid.
extern "C" int ordered_max_blocks(void) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, csr_to_dense_f32_kernel<long long>, kThreads, 0);
  int narrow = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &narrow, csr_to_dense_f32_kernel<int>, kThreads, 0);
  return min(per_sm, narrow) * sms;
}

// One cooperative launch of `grid` blocks on `stream`; block_flags holds
// `grid` ints for this launch alone. Returns the launch's CUDA error.
extern "C" int ordered_csr_to_dense_f32(const void* row, const void* col,
                                        const void* val, long long nnz,
                                        int num_rows, int num_features,
                                        void* out, void* block_flags,
                                        void* path_counts, int force_general,
                                        int grid, void* stream) {
  const int* row_i = static_cast<const int*>(row);
  const int* col_i = static_cast<const int*>(col);
  const float* val_f = static_cast<const float*>(val);
  float* out_f = static_cast<float*>(out);
  int* flags_i = static_cast<int*>(block_flags);
  unsigned long long* counts_u =
      static_cast<unsigned long long*>(path_counts);
  void* args[] = {&row_i,        &col_i, &val_f,   &nnz,      &num_rows,
                  &num_features, &out_f, &flags_i, &counts_u,
                  &force_general};
  const void* kernel =
      (long long)num_rows * num_features < (1LL << 30)
          ? reinterpret_cast<const void*>(csr_to_dense_f32_kernel<int>)
          : reinterpret_cast<const void*>(
                csr_to_dense_f32_kernel<long long>);
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
