// Factorization-machine margin and its gradient over one sorted CSR shard,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the FM margin with a
// gather and two segment sums (jnp/XLA ops, models/fm.py::_fm_margin_csr),
// and reaches no pl.pallas_call there. The port ran the same gather
// (index_select) and segment sums (index_add_) as torch ops, whose atomics
// ran over the whole padded nnz bucket; this pair computes the same
// function over the useful nonzeros only.
//
// The shard. Per-nonzero row ids (row), column ids (col) and values (val)
// of one PaddedBatch shard; row ids in [0, num_rows) are useful, and
// num_rows marks padding. Every batcher of the port and the scoring server
// lay a shard out in row order with the padding at the tail, so row r's
// nonzeros are [lower_bound(r), lower_bound(r + 1)) of the row plane and
// the useful ones end where row num_rows begins. The forward first checks
// that order (dct_fm_csr_forward_f32 sets *unsorted when some row id
// exceeds the next one); a shard out of order takes a slower path of
// per-nonzero atomics that gives the same function. Column ids outside
// [0, num_features) are dropped.
//
// Factor tiles. The kernels hold at most kMaxRank factors of a row in
// registers; a rank above that is walked one tile of kMaxRank factors at
// a time, each tile a pass over the row's nonzeros (forward) or over the
// block's chunk with a column table of its own (backward).
//
// Forward (fm_csr_forward_kernel): one thread a row finds its range with
// two binary searches of the row plane, then walks its own nonzeros and
// keeps the linear term, s1 = sum V[c] x and s2 = sum (V[c] x)^2 in
// registers. It writes the margin b + linear + 0.5 * sum_f (s1^2 - s2)
// and s1, which the backward needs. It never reads the padding beyond the
// searches' probes, never builds the [nnz, k] gather, and adds nothing
// atomically. Out of order, fm_csr_scatter_kernel adds each useful
// nonzero's terms into its row atomically and fm_csr_finish_kernel forms
// the margin.
//
// Backward (fm_csr_backward_kernel): given g = dL/dmargin [num_rows],
//   grad_b     = sum_r g[r]
//   grad_w[c] += g[r] x
//   grad_v[c] += g[r] x (s1[r] - V[c] x)
// for every useful nonzero (r, c, x). grad_w and grad_v are dense (zeroed
// here first). One thread a nonzero, a block a chunk of kChunk nonzeros;
// in row order a block past the useful nonzeros returns at once.
// Columns repeat across rows (every row of a Criteo batch holds the
// integer fields' columns, and each categorical field's top value recurs
// in about a quarter of the rows), so a block first adds into a table in
// shared memory keyed by column (open addressing, a few linear probes),
// and flushes each entry once to global memory at the end; a nonzero whose
// column finds no slot adds to global memory directly. Global adds of a
// factor row go four floats at a time where the rank allows.
//
// Both entry points run on the caller's stream and allocate nothing; they
// return the first CUDA error (0 when everything was accepted).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxRank = 64;          // factors of a tile, in registers
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kScanThreads = 256;     // order check and scatter path
constexpr unsigned kScanBlocks = 1056;  // 8 a streaming multiprocessor
constexpr long long kChunk = 4096;    // nonzeros a backward block covers
constexpr int kProbes = 8;            // linear probes of the column table
constexpr int kTableBytes = 40 << 10; // shared memory of the column table
constexpr int kEmpty = -1;

// first index in [lo, hi) whose row id is >= r (hi when none)
__device__ __forceinline__ long long lower_bound(const int* __restrict__ row,
                                                 long long lo, long long hi,
                                                 int r) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(row + mid) < r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// *unsorted = 1 when some row id exceeds the next one
__global__ void __launch_bounds__(kScanThreads)
    fm_csr_order_kernel(const int* __restrict__ row, long long nnz,
                        int* __restrict__ unsorted) {
  bool bad = false;
  for (long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
       i + 1 < nnz; i += (long long)gridDim.x * kScanThreads) {
    bad |= __ldg(row + i) > __ldg(row + i + 1);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *unsorted = 1;
}

template <int KM>
__global__ void __launch_bounds__(kFwdThreads)
    fm_csr_forward_kernel(const int* __restrict__ row,
                          const int* __restrict__ col,
                          const float* __restrict__ val, long long nnz,
                          int num_rows, int num_features, int k,
                          const float* __restrict__ b,
                          const float* __restrict__ w,
                          const float* __restrict__ v, bool vec,
                          const int* __restrict__ unsorted,
                          float* __restrict__ margin,
                          float* __restrict__ s1_out) {
  const int r = blockIdx.x * kFwdThreads + threadIdx.x;
  if (r >= num_rows) return;
  float* out = s1_out + (long long)r * k;
  if (*unsorted) {  // the scatter path adds into zeroed sums
    margin[r] = 0.f;
    for (int f = 0; f < k; ++f) out[f] = 0.f;
    return;
  }
  const long long lo = lower_bound(row, 0, nnz, r);
  const long long hi = lower_bound(row, lo, nnz, r + 1);
  float lin = 0.f;
  float inter = 0.f;
  float s1[KM];
  float s2[KM];
  for (int t0 = 0; t0 < k; t0 += KM) {
    const int kt = min(KM, k - t0);
#pragma unroll
    for (int f = 0; f < KM; ++f) {
      s1[f] = 0.f;
      s2[f] = 0.f;
    }
    for (long long i = lo; i < hi; ++i) {
      const int c = __ldg(col + i);
      const float x = __ldg(val + i);
      if ((unsigned)c >= (unsigned)num_features) continue;
      if (t0 == 0) lin += __ldg(w + c) * x;
      const float* vc = v + (long long)c * k + t0;
      if (KM % 4 == 0 && vec) {
#pragma unroll
        for (int f = 0; f < KM; f += 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(vc + f));
          const float p0 = q.x * x, p1 = q.y * x, p2 = q.z * x,
                      p3 = q.w * x;
          s1[f] += p0;
          s1[f + 1] += p1;
          s1[f + 2] += p2;
          s1[f + 3] += p3;
          s2[f] += p0 * p0;
          s2[f + 1] += p1 * p1;
          s2[f + 2] += p2 * p2;
          s2[f + 3] += p3 * p3;
        }
      } else {
#pragma unroll
        for (int f = 0; f < KM; ++f) {
          if (f < kt) {
            const float t = __ldg(vc + f) * x;
            s1[f] += t;
            s2[f] += t * t;
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < KM; ++f) {
      if (f < kt) {
        inter += s1[f] * s1[f] - s2[f];
        out[t0 + f] = s1[f];
      }
    }
  }
  margin[r] = (__ldg(b) + lin) + 0.5f * inter;
}

// Out of order: each useful nonzero adds V[c] x into s1 of its row and
// w[c] x - 0.5 sum_f (V[c, f] x)^2 into its margin
__global__ void __launch_bounds__(kScanThreads)
    fm_csr_scatter_kernel(const int* __restrict__ row,
                          const int* __restrict__ col,
                          const float* __restrict__ val, long long nnz,
                          int num_rows, int num_features, int k,
                          const float* __restrict__ w,
                          const float* __restrict__ v,
                          const int* __restrict__ unsorted,
                          float* __restrict__ margin,
                          float* __restrict__ s1) {
  if (!*unsorted) return;
  for (long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
       i < nnz; i += (long long)gridDim.x * kScanThreads) {
    const int r = __ldg(row + i);
    const int c = __ldg(col + i);
    if ((unsigned)r >= (unsigned)num_rows ||
        (unsigned)c >= (unsigned)num_features)
      continue;
    const float x = __ldg(val + i);
    const float* vc = v + (long long)c * k;
    float* sr = s1 + (long long)r * k;
    float acc = __ldg(w + c) * x;
    for (int f = 0; f < k; ++f) {
      const float t = __ldg(vc + f) * x;
      atomicAdd(sr + f, t);
      acc -= 0.5f * t * t;
    }
    atomicAdd(margin + r, acc);
  }
}

// Out of order: margin[r] = b + margin[r] + 0.5 * sum_f s1[r, f]^2
__global__ void __launch_bounds__(kFwdThreads)
    fm_csr_finish_kernel(int num_rows, int k, const float* __restrict__ b,
                         const int* __restrict__ unsorted,
                         const float* __restrict__ s1,
                         float* __restrict__ margin) {
  const int r = blockIdx.x * kFwdThreads + threadIdx.x;
  if (r >= num_rows || !*unsorted) return;
  const float* sr = s1 + (long long)r * k;
  float sq = 0.f;
  for (int f = 0; f < k; ++f) sq += sr[f] * sr[f];
  margin[r] = (__ldg(b) + margin[r]) + 0.5f * sq;
}

// grad_w[c] += gx (when gw is given) and grad_v[c, :kt] += cv[:kt],
// straight to global memory; gv points at the tile's first factor
template <int KM>
__device__ __forceinline__ void add_global(float* __restrict__ gw,
                                           float* __restrict__ gv, int c,
                                           int k, int kt, bool vec, float gx,
                                           const float* cv) {
  if (gw != nullptr) atomicAdd(gw + c, gx);
  float* row = gv + (long long)c * k;
  if (KM % 4 == 0 && vec) {
#pragma unroll
    for (int f = 0; f < KM; f += 4) {
      atomicAdd(reinterpret_cast<float4*>(row + f),
                make_float4(cv[f], cv[f + 1], cv[f + 2], cv[f + 3]));
    }
  } else {
#pragma unroll
    for (int f = 0; f < KM; ++f) {
      if (f < kt) atomicAdd(row + f, cv[f]);
    }
  }
}

template <int KM>
__global__ void __launch_bounds__(kBwdThreads)
    fm_csr_backward_kernel(const int* __restrict__ row,
                           const int* __restrict__ col,
                           const float* __restrict__ val, long long nnz,
                           int num_rows, int num_features, int k,
                           int slots_log2, bool vec,
                           const float* __restrict__ v,
                           const float* __restrict__ g,
                           const float* __restrict__ s1,
                           const int* __restrict__ unsorted,
                           float* __restrict__ gb, float* __restrict__ gw,
                           float* __restrict__ gv) {
  extern __shared__ float table[];
  const int slots = 1 << slots_log2;
  const int stride = min(k, KM) + 1;  // [grad_w, a tile of grad_v] a slot
  int* keys = reinterpret_cast<int*>(table);
  float* acc = table + slots;
  __shared__ long long used_s;

  // grad_b: this block's share of the rows, a warp sum each
  const int per_block = (num_rows + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per_block;
  const int r1 = min(num_rows, r0 + per_block);
  float part = 0.f;
  for (int r = r0 + threadIdx.x; r < r1; r += kBwdThreads) part += g[r];
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0 && r0 < r1) atomicAdd(gb, part);

  const long long begin = (long long)blockIdx.x * kChunk;
  if (threadIdx.x == 0)
    used_s = *unsorted ? nnz : lower_bound(row, 0, nnz, num_rows);
  __syncthreads();
  const long long end = min(begin + kChunk, used_s);
  if (begin >= end) return;  // past the useful nonzeros: nothing to add

  float cv[KM];
  for (int t0 = 0; t0 < k; t0 += KM) {
    const int kt = min(KM, k - t0);
    float* gw_t = t0 == 0 ? gw : nullptr;  // grad_w with the first tile
    for (int s = threadIdx.x; s < slots; s += kBwdThreads) keys[s] = kEmpty;
    for (int s = threadIdx.x; s < slots * stride; s += kBwdThreads)
      acc[s] = 0.f;
    __syncthreads();
    for (long long i = begin + threadIdx.x; i < end; i += kBwdThreads) {
      const int r = __ldg(row + i);
      const int c = __ldg(col + i);
      if ((unsigned)r >= (unsigned)num_rows ||
          (unsigned)c >= (unsigned)num_features)
        continue;
      const float x = __ldg(val + i);
      const float gx = __ldg(g + r) * x;
      const float* vc = v + (long long)c * k + t0;
      const float* sr = s1 + (long long)r * k + t0;
#pragma unroll
      for (int f = 0; f < KM; ++f) {
        cv[f] = f < kt ? gx * (__ldg(sr + f) - __ldg(vc + f) * x) : 0.f;
      }
      // the column's slot: its own, or an empty one claimed for it
      int slot = -1;
      unsigned h = ((unsigned)c * 2654435761u) >> (32 - slots_log2);
      for (int p = 0; p < kProbes; ++p, h = (h + 1) & (slots - 1)) {
        const int have = static_cast<volatile int*>(keys)[h];
        if (have == c) {
          slot = (int)h;
          break;
        }
        if (have == kEmpty) {
          const int prev = atomicCAS(keys + h, kEmpty, c);
          if (prev == kEmpty || prev == c) {
            slot = (int)h;
            break;
          }
        }
      }
      if (slot < 0) {
        add_global<KM>(gw_t, gv + t0, c, k, kt, vec, gx, cv);
        continue;
      }
      float* a = acc + slot * stride;
      if (t0 == 0) atomicAdd(a, gx);
#pragma unroll
      for (int f = 0; f < KM; ++f) {
        if (f < kt) atomicAdd(a + 1 + f, cv[f]);
      }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < slots; s += kBwdThreads) {
      const int c = keys[s];
      if (c == kEmpty) continue;
      const float* a = acc + s * stride;
#pragma unroll
      for (int f = 0; f < KM; ++f) cv[f] = f < kt ? a[1 + f] : 0.f;
      add_global<KM>(gw_t, gv + t0, c, k, kt, vec, a[0], cv);
    }
    __syncthreads();  // the table is the next tile's
  }
}

// the widest factor count the kernels hold in registers, for rank k
int rank_bucket(int k) {
  if (k <= 4) return 4;
  if (k <= 8) return 8;
  if (k <= 16) return 16;
  if (k <= 32) return 32;
  return kMaxRank;
}

// whether rows of `k` floats at `p` go four at a time: every tile is its
// register bucket's full width, and `p` is 16-byte aligned
bool vector_rows(const void* p, int k) {
  return k % rank_bucket(k) == 0 &&
         reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// margin[num_rows] and s1[num_rows, k] of one CSR shard of nnz entries
// (padding included), from b (one float), w [num_features] and
// v [num_features, k], on `stream`; *unsorted (one int) is set to whether
// the row plane was out of order, for the backward. Returns a CUDA error,
// or cudaErrorInvalidValue for k < 1.
extern "C" int dct_fm_csr_forward_f32(const void* row, const void* col,
                                      const void* val, long long nnz,
                                      int num_rows, int num_features, int k,
                                      const void* b, const void* w,
                                      const void* v, void* margin, void* s1,
                                      void* unsorted, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* bad = static_cast<int*>(unsorted);
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (err != cudaSuccess || num_rows <= 0) return (int)err;
  const int* r = static_cast<const int*>(row);
  const int* c = static_cast<const int*>(col);
  const float* x = static_cast<const float*>(val);
  const float* bp = static_cast<const float*>(b);
  const float* wp = static_cast<const float*>(w);
  const float* vp = static_cast<const float*>(v);
  float* m = static_cast<float*>(margin);
  float* s = static_cast<float*>(s1);
  const unsigned scan = (unsigned)std::min<long long>(
      kScanBlocks, std::max<long long>(1, (nnz + kScanThreads - 1) /
                                              kScanThreads));
  fm_csr_order_kernel<<<scan, kScanThreads, 0, st>>>(r, nnz, bad);
  const unsigned blocks = (unsigned)((num_rows + kFwdThreads - 1) /
                                     kFwdThreads);
  const bool vec = vector_rows(v, k);
  switch (rank_bucket(k)) {
    case 4:
      fm_csr_forward_kernel<4><<<blocks, kFwdThreads, 0, st>>>(
          r, c, x, nnz, num_rows, num_features, k, bp, wp, vp, vec, bad, m,
          s);
      break;
    case 8:
      fm_csr_forward_kernel<8><<<blocks, kFwdThreads, 0, st>>>(
          r, c, x, nnz, num_rows, num_features, k, bp, wp, vp, vec, bad, m,
          s);
      break;
    case 16:
      fm_csr_forward_kernel<16><<<blocks, kFwdThreads, 0, st>>>(
          r, c, x, nnz, num_rows, num_features, k, bp, wp, vp, vec, bad, m,
          s);
      break;
    case 32:
      fm_csr_forward_kernel<32><<<blocks, kFwdThreads, 0, st>>>(
          r, c, x, nnz, num_rows, num_features, k, bp, wp, vp, vec, bad, m,
          s);
      break;
    default:
      fm_csr_forward_kernel<kMaxRank><<<blocks, kFwdThreads, 0, st>>>(
          r, c, x, nnz, num_rows, num_features, k, bp, wp, vp, vec, bad, m,
          s);
      break;
  }
  fm_csr_scatter_kernel<<<scan, kScanThreads, 0, st>>>(
      r, c, x, nnz, num_rows, num_features, k, wp, vp, bad, m, s);
  fm_csr_finish_kernel<<<blocks, kFwdThreads, 0, st>>>(num_rows, k, bp, bad,
                                                       s, m);
  return (int)cudaGetLastError();
}

// Zeroes grad_b (one float), grad_w [num_features] and grad_v
// [num_features, k], then adds the gradient of sum_r g[r] * margin[r] into
// them, on `stream`; s1 and unsorted are the forward's. Returns a CUDA
// error, or cudaErrorInvalidValue for k < 1.
extern "C" int dct_fm_csr_backward_f32(const void* row, const void* col,
                                       const void* val, long long nnz,
                                       int num_rows, int num_features, int k,
                                       const void* v, const void* g,
                                       const void* s1, const void* unsorted,
                                       void* grad_b, void* grad_w,
                                       void* grad_v, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(grad_b, 0, sizeof(float), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(grad_w, 0, sizeof(float) * (size_t)num_features,
                          st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(grad_v, 0,
                          sizeof(float) * (size_t)num_features * (size_t)k,
                          st);
  if (err != cudaSuccess || num_rows <= 0) return (int)err;
  // the largest power-of-two table of (key, a tile's sums) within the budget
  const int tile = std::min(k, kMaxRank);
  int slots_log2 = 6;
  while ((size_t)(2 << slots_log2) * (size_t)(tile + 2) * sizeof(float) <=
         (size_t)kTableBytes)
    ++slots_log2;
  const size_t smem = (size_t)(1 << slots_log2) * (size_t)(tile + 2) *
                      sizeof(float);
  const long long chunks = nnz > 0 ? (nnz + kChunk - 1) / kChunk : 1;
  const unsigned blocks = (unsigned)chunks;
  const int* r = static_cast<const int*>(row);
  const int* c = static_cast<const int*>(col);
  const float* x = static_cast<const float*>(val);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  const float* sp = static_cast<const float*>(s1);
  const int* bad = static_cast<const int*>(unsorted);
  float* gbp = static_cast<float*>(grad_b);
  float* gwp = static_cast<float*>(grad_w);
  float* gvp = static_cast<float*>(grad_v);
  const bool vec = vector_rows(v, k) && vector_rows(grad_v, k);
  switch (rank_bucket(k)) {
    case 4:
      fm_csr_backward_kernel<4><<<blocks, kBwdThreads, smem, st>>>(
          r, c, x, nnz, num_rows, num_features, k, slots_log2, vec, vp, gp,
          sp, bad, gbp, gwp, gvp);
      break;
    case 8:
      fm_csr_backward_kernel<8><<<blocks, kBwdThreads, smem, st>>>(
          r, c, x, nnz, num_rows, num_features, k, slots_log2, vec, vp, gp,
          sp, bad, gbp, gwp, gvp);
      break;
    case 16:
      fm_csr_backward_kernel<16><<<blocks, kBwdThreads, smem, st>>>(
          r, c, x, nnz, num_rows, num_features, k, slots_log2, vec, vp, gp,
          sp, bad, gbp, gwp, gvp);
      break;
    case 32:
      fm_csr_backward_kernel<32><<<blocks, kBwdThreads, smem, st>>>(
          r, c, x, nnz, num_rows, num_features, k, slots_log2, vec, vp, gp,
          sp, bad, gbp, gwp, gvp);
      break;
    default:
      fm_csr_backward_kernel<kMaxRank><<<blocks, kBwdThreads, smem, st>>>(
          r, c, x, nnz, num_rows, num_features, k, slots_log2, vec, vp, gp,
          sp, bad, gbp, gwp, gvp);
      break;
  }
  return (int)cudaGetLastError();
}
