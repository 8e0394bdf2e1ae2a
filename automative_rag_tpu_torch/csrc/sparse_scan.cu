// K3/K3b — sparse (lexical) term-match scan over the term-major slab.
//
// Replaces the TPU kernels automative_rag_tpu/ops/sparse_scan.py:_scan_kernel
// (wrapper sparse_scores_tm) and _scan_kernel_batch (sparse_scores_tm_batch):
// one kernel with a batch dimension serves both.
//
//   score[b, n] = sum_t w[t, n] * ( sum_q [ids[t, n] == q_ids[b, q]] * q_w[b, q] )
//
// with the inner sum over query terms first, in query order, as the TPU
// kernel does; the f32 products with the doc weight are summed over terms
// in four strided partial sums.
//
// What bounds it on an H100: at Q <= 32 query terms it does ~2 Q compare and
// select-add operations per slab element against 6 bytes read (int32 id +
// bf16 weight), so a batch of one is bound by the bytes and larger query
// batches by the CUDA-core operations. At the main path's size (one
// 8192-column block) neither bound is near: the time goes to dependent
// chains (load, then Q compares per term). The design:
// - four threads share a corpus column, each taking every fourth term, so
//   the chain per thread is a quarter as long and eight warps per block
//   hide each other's latency; their four partial sums are added in a
//   fixed order through shared memory;
// - a warp reads 32 neighbouring columns of one term row (coalesced), and
//   each id and weight is read from device memory once for up to 8
//   queries held in registers;
// - the query terms sit in shared memory where every thread of a warp
//   reads the same word (a broadcast, no bank conflicts).
// Masking to the live row count and the top-k stay in PyTorch.
//
// Layout: ids [T, cap] int32 (pad -1), w [T, cap] bf16 (pad 0),
// q_ids [B, Q] int32 (pad -1), q_w [B, Q] f32 (pad 0), out [B, cap] f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;                 // corpus columns per block
constexpr int kTermGroups = 4;            // threads per column
constexpr int kThreads = kCols * kTermGroups;
constexpr int kQueriesPerBlock = 8;
constexpr int kTermUnroll = 4;            // term loads issued before the compares

// grid: x = ceil(cap / 64) column blocks, y = ceil(B / 8) query groups
__global__ void __launch_bounds__(kThreads)
sparse_scan_kernel(const int32_t* __restrict__ ids,
                   const __nv_bfloat16* __restrict__ w,
                   const int32_t* __restrict__ q_ids,
                   const float* __restrict__ q_w,
                   float* __restrict__ out,
                   int n_terms, int cap, int batch, int n_q) {
  extern __shared__ unsigned char smem[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);              // [8, Q]
  float* s_w = reinterpret_cast<float*>(s_ids + kQueriesPerBlock * n_q);
  __shared__ float part[kTermGroups][kQueriesPerBlock][kCols];

  const int b0 = blockIdx.y * kQueriesPerBlock;
  const int nb = min(kQueriesPerBlock, batch - b0);
  for (int i = threadIdx.x; i < nb * n_q; i += blockDim.x) {
    s_ids[i] = q_ids[(size_t)b0 * n_q + i];
    s_w[i] = q_w[(size_t)b0 * n_q + i];
  }
  __syncthreads();

  const int col = threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;    // warp-uniform: kCols is a multiple of 32
  const int n = blockIdx.x * kCols + col;
  const bool live = n < cap;

  float acc[kQueriesPerBlock];
#pragma unroll
  for (int j = 0; j < kQueriesPerBlock; ++j) acc[j] = 0.f;

  // this thread's terms: grp, grp + 4, grp + 8, ...
  for (int t0 = grp; t0 < n_terms; t0 += kTermGroups * kTermUnroll) {
    int32_t id[kTermUnroll];
    float wt[kTermUnroll];
#pragma unroll
    for (int u = 0; u < kTermUnroll; ++u) {
      const int t = t0 + u * kTermGroups;
      const bool ok = live && t < n_terms;
      id[u] = ok ? ids[(size_t)t * cap + n] : -1;
      wt[u] = ok ? __bfloat162float(w[(size_t)t * cap + n]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kQueriesPerBlock; ++j) {
      if (j < nb) {
        const int32_t* qi = s_ids + j * n_q;
        const float* qw = s_w + j * n_q;
        float hit[kTermUnroll];
#pragma unroll
        for (int u = 0; u < kTermUnroll; ++u) hit[u] = 0.f;
        for (int i = 0; i < n_q; ++i) {
          const int32_t qid = qi[i];
          const float qwv = qw[i];
#pragma unroll
          for (int u = 0; u < kTermUnroll; ++u) hit[u] += (id[u] == qid) ? qwv : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kTermUnroll; ++u) acc[j] += hit[u] * wt[u];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQueriesPerBlock; ++j) part[grp][j][col] = acc[j];
  __syncthreads();
  if (grp == 0 && live) {
#pragma unroll
    for (int j = 0; j < kQueriesPerBlock; ++j) {
      if (j < nb) {
        float total = part[0][j][col];
#pragma unroll
        for (int g = 1; g < kTermGroups; ++g) total += part[g][j][col];
        out[(size_t)(b0 + j) * cap + n] = total;
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch.
int sparse_scan_launch(const void* ids, const void* w, const void* q_ids,
                       const void* q_w, void* out, int n_terms, int cap,
                       int batch, int n_q, void* stream) {
  if (n_terms <= 0 || cap <= 0 || batch <= 0 || n_q <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kQueriesPerBlock * n_q * (sizeof(int32_t) + sizeof(float));
  if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;  // + 8 KB static
  dim3 grid((unsigned)((cap + kCols - 1) / kCols),
            (unsigned)((batch + kQueriesPerBlock - 1) / kQueriesPerBlock));
  sparse_scan_kernel<<<grid, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(q_ids), static_cast<const float*>(q_w),
      static_cast<float*>(out), n_terms, cap, batch, n_q);
  return (int)cudaGetLastError();
}

const char* sparse_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
