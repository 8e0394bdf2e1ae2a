// K1 — late-interaction MaxSim over candidate rows of the token store.
//
// Replaces the TPU kernel automative_rag_tpu/ops/maxsim.py:_maxsim_kernel
// (wrapper maxsim_scores_pallas) and the gather in front of it
// (rerank/token_store.py:maxsim_fused): one launch reads each candidate's
// token slab straight out of the store by row id.
//
//   score[b, n] = sum_i w[b, i] * max_t ( q[b, i, :] . doc[rows[n], t, :] + bias[n, t] )
//   bias[n, t]  = 0 for a real doc token, -1e30 for padding or row -1,
//   w[b, i]     = 1 for a scoring query token, 0 otherwise.
//
// What bounds it on an H100: bytes. Every candidate streams Ld x D bf16
// (512 KB at Ld=256, D=1024) once, against 64 flops per byte for a tile of
// 32 query tokens — below the ~295 flop/byte ridge, so the card's memory
// rate is the roofline. The design:
// - the 32 query tokens of a tile sit in shared memory (row pitch padded by
//   64 bytes so the 16-byte fragment loads are free of bank conflicts);
// - each warp owns 8 doc tokens and computes their 32 x 8 similarities
//   with bf16 tensor-core MMAs (mma.sync m16n8k16, f32 accumulation), so
//   the doc tokens are read from device memory exactly once, 16 coalesced
//   bytes per lane, eight loads in flight before any MMA waits on them;
// - the dot product is summed in a fixed permutation of the D axis: each
//   lane feeds the MMA the 8 consecutive elements it loaded for both
//   operands, which is the same sum in another order;
// - the doc tokens of one candidate are split over several blocks so a
//   handful of candidates still fills the card; a second small kernel
//   takes the max over the splits and the masked sum over query tokens.
//
// Layout: q [B, Lq, D] bf16 and q_mask [B, Lq] bool with Lq a multiple of
// 32 (the wrapper pads other widths with masked zero tokens) and D a
// multiple of 32; tokens [cap, Ld, D] bf16 doc-major; masks [cap, Ld] bool;
// rows [N] int64; a row outside [0, cap) (row -1 by convention) is scored
// as all padding, so an id never reads past the slab.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;                 // 128 threads per block
constexpr int kTokPerWarp = 8;            // one MMA n-tile of doc tokens
constexpr int kTokPerBlock = kWarps * kTokPerWarp;
constexpr int kQTile = 32;                // query tokens per block (two m-tiles)
constexpr int kKChunk = 32;               // D elements per lane load round (2 MMA k-steps)
constexpr int kBatch = 8;                 // chunks loaded before the MMAs consume them
constexpr int kPitchPad = 64;             // bytes added to each query row in shared memory
constexpr float kNegBias = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid: x = N * S (candidate, doc-token split), y = B * (Lq / 32)
// out: partial[b, n, s, i] = max over the split's tokens of (dot + bias)
__global__ void __launch_bounds__(kWarps * kWarp)
maxsim_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ tokens,
                      const uint8_t* __restrict__ masks,
                      const int64_t* __restrict__ rows,
                      float* __restrict__ partial,
                      int n_cand, int splits, int lq, int dim, int ld, int cap) {
  extern __shared__ __align__(16) unsigned char q_tile[];  // [32, pitch] bytes
  __shared__ float warp_best[kWarps][kQTile];

  const int n = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int q_chunks = lq / kQTile;
  const int b = blockIdx.y / q_chunks;
  const int qc = blockIdx.y % q_chunks;
  const int d8 = dim / 8;                 // 16-byte chunks per row
  const int pitch = dim * 2 + kPitchPad;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int g = lane >> 2;                // MMA row group / doc token of this lane
  const int c = lane & 3;                 // MMA column pair

  const uint4* q_src = reinterpret_cast<const uint4*>(
      q + ((size_t)b * lq + (size_t)qc * kQTile) * dim);
  for (int i = threadIdx.x; i < kQTile * d8; i += blockDim.x)
    *reinterpret_cast<uint4*>(q_tile + (i / d8) * pitch + 16 * (i % d8)) = q_src[i];
  __syncthreads();

  const int64_t row = rows[n];
  const bool valid_row = row >= 0 && row < cap;
  const size_t r = valid_row ? (size_t)row : 0;
  const uint8_t* mrow = masks + r * (size_t)ld;
  const int t_first = s * kTokPerBlock + warp * kTokPerWarp;  // this warp's tokens
  const int t_end = min(ld, (s + 1) * kTokPerBlock);
  const int t_mine = t_first + g;                              // this lane's B token
  const bool t_ok = t_mine < t_end;
  const uint4* drow = reinterpret_cast<const uint4*>(
      tokens + (r * (size_t)ld + (t_ok ? t_mine : 0)) * dim);

  float acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const int n_chunks = dim / kKChunk;
  for (int k0 = 0; k0 < n_chunks; k0 += kBatch) {
    uint4 bv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      bv[u] = (t_ok && k0 + u < n_chunks) ? drow[(k0 + u) * 4 + c] : zero4;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < n_chunks) {
        const int col = (k0 + u) * (kKChunk * 2) + 16 * c;  // byte offset in the row
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint4 qa = *reinterpret_cast<const uint4*>(q_tile + (m * 16 + g) * pitch + col);
          const uint4 qb = *reinterpret_cast<const uint4*>(q_tile + (m * 16 + g + 8) * pitch + col);
          // the lane's 8 consecutive elements serve as its k-slots of two
          // k-steps, identically for the query rows and its doc token
          mma_bf16(acc[m], qa.x, qb.x, qa.y, qb.y, bv[u].x, bv[u].y);
          mma_bf16(acc[m], qa.z, qb.z, qa.w, qb.w, bv[u].z, bv[u].w);
        }
      }
    }
  }

  // accumulator (m, j): query row m*16 + g (+8 for j >= 2), doc token
  // t_first + 2c + (j & 1); out-of-range tokens drop out of the max
  float bias[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = t_first + 2 * c + j;
    bias[j] = t >= t_end ? -INFINITY : ((valid_row && mrow[t]) ? 0.f : kNegBias);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = fmaxf(acc[m][2 * h] + bias[0], acc[m][2 * h + 1] + bias[1]);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (c == 0) warp_best[warp][m * 16 + g + 8 * h] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float best = warp_best[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) best = fmaxf(best, warp_best[w][lane]);
    partial[(((size_t)b * n_cand + n) * splits + s) * lq + (size_t)qc * kQTile + lane] = best;
  }
}

// one warp per (b, n): max over splits, masked sum over query tokens (the
// reference multiplies by the 0/1 query weight; so does this)
__global__ void maxsim_reduce_kernel(const float* __restrict__ partial,
                                     const uint8_t* __restrict__ q_mask,
                                     float* __restrict__ out,
                                     int batch, int n_cand, int splits, int lq) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int pair = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (pair >= batch * n_cand) return;
  const int b = pair / n_cand;
  const float* p = partial + (size_t)pair * splits * lq;
  float acc = 0.f;
  for (int i = lane; i < lq; i += kWarp) {
    float m = -INFINITY;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, p[(size_t)s * lq + i]);
    acc += m * (q_mask[(size_t)b * lq + i] ? 1.f : 0.f);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[pair] = acc;
}

}  // namespace

extern "C" {

int maxsim_num_splits(int ld) { return (ld + kTokPerBlock - 1) / kTokPerBlock; }

int maxsim_smem_bytes(int dim) { return kQTile * (dim * 2 + kPitchPad); }

// q [B, Lq, D] bf16, q_mask [B, Lq] bool, tokens [cap, Ld, D] bf16,
// masks [cap, Ld] bool, rows [N] int64, partial [B, N, S, Lq] f32 scratch,
// out [B, N] f32. Returns cudaGetLastError() after the launches.
int maxsim_launch(const void* q, const void* q_mask, const void* tokens,
                  const void* masks, const void* rows, void* partial, void* out,
                  int batch, int lq, int dim, int ld, int n_cand, int cap,
                  void* stream) {
  if (lq % kQTile != 0 || dim % kKChunk != 0 || batch <= 0 || n_cand <= 0 || ld <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = maxsim_num_splits(ld);
  const int smem = maxsim_smem_bytes(dim);
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        maxsim_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid1((unsigned)(n_cand * splits), (unsigned)(batch * (lq / kQTile)));
  maxsim_partial_kernel<<<grid1, kWarps * kWarp, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(tokens),
      static_cast<const uint8_t*>(masks), static_cast<const int64_t*>(rows),
      static_cast<float*>(partial), n_cand, splits, lq, dim, ld, cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int pairs = batch * n_cand;
  constexpr int kReduceWarps = 8;
  maxsim_reduce_kernel<<<(pairs + kReduceWarps - 1) / kReduceWarps, kReduceWarps * kWarp, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const uint8_t*>(q_mask),
      static_cast<float*>(out), batch, n_cand, splits, lq);
  return (int)cudaGetLastError();
}

const char* maxsim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
