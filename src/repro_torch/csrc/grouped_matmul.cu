// Grouped float matrix product for Hopper (sm_90a) whose rows do not
// depend on how many rows there are.
//
//   y[g, r, :] = x[g, r, :] @ w[g]      x (G, R, K), w (G, K, N), y (G, R, N)
//
// Replaces no Pallas kernel. The reference computes these products in plain
// jnp and leaves them to XLA: the MoE router (src/repro/models/layers.py:352),
// the expert einsums (:390-398) and a float LM head (logits_out, :412). On
// the card the library product (cuBLAS, through torch.matmul or torch.bmm)
// picks its algorithm, and with it the order of each row's K sum, from the
// row count. A one-token decode step and a T-token speculative verify would
// then round the same row differently, and the verify's logits would not
// equal T one-token steps. Here each output element is one thread's chain
// of fused multiply-adds over k = 0, 1, ..., K-1 in that order, so a row's
// result depends only on its own x row, w[g] and K: not on R, the tile, the
// grid or the other rows.
//
// Types. x and w are f32 or bf16 and y has x's type: (f32, f32), (f32,
// bf16) and (bf16, bf16). A bf16 w under f32 x computes what x @ w.float()
// computes (bf16 -> f32 is exact) without a widened copy of the weights.
// Every product and sum is in f32; a bf16 y is the f32 sum rounded once to
// nearest even.
//
// Empty rows. counts, when given, holds each group's number of filled rows
// (the MoE capacity slots fill in order, so the rest are zero rows). Rows
// at or past counts[g] are written as zeros without being computed, and a
// row tile wholly past it reads nothing.
//
// What bounds it: at the serving paths' shapes, bytes. A decode step reads
// every expert's weights once for a few rows each (a few FMAs a weight
// element), far below the 295 operations a byte where the card turns
// compute-bound; the weights are read once a row tile, so at R <= kBR once.
//
// Design (a simple kernel, first right: no tensor cores, no TMA). A block
// owns a tile of kBR rows by kBN columns of one group and walks K in steps
// of kBK: it stages the x tile and the w tile in shared memory as f32, then
// each of its 256 threads updates kTR x kTN accumulators (rows tr + 8i,
// columns tc + 32j, so a warp reads 32 neighbouring floats of a w row and
// one broadcast x value) with one __fmaf_rn per k. The w tile is loaded in
// 16-byte vectors when N and the pointer allow it, else element by element.
// The grid is (column tiles, row tiles, groups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 16;   // rows a block
constexpr int kBN = 128;  // columns a block
constexpr int kBK = 32;   // K a stage
constexpr int kTR = kBR / (kThreads / 32);  // rows a thread: 2
constexpr int kTN = kBN / 32;               // columns a thread: 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the w tile's rows [0, kt) and columns [n0, n0 + kBN) into ws as f32
template <typename TW, bool kVec>
__device__ __forceinline__ void load_w(float (*ws)[kBN], const TW* wg,
                                       int k0, int kt, int n0, int N) {
  if constexpr (kVec) {
    constexpr int V = 16 / sizeof(TW);  // elements a 16-byte vector
    constexpr int kVecRow = kBN / V;
    for (int i = threadIdx.x; i < kBK * kVecRow; i += kThreads) {
      const int kk = i / kVecRow, c = (i % kVecRow) * V;
      float v[V];
      if (kk < kt && n0 + c < N) {  // N % V == 0: the vector is whole
        const uint4 raw = *reinterpret_cast<const uint4*>(
            wg + (int64_t)(k0 + kk) * N + n0 + c);
        const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) ws[kk][c + j] = v[j];
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      ws[kk][c] = (kk < kt && n0 + c < N)
                      ? to_f32(wg[(int64_t)(k0 + kk) * N + n0 + c])
                      : 0.f;
    }
  }
}

template <typename TX, typename TW, bool kVec>
__global__ void __launch_bounds__(kThreads)
    grouped_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                          TX* __restrict__ y, const int* __restrict__ counts,
                          int R, int K, int N, int64_t sxg, int64_t swg) {
  __shared__ float xs[kBR][kBK];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kBR;
  const int n0 = blockIdx.x * kBN;
  const int filled = counts ? min(R, max(counts[g], 0)) : R;
  const int tc = threadIdx.x % 32, tr = threadIdx.x / 32;
  const TX* xg = x + g * sxg;
  const TW* wg = w + g * swg;
  float acc[kTR][kTN];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (r0 < filled) {  // uniform across the block: the syncs below are safe
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const int kt = min(kBK, K - k0);
      for (int i = threadIdx.x; i < kBR * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;
        xs[r][kk] = (r0 + r < filled && kk < kt)
                        ? to_f32(xg[(int64_t)(r0 + r) * K + k0 + kk])
                        : 0.f;
      }
      load_w<TW, kVec>(ws, wg, k0, kt, n0, N);
      __syncthreads();
      // k ascending within the stage, stages in order: each accumulator is
      // one chain over k = 0 .. K-1 (kt, not kBK: no trailing zero terms)
      for (int kk = 0; kk < kt; ++kk) {
        float b[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tc + 32 * j];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float a = xs[tr + (kThreads / 32) * i][kk];
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(a, b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
  TX* yg = y + (int64_t)g * R * N;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + tr + (kThreads / 32) * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tc + 32 * j;
      if (c < N) store(&yg[(int64_t)r * N + c], r < filled ? acc[i][j] : 0.f);
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, const int* counts,
                   int G, int R, int K, int N, int64_t sxg, int64_t swg,
                   cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (R + kBR - 1) / kBR, G);
  constexpr int V = 16 / sizeof(TW);
  const bool vec = N % V == 0 && swg % V == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    grouped_matmul_kernel<TX, TW, true><<<grid, kThreads, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TX*>(y), counts, R, K, N, sxg, swg);
  else
    grouped_matmul_kernel<TX, TW, false><<<grid, kThreads, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TX*>(y), counts, R, K, N, sxg, swg);
  return cudaGetLastError();
}

}  // namespace

// x (G, R, K) rows contiguous, group stride sxg elements; w (G, K, N) rows
// contiguous, group stride swg elements; y (G, R, N) contiguous; counts
// (G,) int32 or null. x_bf16 / w_bf16 name the types: (0, 0), (0, 1) and
// (1, 1). Returns the launch's cudaError_t.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     const int* counts, int G, int R, int K,
                                     int N, int64_t sxg, int64_t swg,
                                     int x_bf16, int w_bf16, void* stream) {
  if (G <= 0 || R <= 0 || N <= 0 || G > 65535 || (R + kBR - 1) / kBR > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!x_bf16 && !w_bf16)
    err = launch<float, float>(x, w, y, counts, G, R, K, N, sxg, swg, st);
  else if (!x_bf16 && w_bf16)
    err = launch<float, __nv_bfloat16>(x, w, y, counts, G, R, K, N, sxg, swg,
                                       st);
  else if (x_bf16 && w_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, counts, G, R, K, N,
                                               sxg, swg, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* grouped_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
