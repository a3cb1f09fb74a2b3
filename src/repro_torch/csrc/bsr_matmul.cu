// Block-sparse int8 matmul for Hopper (sm_90a): y = x @ W[layer].
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cim_bsr_matmul.py:
// bsr_matmul (body _kernel, :64) and bsr_matmul_stacked (body
// _kernel_stacked, :115). One layer-indexed kernel serves both: the
// single-layer form is the L = 1 case with layer 0, so the loop and scan
// serving runtimes do the same arithmetic in the same order.
//
// W is a column-major ELL packing (core/mapping.pack_bsr, stacked by
// core/deploy.stack_deployed):
//   blocks  (L, go, nmax, bk, bn) int8     scales (L, go, nmax) f32
//   row_idx (L, go, nmax) int32            nnz    (L, go) int32
//   layer   (1,) int32, read on the device (no host sync per layer)
// For output block-column j:
//   y[:, j*bn:(j+1)*bn] = sum over s < min(nnz[l, j], nmax), ascending, of
//       x[:, row_idx[l, j, s]*bk : +bk] @ (float(blocks[l, j, s]) * scales[l, j, s])
// Slots past min(nnz, nmax) are never read (padding may hold anything).
// Accumulation and output are f32; x is f32 or bf16 (template on the type).
//
// Design. The TPU grid (M/bm, go, nnz_max) runs in order with the slot axis
// innermost; Hopper blocks run in parallel, so the slot axis becomes a loop
// inside the block. Grid = (ceil(M/BM), go, ceil(bn/64)); each 256-thread
// block owns a BM x 64 output tile in registers and walks its column's
// slots in k-chunks of 32 rows: the x slice and the dequantized int8 chunk
// are staged in shared memory, and the next chunk is fetched into
// registers while the current one is multiplied. The ragged row edge, the
// bk and bn edges (any tile _largest_divisor can give, bk != bn, non-powers
// of two) are masked in the kernel; there is no host-side padding.
//
// Bounds on this card. At decode (M = a few slots) the kernel must stream
// every surviving int8 block once: it is bound by bytes (blocks over
// 3.35 TB/s). At long prefill it is bound by operations: 2*M*nnz*bk*bn
// FLOPs on the f32 CUDA cores (67 TFLOP/s), far below the int8 or bf16
// tensor-core rates. This first version does nothing about either yet: no
// wgmma, no TMA, no int8 tensor cores, no split-K (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;            // threads across the output columns
constexpr int kTY = 16;            // threads across the output rows
constexpr int kTN = 4;             // output columns per thread
constexpr int kBN = kTX * kTN;     // output columns per block
constexpr int kKC = 32;            // k rows staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
bsr_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ blocks,
                  const float* __restrict__ scales,
                  const int* __restrict__ row_idx,
                  const int* __restrict__ nnz, const int* __restrict__ layer,
                  float* __restrict__ y, int M, int K, int L, int go,
                  int nmax, int bk, int bn) {
  constexpr int BM = kTY * TM;
  constexpr int XL = BM * kKC / kThreads;   // x values per thread per step
  constexpr int WL = kKC * kBN / kThreads;  // weight bytes per thread per step
  __shared__ float xs[kKC][BM + 1];         // +1: conflict-free transposed store
  __shared__ float ws[kKC][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int m0 = blockIdx.x * BM;
  const int j = blockIdx.y;
  const int n0 = blockIdx.z * kBN;
  const int gi = K / bk;

  const int l = *layer;
  const bool layer_ok = l >= 0 && l < L;
  size_t slot0 = 0;
  int cnt = 0;
  if (layer_ok) {
    slot0 = ((size_t)l * go + j) * nmax;
    cnt = min(max(nnz[(size_t)l * go + j], 0), nmax);
  }
  const int nchunk = (bk + kKC - 1) / kKC;
  const int steps = cnt * nchunk;
  const size_t block_elems = (size_t)bk * bn;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[i][c] = 0.f;

  // raw values of the next step, kept undecoded so the loads stay in flight
  T xr[XL];
  int8_t wr[WL];
  float sr = 0.f;

  auto load = [&](int t) {
    const int s = t / nchunk;
    const int kc = (t % nchunk) * kKC;
    const int r = row_idx[slot0 + s];
    const bool r_ok = r >= 0 && r < gi;
    sr = scales[slot0 + s];
    const T* xb = x + (size_t)r * bk;
    const int8_t* wb = blocks + (slot0 + s) * block_elems;
#pragma unroll
    for (int q = 0; q < XL; ++q) {
      const int e = tid + q * kThreads;
      const int row = m0 + e / kKC;
      const int k = kc + e % kKC;
      xr[q] = (r_ok && row < M && k < bk) ? xb[(size_t)row * K + k] : T();
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      const int e = tid + q * kThreads;
      const int k = kc + e / kBN;
      const int col = n0 + e % kBN;
      wr[q] = (k < bk && col < bn) ? wb[(size_t)k * bn + col] : int8_t(0);
    }
  };

  if (steps > 0) load(0);
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int q = 0; q < XL; ++q) {
      const int e = tid + q * kThreads;
      xs[e % kKC][e / kKC] = to_f32(xr[q]);
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      const int e = tid + q * kThreads;
      ws[e / kBN][e % kBN] = (float)wr[q] * sr;  // dequantize, then multiply
    }
    __syncthreads();
    if (t + 1 < steps) load(t + 1);
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float a[TM], b[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int c = 0; c < kTN; ++c) b[c] = ws[kk][tx + c * kTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }

  const size_t N = (size_t)go * bn;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int col = n0 + tx + c * kTX;
      // an out-of-range layer id reads nothing and poisons its output
      if (col < bn) y[(size_t)row * N + (size_t)j * bn + col] =
          layer_ok ? acc[i][c] : nan;
    }
  }
}

template <typename T, int TM>
void launch(const void* x, const void* blocks, const void* scales,
            const void* row_idx, const void* nnz, const void* layer, void* y,
            int M, int K, int L, int go, int nmax, int bk, int bn,
            cudaStream_t stream) {
  constexpr int BM = kTY * TM;
  dim3 grid((M + BM - 1) / BM, go, (bn + kBN - 1) / kBN);
  bsr_matmul_kernel<T, TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(blocks),
      static_cast<const float*>(scales), static_cast<const int*>(row_idx),
      static_cast<const int*>(nnz), static_cast<const int*>(layer),
      static_cast<float*>(y), M, K, L, go, nmax, bk, bn);
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns the cudaError_t of
// the launch (0 = ok).
int bsr_matmul_launch(const void* x, int x_is_bf16, const void* blocks,
                      const void* scales, const void* row_idx,
                      const void* nnz, const void* layer, void* y, int M,
                      int K, int L, int go, int nmax, int bk, int bn,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = M <= kTY;  // decode: one row per thread row
  if (x_is_bf16) {
    if (small)
      launch<__nv_bfloat16, 1>(x, blocks, scales, row_idx, nnz, layer, y, M,
                               K, L, go, nmax, bk, bn, st);
    else
      launch<__nv_bfloat16, 4>(x, blocks, scales, row_idx, nnz, layer, y, M,
                               K, L, go, nmax, bk, bn, st);
  } else {
    if (small)
      launch<float, 1>(x, blocks, scales, row_idx, nnz, layer, y, M, K, L,
                       go, nmax, bk, bn, st);
    else
      launch<float, 4>(x, blocks, scales, row_idx, nnz, layer, y, M, K, L,
                       go, nmax, bk, bn, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bsr_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
