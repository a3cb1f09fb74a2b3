// Dense int8-weight matmul with per-output-channel scales for Hopper
// (sm_90a): the non-sparse CIM macro, the paper's baseline.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quant_matmul.py
// (quant_matmul, pallas_call at :55, body _kernel :21). It computes
//   y[m, n] = (sum_k float(x[m, k]) * float(w[k, n])) * scale[n]
// with x (M, K) f32 or bf16 (row stride ldx >= K), w (K, N) int8 levels,
// scale (N,) f32 and y (M, N) f32. The scale multiplies once, after the
// whole K sum, as the TPU kernel's _finish does: MARS scales are per output
// group (eq. 8), so they factor out of the sum.
//
// What bounds it. A decode-sized M reads every weight byte once for a few
// FLOPs each: bytes (K*N int8 over 3.35 TB/s). At M in the hundreds the f32
// FFMA rate bounds it (2*M*K*N over 67 TFLOP/s), since this kernel uses no
// tensor cores. An int8 x int8 tensor-core product would not be exact here
// (x is not quantized by this function); bf16 wgmma over int8 -> bf16
// weights (exact for |w| <= 127) is the next design.
//
// Design (simple and right first). The TPU grid walks K sequentially and
// carries the sum in a VMEM scratch; here one block owns a 64x64 output
// tile and walks all of K itself, so nothing carries between blocks and
// every output sums in one order (k increasing) whatever the grid. 256
// threads, 4x4 outputs each (rows ty + 16i, columns tx + 16j, so shared-
// memory reads are broadcasts or distinct banks). K goes in chunks of 32:
// the x chunk is converted to f32 and stored transposed (row pitch 65 keeps
// the transposing stores free of bank conflicts), the w chunk is converted
// from int8 to f32, then 32 FFMA steps. Any M, N, K: every load past an
// edge is masked to 0 and never issued, every store past an edge skipped;
// nothing is padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ y,
                    int M, int N, int K, int64_t ldx) {
  __shared__ float xs[kBK][kBM + 1];  // x chunk, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];      // w chunk: ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x: 64 rows x 32 k, consecutive threads on consecutive k
#pragma unroll
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f32(x[(int64_t)gm * ldx + gk]) : 0.f;
    }
    // w: 32 k x 64 columns, consecutive threads on consecutive columns
#pragma unroll
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? (float)w[(int64_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm < M) y[(int64_t)gm * N + gn] = acc[i][j] * s;
    }
  }
}

}  // namespace

extern "C" {

// y = (x @ w) * scale. x has row stride ldx (elements); w, scale and y are
// contiguous. Launches on `stream` of device `device` and returns the
// cudaError_t of the launch (0 = ok).
int quant_matmul_launch(const void* x, int is_bf16, const void* w,
                        const void* scale, void* y, int M, int N, int K,
                        int64_t ldx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  if (is_bf16)
    quant_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wq, sc, out, M, N, K, ldx);
  else
    quant_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), wq, sc, out, M, N, K, ldx);
  return static_cast<int>(cudaGetLastError());
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
