// Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_intra.py
// (ssd_intra_chunk, body _kernel :30). For one chunk c and head h:
//   cum    = cumsum(a[c, h, :])                                 (l,)
//   L[i,j] = exp(cum_i - cum_j) for i >= j, else 0              (l, l)
//   y[c, :, h, :] = ((C_c B_c^T) o L) @ x[c, :, h, :]           (l, P)
// with a (C, H, l) f32; b, c (C, l, N) and x (C, l, H, P) in f32 or bf16
// (one type); y (C, l, H, P) in f32. All arithmetic is f32 FFMA.
// No l x l intermediate reaches device memory.
//
// Design. The TPU kernel holds a whole chunk (l x l scores, l x N operands)
// in VMEM; a Hopper block has at most 227 KB of shared memory, and at
// l = 256, N = 128, P = 64 the f32 operands alone are 320 KB. So the block
// (one per chunk and head, 256 threads) tiles everything: for each 64-row
// output tile i and each 64-column key tile j <= i (tiles above the
// diagonal are skipped: they are all zero), it forms the score tile
// C_i B_j^T in 16-wide slices of N staged in shared memory, multiplies by
// the decay (exp is taken only where i >= j: the non-causal difference is
// positive and can overflow), stores the tile in shared memory, and adds
// its product with the staged x_j tile to a 64 x 64 register accumulator.
// P is tiled by 64 the same way. Shared memory is 45 KB whatever l, N and
// P are, apart from the l floats of cum (l <= 1024).
//
// Bounds on this card. Per chunk the least work covers the causal pairs
// i >= j only: l (l + 1) N FLOPs for C B^T plus l (l + 1) P FLOPs per head
// for the product with x, against l (N + N + H P) elements read: at the
// serving shape it is bound by operations (f32 CUDA cores; no tensor cores here). This first version
// recomputes C B^T for every head, as the TPU kernel does, skips the upper
// triangle, and uses neither tensor cores nor asynchronous copies (later
// work: one block per chunk sharing C B^T across heads, wgmma in tf32/bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;      // rows i, columns j and columns p per tile
constexpr int kNK = 16;     // slice of N staged per step
constexpr int kMaxL = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ c, const T* __restrict__ x,
                 float* __restrict__ y, int H, int l, int N, int P) {
  __shared__ float cum[kMaxL];
  __shared__ float cs[kT][kNK + 1];  // +1: conflict-free column reads
  __shared__ float bs[kT][kNK + 1];
  __shared__ float ss[kT][kT + 1];   // decayed score tile (i, j)
  __shared__ float xs[kT][kT];       // x tile (j, p)

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // micro-tile columns tx + 16 * q
  const int ty = tid / 16;  // micro-tile rows ty + 16 * r
  const int h = blockIdx.x;
  const size_t ci = blockIdx.y;

  // cum = cumsum(a[ci, h, :]) by warp 0: each lane sums a segment, a shuffle
  // scan gives the segment offsets, each lane then writes its running sums
  if (tid < 32) {
    const float* ap = a + (ci * H + h) * (size_t)l;
    const int seg = (l + 31) / 32;
    const int k0 = tid * seg;
    const int k1 = min(l, k0 + seg);
    float part = 0.f;
    for (int k = k0; k < k1; ++k) part += ap[k];
    float incl = part;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    float run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) run = 0.f;
    for (int k = k0; k < k1; ++k) {
      run += ap[k];
      cum[k] = run;
    }
  }
  __syncthreads();

  const T* cb = c + ci * (size_t)l * N;
  const T* bb = b + ci * (size_t)l * N;
  for (int p0 = 0; p0 < P; p0 += kT) {
    for (int i0 = 0; i0 < l; i0 += kT) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kT) {  // causal tiles only
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[r][q] = 0.f;

        for (int n0 = 0; n0 < N; n0 += kNK) {
#pragma unroll
          for (int u = 0; u < kT * kNK / kThreads; ++u) {
            const int e = tid + u * kThreads;
            const int row = e / kNK;
            const int n = n0 + e % kNK;
            const bool n_ok = n < N;
            cs[row][e % kNK] = (n_ok && i0 + row < l)
                ? to_f32(cb[(size_t)(i0 + row) * N + n]) : 0.f;
            bs[row][e % kNK] = (n_ok && j0 + row < l)
                ? to_f32(bb[(size_t)(j0 + row) * N + n]) : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < kNK; ++k) {
            float ar[4], br[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) ar[r] = cs[ty + 16 * r][k];
#pragma unroll
            for (int q = 0; q < 4; ++q) br[q] = bs[tx + 16 * q][k];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) s[r][q] = fmaf(ar[r], br[q], s[r][q]);
          }
          __syncthreads();
        }

        // decay: exp only on the causal side, where the difference is <= 0
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gi = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gj = j0 + tx + 16 * q;
            float v = 0.f;
            if (gi < l && gj <= gi) v = s[r][q] * expf(cum[gi] - cum[gj]);
            ss[ty + 16 * r][tx + 16 * q] = v;
          }
        }
#pragma unroll 4
        for (int u = 0; u < kT * kT / kThreads; ++u) {
          const int e = tid + u * kThreads;
          const int j = e / kT;
          const int p = p0 + e % kT;
          xs[j][e % kT] = (j0 + j < l && p < P)
              ? to_f32(x[((ci * l + j0 + j) * H + h) * (size_t)P + p]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kT; ++j) {
          float sr[4], xr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sr[r] = ss[ty + 16 * r][j];
#pragma unroll
          for (int q = 0; q < 4; ++q) xr[q] = xs[j][tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(sr[r], xr[q], acc[r][q]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gi = i0 + ty + 16 * r;
        if (gi >= l) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gp = p0 + tx + 16 * q;
          if (gp < P) y[((ci * l + gi) * H + h) * (size_t)P + gp] = acc[r][q];
        }
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, const void* c, const void* x,
            float* y, int C, int H, int l, int N, int P, cudaStream_t st) {
  ssd_intra_kernel<T><<<dim3(H, C), kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(x), y, H, l, N, P);
}

}  // namespace

extern "C" {

// y = ssd_intra_chunk(a, b, c, x) in f32. in_bf16: b, c and x are bf16
// (else f32). Launches on `stream` of device `device` and returns the
// cudaError_t of the launch (0 = ok).
int ssd_intra_launch(const void* a, const void* b, const void* c,
                     const void* x, float* y, int C, int H, int l, int N,
                     int P, int in_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l > kMaxL || C > 65535) return cudaErrorInvalidValue;
  if (C <= 0 || H <= 0 || l <= 0 || P <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    launch<__nv_bfloat16>(a, b, c, x, y, C, H, l, N, P, st);
  else
    launch<float>(a, b, c, x, y, C, H, l, N, P, st);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
