// Backward of the Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains through its plain jnp
// SSD (src/repro/models/ssm.py:29, ssd_chunked's intra-chunk einsum), whose
// gradient JAX's autodiff makes. The forward is csrc/ssd_intra.cu. Per chunk
// c and head h, with cum = cumsum(a[c, h]), L[i, j] = exp(cum_i - cum_j) for
// i >= j (0 above the diagonal), S = C B^T (shared by the heads), M = S * L
// and y = M x, the backward of dy (f32) is, in f32:
//   dx     = M^T dy
//   dM     = dy x^T                         (lower triangle)
//   dS     = sum_h dM * L                   dC = dS B,  dB = dS^T C
//   G      = dM * M
//   dcum_i = sum_j G[i, j] - sum_k G[k, i]  da_t = sum_{i >= t} dcum_i
// x, b and c are f32 or bf16 (widened exactly); every result is f32.
//
// Deterministic: no atomics, and every sum runs in a fixed order. The head
// sum of dS, which the reference leaves to XLA, is a per-head partial buffer
// (dsh) and a second pass over the heads in order.
//
// Four launches on one stream:
//   1. ssd_bwd_scores_kernel: S = C B^T per chunk over the causal 32 x 32
//      tiles;
//   2. ssd_bwd_head_kernel: one block per (head, chunk) walks the causal
//      tiles, column tile outer and row tile inner, so dx's column tile sums in
//      shared memory over the row tiles and is written once; each tile
//      writes dM * L to dsh and adds G's row and column sums to per-block
//      arrays; the block ends with da's reverse prefix sum;
//   3. ssd_bwd_sum_heads_kernel: dS = sum_h dsh, the heads in order;
//   4. ssd_bwd_bc_kernel: dC (row tiles of dS B) and dB (row tiles of
//      dS^T C).
//
// What bounds it: at the mamba2-780m shapes (l = 256, N = 128, P = 64) the
// f32 work, about 2 l^2 P a head and 3 l^2 N a chunk multiply-adds, over
// the bytes of dy, x, b, c, a and the outputs, with dsh (H l^2 f32 a chunk)
// through L2. Tensor cores are not used: this is the simple, right kernel;
// a faster one would share dM's tiles across a head group as the forward
// shares C B^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // rows and columns of an l x l tile
constexpr int kNCols = 64;  // columns of N per block of ssd_bwd_bc_kernel
constexpr int kMaxLen = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// S[c, i, j] = sum_n C[c, i, n] B[c, j, n] over the tiles with jt <= it;
// blockIdx.x enumerates them row by row. Thread t owns row t / 8 and
// columns t % 8 + 8 u of its tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores_kernel(const T* __restrict__ b, const T* __restrict__ cm,
                      float* __restrict__ s, int l, int n) {
  int idx = blockIdx.x, it = 0;
  while (idx > it) idx -= ++it;
  const int jt = idx;
  const int c = blockIdx.y;
  __shared__ float cs[kTile][kTile + 1], bs[kTile][kTile + 1];
  const int t = threadIdx.x, r = t >> 3, q = t & 7;
  const int i0 = it * kTile, j0 = jt * kTile;
  const T* cb = cm + (int64_t)c * l * n;
  const T* bb = b + (int64_t)c * l * n;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int e = t; e < kTile * kTile; e += kThreads) {
      const int rr = e / kTile, col = n0 + e % kTile;
      cs[rr][e % kTile] =
          (i0 + rr < l && col < n) ? ld(cb + (int64_t)(i0 + rr) * n + col)
                                   : 0.f;
      bs[rr][e % kTile] =
          (j0 + rr < l && col < n) ? ld(bb + (int64_t)(j0 + rr) * n + col)
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float cv = cs[r][kk];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(cv, bs[q + 8 * u][kk], acc[u]);
    }
    __syncthreads();
  }
  float* sb = s + (int64_t)c * l * l;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + r, j = j0 + q + 8 * u;
    if (i < l && j < l) sb[(int64_t)i * l + j] = acc[u];
  }
}

// Shared memory of ssd_bwd_head_kernel, in floats: cum, G's row and column
// sums (l padded to kTile each), the x and dy tiles (kTile x (p + 1)), dx's
// column tile (kTile x p), M's and G's tiles (kTile x (kTile + 1)).
__host__ __device__ inline int ssd_bwd_head_smem_floats(int l, int p) {
  const int lp = (l + kTile - 1) / kTile * kTile;
  return 3 * lp + 2 * kTile * (p + 1) + kTile * p + 2 * kTile * (kTile + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_kernel(const float* __restrict__ a, const T* __restrict__ x,
                    const float* __restrict__ dy, const float* __restrict__ s,
                    float* __restrict__ dsh, float* __restrict__ da,
                    float* __restrict__ dx, int n_h, int l, int p) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, c = blockIdx.y;
  const int lp = (l + kTile - 1) / kTile * kTile, pp = p + 1;
  constexpr int kT1 = kTile + 1;
  float* cum = sm;
  float* rowg = cum + lp;
  float* colg = rowg + lp;
  float* xs = colg + lp;
  float* dys = xs + kTile * pp;
  float* acc = dys + kTile * pp;
  float* mt = acc + kTile * p;
  float* gt = mt + kTile * kT1;
  const int t = threadIdx.x, lane = t & 31;

  // cum: warp 0 scans 32 elements at a time, carrying the running sum
  const float* ab = a + ((int64_t)c * n_h + h) * l;
  if (t < 32) {
    float carry = 0.f;
    for (int base = 0; base < lp; base += 32) {
      float v = base + lane < l ? ab[base + lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float w = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += w;
      }
      cum[base + lane] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  for (int i = t; i < lp; i += kThreads) rowg[i] = colg[i] = 0.f;
  __syncthreads();

  const int64_t row = (int64_t)n_h * p;  // stride of a position in x, dy, dx
  const int64_t off = (int64_t)c * l * row + (int64_t)h * p;
  const T* xb = x + off;
  const float* dyb = dy + off;
  float* dxb = dx + off;
  const float* sb = s + (int64_t)c * l * l;
  float* dshb = dsh + ((int64_t)c * n_h + h) * l * l;
  const int nt = lp / kTile, r = t >> 3, q = t & 7;

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kTile;
    for (int e = t; e < kTile * p; e += kThreads) {
      const int rr = e / p, pc = e % p;
      xs[rr * pp + pc] = j0 + rr < l ? ld(xb + (j0 + rr) * row + pc) : 0.f;
      acc[e] = 0.f;
    }
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * kTile;
      for (int e = t; e < kTile * p; e += kThreads) {
        const int rr = e / p, pc = e % p;
        dys[rr * pp + pc] = i0 + rr < l ? dyb[(i0 + rr) * row + pc] : 0.f;
      }
      __syncthreads();
      // dM over the tile: thread t owns row r, columns q + 8 u
      float dm[4] = {0.f, 0.f, 0.f, 0.f};
      for (int pc = 0; pc < p; ++pc) {
        const float dv = dys[r * pp + pc];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dm[u] = fmaf(dv, xs[(q + 8 * u) * pp + pc], dm[u]);
      }
      const int i = i0 + r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = q + 8 * u, j = j0 + jj;
        float m = 0.f, g = 0.f;
        if (i < l && j <= i) {
          const float dec = expf(cum[i] - cum[j]);
          m = sb[(int64_t)i * l + j] * dec;
          dshb[(int64_t)i * l + j] = dm[u] * dec;
          g = dm[u] * m;
        }
        mt[r * kT1 + jj] = m;
        gt[r * kT1 + jj] = g;
      }
      __syncthreads();
      // dx[j0 + jj, pc] += sum_ii M[i0 + ii, j0 + jj] dy[i0 + ii, pc]
      for (int e = t; e < kTile * p; e += kThreads) {
        const int jj = e / p, pc = e % p;
        float v = acc[e];
#pragma unroll 8
        for (int ii = 0; ii < kTile; ++ii)
          v = fmaf(mt[ii * kT1 + jj], dys[ii * pp + pc], v);
        acc[e] = v;
      }
      if (t < kTile) {
        float v = 0.f;
        for (int jj = 0; jj < kTile; ++jj) v += gt[t * kT1 + jj];
        rowg[i0 + t] += v;
      } else if (t < 2 * kTile) {
        const int jj = t - kTile;
        float v = 0.f;
        for (int ii = 0; ii < kTile; ++ii) v += gt[ii * kT1 + jj];
        colg[j0 + jj] += v;
      }
      __syncthreads();
    }
    for (int e = t; e < kTile * p; e += kThreads) {
      const int rr = e / p, pc = e % p;
      if (j0 + rr < l) dxb[(j0 + rr) * row + pc] = acc[e];
    }
  }
  __syncthreads();
  if (t == 0) {
    float run = 0.f;
    float* dab = da + ((int64_t)c * n_h + h) * l;
    for (int i = l - 1; i >= 0; --i) {
      run += rowg[i] - colg[i];
      dab[i] = run;
    }
  }
}

// dS[c, i, j] = sum_h dsh[c, h, i, j], the heads in order; 0 above the
// diagonal (dsh is written only on and below it)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_heads_kernel(const float* __restrict__ dsh,
                         float* __restrict__ ds, int n_h, int l,
                         int64_t total) {
  const int64_t ll = (int64_t)l * l;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t c = e / ll, ij = e % ll;
    float v = 0.f;
    if (ij % l <= ij / l) {
      const float* src = dsh + c * n_h * ll + ij;
      for (int h = 0; h < n_h; ++h) v += src[h * ll];
    }
    ds[e] = v;
  }
}

// blockIdx.z 0: dC[i, n] = sum_{j <= i} dS[i, j] B[j, n];
//            1: dB[j, n] = sum_{i >= j} dS[i, j] C[i, n].
// A block makes kTile output rows by kNCols columns of N; thread t owns row
// t / 8 and columns t % 8 + 8 u.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(const float* __restrict__ ds, const T* __restrict__ b,
                  const T* __restrict__ cm, float* __restrict__ db,
                  float* __restrict__ dc, int l, int n) {
  const int nt = (l + kTile - 1) / kTile;
  const int ncol = (n + kNCols - 1) / kNCols;
  const int tile = blockIdx.x / ncol, n0 = blockIdx.x % ncol * kNCols;
  const int c = blockIdx.y, role = blockIdx.z;
  __shared__ float dst[kTile][kTile + 1];
  __shared__ float op[kTile][kNCols + 1];
  const T* src = (role == 0 ? b : cm) + (int64_t)c * l * n;
  const float* dsb = ds + (int64_t)c * l * l;
  const int o0 = tile * kTile;
  const int t = threadIdx.x, r = t >> 3, q = t & 7;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int k_lo = role == 0 ? 0 : tile, k_hi = role == 0 ? tile : nt - 1;
  for (int kt = k_lo; kt <= k_hi; ++kt) {
    const int k0 = kt * kTile;
    for (int e = t; e < kTile * kTile; e += kThreads) {
      // neighbouring threads read neighbouring addresses of dS
      const int inner = e % kTile, outer = e / kTile;
      const int rr = role == 0 ? outer : inner, kk = role == 0 ? inner : outer;
      const int i = role == 0 ? o0 + rr : k0 + kk;
      const int j = role == 0 ? k0 + kk : o0 + rr;
      dst[rr][kk] = (i < l && j < l) ? dsb[(int64_t)i * l + j] : 0.f;
    }
    for (int e = t; e < kTile * kNCols; e += kThreads) {
      const int kk = e / kNCols, nn = e % kNCols;
      op[kk][nn] = (k0 + kk < l && n0 + nn < n)
                       ? ld(src + (int64_t)(k0 + kk) * n + n0 + nn)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float dv = dst[r][kk];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = fmaf(dv, op[kk][q + 8 * u], acc[u]);
    }
    __syncthreads();
  }
  float* out = (role == 0 ? dc : db) + (int64_t)c * l * n;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = o0 + r, col = n0 + q + 8 * u;
    if (i < l && col < n) out[(int64_t)i * n + col] = acc[u];
  }
}

int sm_count(int device) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (cached[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        v <= 0)
      v = 132;
    cached[device] = v;
  }
  return cached[device];
}

template <typename T>
cudaError_t launch(const float* a, const void* bp, const void* cp,
                   const void* xp, const float* dy, float* s, float* dsh,
                   float* ds, float* da, float* db, float* dc, float* dx,
                   int n_c, int n_h, int l, int n, int p, int device,
                   cudaStream_t st) {
  const T* b = static_cast<const T*>(bp);
  const T* cm = static_cast<const T*>(cp);
  const T* x = static_cast<const T*>(xp);
  const int nt = (l + kTile - 1) / kTile;
  ssd_bwd_scores_kernel<T><<<dim3(nt * (nt + 1) / 2, n_c), kThreads, 0, st>>>(
      b, cm, s, l, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = ssd_bwd_head_smem_floats(l, p) * (int)sizeof(float);
  err = cudaFuncSetAttribute(ssd_bwd_head_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_head_kernel<T><<<dim3(n_h, n_c), kThreads, smem, st>>>(
      a, x, dy, s, dsh, da, dx, n_h, l, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)n_c * l * l;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count(device) * 8;
  if (blocks > cap) blocks = cap;
  ssd_bwd_sum_heads_kernel<<<(int)blocks, kThreads, 0, st>>>(dsh, ds, n_h, l,
                                                              total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncol = (n + kNCols - 1) / kNCols;
  ssd_bwd_bc_kernel<T><<<dim3(nt * ncol, n_c, 2), kThreads, 0, st>>>(
      ds, b, cm, db, dc, l, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the head kernel for (l, p), in bytes; the wrapper
// refuses shapes past the 227 KB a block may use.
int ssd_intra_bwd_smem_bytes(int l, int p) {
  return ssd_bwd_head_smem_floats(l, p) * (int)sizeof(float);
}

// Backward of the intra-chunk block (see the header). a (C, H, l) f32; b, c
// (C, l, N) and x (C, l, H, P) in bf16 when `bf16`, else f32; dy (C, l, H, P)
// f32. Workspaces: s and ds (C, l, l) f32, dsh (C, H, l, l) f32. Outputs, all
// f32: da (C, H, l), db and dc (C, l, N), dx (C, l, H, P). Launches on
// `stream` and returns the first cudaError_t (0 = ok).
int ssd_intra_bwd_launch(const void* a, const void* b, const void* c,
                         const void* x, const void* dy, void* s, void* dsh,
                         void* ds, void* da, void* db, void* dc, void* dx,
                         int n_c, int n_h, int l, int n, int p, int bf16,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l < 1 || l > kMaxLen || n_c < 1 || n_c > 65535 || n_h < 1 ||
      n_h > 65535 || n < 1 || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dyf = static_cast<const float*>(dy);
  float *sf = static_cast<float*>(s), *dshf = static_cast<float*>(dsh),
        *dsf = static_cast<float*>(ds), *daf = static_cast<float*>(da),
        *dbf = static_cast<float*>(db), *dcf = static_cast<float*>(dc),
        *dxf = static_cast<float*>(dx);
  if (bf16)
    err = launch<__nv_bfloat16>(af, b, c, x, dyf, sf, dshf, dsf, daf, dbf,
                                dcf, dxf, n_c, n_h, l, n, p, device, st);
  else
    err = launch<float>(af, b, c, x, dyf, sf, dshf, dsf, daf, dbf, dcf, dxf,
                        n_c, n_h, l, n, p, device, st);
  return static_cast<int>(err);
}

const char* ssd_intra_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
