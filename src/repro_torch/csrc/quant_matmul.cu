// Dense int8-weight matmul with per-output-channel scales for Hopper
// (sm_90a): the non-sparse CIM macro, the paper's baseline.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quant_matmul.py
// (quant_matmul, pallas_call at :55, body _kernel :21). It computes
//   y[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n]
// with x (M, K) f32 or bf16 (row stride ldx >= K), w (K, N) int8 levels,
// scale (N,) f32 and y (M, N) f32. The scale multiplies once, after the
// whole K sum, as the TPU kernel's _finish does: MARS scales are per output
// group (eq. 8), so they factor out of the sum.
//
// What bounds it. Counted, every yi-6b shape is bound by bytes: the K*N
// int8 weight over the HBM rate, at decode (M = 4) and at prefill (M = 128)
// alike once the product runs on the bf16 tensor cores. f32 x
// (kernel_bench's 256 x 1024 x 1024) is bound by operations: three bf16
// products per multiply-add (below). Measured (PERF.md), decode is held by
// the weight stream itself; prefill also re-reads x from L2 for every
// column tile and moves the split-K partial sums; a product as small as
// kernel_bench's is mostly pipeline fill and the two launches.
//
// Design, against what held the first (FFMA) kernel back:
// - Tensor cores. mma.sync m16n8k16 bf16 x bf16 -> f32. An int8 level
//   widened to bf16 is exact (|w| <= 127 needs 7 bits), bf16 x is used as it
//   is, and the products sum in f32 registers. f32 x is split into three
//   bf16 planes, x = x0 + x1 + x2 with x0 = bf16(x), x1 = bf16(x - x0),
//   x2 = bf16(x - x0 - x1), exact for normal f32 (8 + 8 + 8 significant
//   bits cover 24); each plane times a level is exact in f32, so three MMAs
//   against one B fragment compute the f32 product (the CPU twin is
//   split_bf16x3 in kernels/quant_matmul.py). TF32 would round x to 10 bits.
// - The weight fragment is built from 32-bit words of the staged int8 tile
//   without a transposing pass: thread (g, t) of a warp reads the word
//   holding columns 4g..4g+3 at rows 2t, 2t+1, 2t+8, 2t+9 of a k16 step and
//   feeds byte j to n8 tile j. Output column 4g + j of the warp's 32 thus
//   sits at MMA column g of tile j, so each thread ends up holding the 8
//   contiguous columns 8t..8t+7 of its two rows: two 16-byte stores.
//   Bytes widen by a byte permute into the mantissa of 2^23 (+128 offset),
//   one f32 subtract, and a permute that keeps the upper (bf16) halves.
// - 16-byte cp.async.cg copies of x and W into a ring of kStages stages in
//   dynamic shared memory, kStages - 1 tiles in flight while one is
//   multiplied. Rows are padded (x: 8 elements, W: 16 bytes) so that the
//   fragment reads hit 32 distinct banks. Ragged edges are zero-filled by
//   cp.async's src-size operand, never read past.
// - The tile height is a template: BM 16 / 64 / 128 rows by 128 columns,
//   4 warps across the columns (32 each) and, from 64 rows, 2 down the
//   rows. Decode-sized M takes one m16 tile (rows past M are zeros; the
//   kernel is bound by bytes there, so the idle MMA rows cost nothing).
//   f32 x stops at 64 rows: its stage is twice as wide and each k-step
//   three MMAs deep, so 128 rows would fit one block per SM.
// - Deterministic split-K. When the output tiles fill less than one wave
//   of the SMs, the wrapper cuts K into S slices of whole stages
//   (blockIdx.z); each writes its f32 partial sums to a workspace, and a
//   second kernel over the whole grid adds the slices in slice order and
//   then multiplies by the scale. No atomics: the same inputs and plan give
//   the same bits. (Letting each tile's last block add its slices, behind
//   an int counter, saves the launch but leaves the adding to one block per
//   tile: slower on the prefill rows, where w_down has 32 tiles.)
// - Operands that miss the 16-byte conditions (pointer alignment, x's row
//   stride and K a multiple of 16 bytes, N a multiple of 16) take the same
//   kernel with element-wise masked loads and stores (ALIGNED = false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 64;             // K per stage
constexpr int kStages = 4;
constexpr int kWPitch = kBN + 16;   // bytes per staged W row
constexpr int kXPitch = kBK + 8;    // elements per staged x row
constexpr int kMaxDevices = 64;

// BM rows by kBN columns per block: one warp per 32 columns, and 2 down
// the rows when BM >= 64
template <int BM>
struct Warps {
  static constexpr int kN = kBN / 32;
  static constexpr int kM = BM == 16 ? 1 : 2;
  static constexpr int kThreads = 32 * kN * kM;
  static constexpr int kRows = BM / kM;  // rows per warp
};

template <typename T, int BM>
struct Smem {
  static constexpr int kX = BM * kXPitch * (int)sizeof(T);
  static constexpr int kW = kBK * kWPitch;
  static constexpr int kStage = kX + kW;
  static constexpr int kTotal = kStages * kStage;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_size 0 writes 16 zero bytes and reads
// nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte J of a (w ^ 0x80808080) word as the exact f32 level: the byte
// (level + 128) goes into the mantissa of 2^23, then 2^23 + 128 comes off
__device__ __forceinline__ float level_f32(uint32_t wx, int j) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 | j)) -
         8388736.f;
}

// bf16x2 of byte J of two words (low half from `lo`): an integer of at
// most 8 bits is exact in bf16, so the f32's upper halves are its bf16
__device__ __forceinline__ uint32_t levels_bf16x2(uint32_t lo, uint32_t hi,
                                                  int j) {
  return __byte_perm(__float_as_uint(level_f32(lo, j)),
                     __float_as_uint(level_f32(hi, j)), 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the three bf16 planes of an f32 pair (a low, b high), x = p0 + p1 + p2
__device__ __forceinline__ void split3(float2 v, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = v.x - f0.x, rb = v.y - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  p0 = bf16x2_bits(h0);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(__floats2bfloat162_rn(ra - f1.x, rb - f1.y));
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

// one stage: x rows [m0, m0 + BM) and W columns [n0, n0 + kBN), both over
// k in [k0, min(k0 + kBK, k_end))
template <typename T, int BM, bool ALIGNED>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const T* __restrict__ x, const int8_t* __restrict__ w,
    int M, int N, int64_t ldx, int m0, int n0, int k0, int k_end, int tid) {
  constexpr int kThreads = Warps<BM>::kThreads;
  T* xs = reinterpret_cast<T*>(st);
  int8_t* ws = reinterpret_cast<int8_t*>(st + Smem<T, BM>::kX);
  if constexpr (ALIGNED) {
    constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
    constexpr int kRowChunks = kBK / kVec;
    for (int i = tid; i < BM * kRowChunks; i += kThreads) {
      const int r = i / kRowChunks, c = (i % kRowChunks) * kVec;
      const int gm = m0 + r, gk = k0 + c;
      const bool in = gm < M && gk < k_end;
      cp_async16(xs + r * kXPitch + c, in ? x + gm * ldx + gk : x,
                 in ? 16 : 0);
    }
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < k_end && gn < N;
      cp_async16(ws + r * kWPitch + c, in ? w + (int64_t)gk * N + gn : w,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r * kXPitch + c] =
          (gm < M && gk < k_end) ? x[gm * ldx + gk] : zero_of(T());
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r * kWPitch + c] =
          (gk < k_end && gn < N) ? w[(int64_t)gk * N + gn] : int8_t(0);
    }
  }
}

// y for the block's BM x kBN tile over k in [z * k_slice, (z + 1) * k_slice),
// z = blockIdx.z; split (gridDim.z > 1), the slice's partial sums without
// the scale, at part + z * M * N, for split_k_reduce
// (minimum 1 block per SM in the launch bounds: without it ptxas held the
// 256-thread f32 tiles to 80 registers and spilled)
template <typename T, int BM, bool ALIGNED>
__global__ void __launch_bounds__(Warps<BM>::kThreads, 1)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ y,
                    float* __restrict__ part, int M, int N, int K,
                    int64_t ldx, int k_slice) {
  constexpr int MT = Warps<BM>::kRows / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % Warps<BM>::kN;
  const int wrow = warp / Warps<BM>::kN * Warps<BM>::kRows;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T, BM, ALIGNED>(smem + s * Smem<T, BM>::kStage, x, w, M, N,
                                 ldx, m0, n0, k_begin + s * kBK, k_end, tid);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free to refill
    const int nxt = it + kStages - 1;
    if (nxt < nk)
      load_stage<T, BM, ALIGNED>(smem + (nxt % kStages) * Smem<T, BM>::kStage,
                                 x, w, M, N, ldx, m0, n0,
                                 k_begin + nxt * kBK, k_end, tid);
    cp_async_commit();

    const unsigned char* st = smem + (it % kStages) * Smem<T, BM>::kStage;
    const T* xs = reinterpret_cast<const T*>(st);
    const unsigned char* ws = st + Smem<T, BM>::kX + wn * 32 + 4 * g;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned char* wr = ws + (kk * 16 + 2 * t) * kWPitch;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(wr) ^ 0x80808080u;
      const uint32_t r1 =
          *reinterpret_cast<const uint32_t*>(wr + kWPitch) ^ 0x80808080u;
      const uint32_t r2 =
          *reinterpret_cast<const uint32_t*>(wr + 8 * kWPitch) ^ 0x80808080u;
      const uint32_t r3 =
          *reinterpret_cast<const uint32_t*>(wr + 9 * kWPitch) ^ 0x80808080u;
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = levels_bf16x2(r0, r1, j);
        b[j][1] = levels_bf16x2(r2, r3, j);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (sizeof(T) == 2) {
          uint32_t a[4];
          const T* p = xs + (wrow + mt * 16 + (lane & 15)) * kXPitch +
                       kk * 16 + (lane >> 4) * 8;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
              : "r"(smem_addr(p)));
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, b[j]);
        } else {
          const T* p = xs + (wrow + mt * 16 + g) * kXPitch + kk * 16 + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(p);
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kXPitch);
          const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 v3 =
              *reinterpret_cast<const float2*>(p + 8 * kXPitch + 8);
          uint32_t a[3][4];
          split3(v0, a[0][0], a[1][0], a[2][0]);
          split3(v1, a[0][1], a[1][1], a[2][1]);
          split3(v2, a[0][2], a[1][2], a[2][2]);
          split3(v3, a[0][3], a[1][3], a[2][3]);
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a[pl], b[j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may land after the block exits

  // thread (g, t) holds columns 8t..8t+7 of the warp's 32 (column 4c + j
  // at MMA column c of tile j) for rows g and g + 8 of each m16 tile
  const int col = n0 + wn * 32 + 8 * t;
  const bool split = gridDim.z > 1;
  float* out = split ? part + (int64_t)blockIdx.z * M * N : y;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wrow + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h];
        v[4 + j] = acc[mt][j][2 * h + 1];
      }
      float* dst = out + (int64_t)row * N + col;
      if constexpr (ALIGNED) {
        if (col >= N) continue;  // N % 16 == 0: 8 columns all in or all out
        if (!split) {
          const float4 s0 = *reinterpret_cast<const float4*>(scale + col);
          const float4 s1 = *reinterpret_cast<const float4*>(scale + col + 4);
          v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
          v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
        }
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (col + c < N)
            dst[c] = split ? v[c] : v[c] * scale[col + c];
      }
    }
  }
}

// y = (sum over slices z = 0, 1, ... of part[z]) * scale, the slices added
// in order
__global__ void __launch_bounds__(256)
split_k_reduce(const float* __restrict__ part, const float* __restrict__ scale,
               float* __restrict__ y, int64_t mn, int N, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * mn + i];
    y[i] = s * scale[i % N];
  }
}

// one call's operands and plan, as the C entry point takes them
struct Launch {
  const void* x;
  const int8_t* w;
  const float* scale;
  float* y;
  float* part;  // splits * M * N f32 partial sums, when splits > 1
  int M, N, K;
  int64_t ldx;
  int k_slice, splits, device;
  cudaStream_t stream;
};

template <typename T, int BM, bool ALIGNED>
cudaError_t launch(const Launch& a) {
  constexpr int smem = Smem<T, BM>::kTotal;
  static bool configured[kMaxDevices] = {};
  if (a.device < 0 || a.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[a.device]) {  // dynamic shared memory above 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        quant_matmul_kernel<T, BM, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[a.device] = true;
  }
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM, a.splits);
  quant_matmul_kernel<T, BM, ALIGNED>
      <<<grid, Warps<BM>::kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.x), a.w, a.scale, a.y, a.part, a.M, a.N,
          a.K, a.ldx, a.k_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int64_t mn = (int64_t)a.M * a.N;
  const int blocks = (int)(mn / 256 + 1 < 8192 ? mn / 256 + 1 : 8192);
  split_k_reduce<<<blocks, 256, 0, a.stream>>>(a.part, a.scale, a.y, mn, a.N,
                                               a.splits);
  return cudaGetLastError();
}

template <typename T, bool ALIGNED>
cudaError_t launch_bm(int bm, const Launch& a) {
  switch (bm) {
    case 16:
      return launch<T, 16, ALIGNED>(a);
    case 64:
      return launch<T, 64, ALIGNED>(a);
    case 128:  // bf16 x only: f32 x stops at 64 rows (three MMAs a step)
      if constexpr (sizeof(T) == 2) return launch<T, 128, ALIGNED>(a);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// y = (x @ w) * scale on the plan the wrapper chose: tile height bm (16,
// 64 or 128), `splits` K slices of k_slice (a multiple of 64) with the
// partial sums in `workspace` (splits * M * N f32, unused when splits is
// 1), and the 16-byte path when `aligned`, which it checks again here. x
// has row stride ldx (elements); w, scale and y are contiguous. Launches on
// `stream` of device `device` and returns the first cudaError_t of the
// launches (0 = ok).
int quant_matmul_launch(const void* x, int is_bf16, const void* w,
                        const void* scale, void* y, void* workspace, int M,
                        int N, int K, int64_t ldx, int bm, int splits,
                        int k_slice, int aligned, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || splits > 65535 || k_slice % kBK != 0 ||
      (splits > 1 && !workspace) ||
      (int64_t)splits * k_slice < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = is_bf16 ? 8 : 4;
  if (aligned && !(aligned16(x) && aligned16(w) && aligned16(scale) &&
                   aligned16(y) && aligned16(workspace) && ldx % vec == 0 &&
                   K % vec == 0 && N % 16 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{x, static_cast<const int8_t*>(w),
                 static_cast<const float*>(scale), static_cast<float*>(y),
                 static_cast<float*>(workspace), M, N, K, ldx, k_slice,
                 splits, device,
                 static_cast<cudaStream_t>(stream)};
  if (is_bf16)
    err = aligned ? launch_bm<__nv_bfloat16, true>(bm, a)
                  : launch_bm<__nv_bfloat16, false>(bm, a);
  else
    err = aligned ? launch_bm<float, true>(bm, a)
                  : launch_bm<float, false>(bm, a);
  return static_cast<int>(err);
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
