// Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_intra.py
// (ssd_intra_chunk, body _kernel :30). For one chunk c and head h:
//   cum    = cumsum(a[c, h, :])                                 (l,)
//   L[i,j] = exp(cum_i - cum_j) for i >= j, else 0              (l, l)
//   y[c, :, h, :] = ((C_c B_c^T) o L) @ x[c, :, h, :]           (l, P)
// with a (C, H, l) f32; b, c (C, l, N) and x (C, l, H, P) in f32 or bf16
// (one type); y (C, l, H, P) in f32. No l x l intermediate reaches device
// memory.
//
// What bounds it. Per chunk the least work is C B^T over the causal pairs
// once (b and c are one group for all heads) and (S o L) @ x per head. On
// bf16 tensor cores that is 0.0034 ms at the serving shape (C 16, H 48,
// l 256, N 128, P 64), under the 0.0234 ms that its 78 MB take over HBM,
// two thirds of them the f32 y: the kernel is bound by bytes once the
// products run on tensor cores and S is not recomputed per head.
//
// Design (the first version ran f32 FFMA, one block per chunk and head,
// and recomputed C B^T for each of the 48 heads):
// - A block owns (chunk, 64-row i-tile, group of heads). Blocks are
//   numbered heaviest i-tile first (the last i-tile has 4x the first's
//   causal work at l = 256), so the hardware's in-order dispatch balances
//   the causal load over the SMs; kernels/ssd_intra.py's plan() picks the
//   group size from the shapes and the SM count.
// - Phase 1: S = C_i B_j^T for the i-tile's rows and every column j < i0 +
//   64 (tiles above the diagonal are skipped), once for the whole head
//   group, by mma.sync m16n8k16 bf16 -> f32 over 32-wide slices of N. S
//   stays in shared memory in f32: 64 x 256 floats at l = 256. bf16 b and
//   c multiply exactly (one MMA a step); f32 b and c go in as three exact
//   bf16 planes each (x = x0 + x1 + x2, as quant_matmul.cu splits f32 x)
//   and the six plane products of order <= 2^-16 are kept.
// - Phase 2, two heads at a time (warps 0-3 and 4-7, one 16-row m-tile a
//   warp, all 64 columns of a P tile): each warp builds the A fragments of
//   S o L straight from S and the decay, taking exp only where i >= j, once
//   per (i, j, head) at P <= 64, and multiplies them with x[:, h] (32 rows
//   a stage, ldmatrix.trans into B fragments). S o L is f32: it goes in as
//   a bf16 hi plane and lo = bf16(v - hi), two MMAs against the exact bf16
//   x (relative error <= 2^-17 per term); with f32 x both sides take three
//   planes (six MMAs).
// - Both phases stream their operands through one ring of four stages
//   filled by 16-byte cp.async, three copies in flight, as one stream (the
//   first x slices are in flight while S is finished), with the loop
//   counters kept incrementally (no division in the loops). The decay's
//   exp is one ex2.approx.ftz (expf and __expf add a subnormal fix-up of
//   five instructions a value), and the causal mask is applied only on
//   the steps that reach the diagonal. The block is bound by instruction
//   latency at two blocks of eight warps per SM (S takes 66 KB of shared
//   memory per block): no single part (the exps, the second MMA plane,
//   the products, the f32 y store) holds most of its time.
// - The decay is exp(e_i - e_j) with e an f32 prefix sum of a taken from
//   the i-tile's first row (forward over the tile, backward below it),
//   for every head of the group once per block, so no exponent is factored
//   through the tile origin (the factors would overflow) and the
//   difference of two nearby prefix sums is not taken between numbers as
//   large as the whole chunk's cumsum.
// - y is written once in f32 by the warp that owns it. Columns past 256
//   (l > 256) run in further passes over S, each adding to y in order:
//   the same bits in every run, no atomics.
// - Operands off the 16-byte conditions (pointers, N or P times the
//   element size not a multiple of 16) take the same kernel with
//   element-wise loads and stores (ALIGNED = false); any l, N, P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 64;        // rows of an i-tile
constexpr int kJC = 64;        // S columns a phase-1 output chunk covers
constexpr int kNK = 32;        // slice of N per phase-1 stage
constexpr int kJS = 32;        // x rows (S columns) per phase-2 stage
constexpr int kPT = 64;        // columns of a P tile
constexpr int kCBPitch = kNK + 8;  // elements per staged c or b row
constexpr int kXPitch = kPT + 8;   // elements per staged x row
constexpr int kStages = 4;         // ring depth: three copies in flight
constexpr int kStageElems = 2 * kBM * kCBPitch > 2 * kJS * kXPitch
                                ? 2 * kBM * kCBPitch : 2 * kJS * kXPitch;
constexpr int kMaxSJ = 256;    // S columns per pass
constexpr int kMaxDevices = 64;

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

// a pure register operation: not volatile, so the compiler may schedule the
// decay's ALU work around it
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the three bf16 planes of an f32 pair (x low, y high): v = p0 + p1 + p2,
// exact for normal f32
__device__ __forceinline__ void split3(float2 v, uint32_t* p) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = v.x - f0.x, rb = v.y - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  p[0] = bf16x2_bits(h0);
  p[1] = bf16x2_bits(h1);
  p[2] = bf16x2_bits(__floats2bfloat162_rn(ra - f1.x, rb - f1.y));
}

// an f32 pair as hi + lo bf16 planes: lo = bf16(v - hi), v - (hi + lo)
// within 2^-17 |v|
__device__ __forceinline__ void split2(float2 v, uint32_t* p) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f0 = __bfloat1622float2(h0);
  p[0] = bf16x2_bits(h0);
  p[1] = bf16x2_bits(__floats2bfloat162_rn(v.x - f0.x, v.y - f0.y));
}

// planes of an operand element pair (two consecutive elements at p): bf16
// is one plane as it is, f32 three
template <typename T>
struct Op;
template <>
struct Op<__nv_bfloat16> {
  static constexpr int kPlanes = 1;
  static constexpr int kVPlanes = 2;  // planes of the f32 S o L
  static __device__ __forceinline__ void pair(const __nv_bfloat16* p,
                                              uint32_t* out) {
    out[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void pair(float2 v, uint32_t* out) {
    out[0] = bf16x2_bits(__floats2bfloat162_rn(v.x, v.y));  // exact here
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.f);
  }
  static __device__ __forceinline__ float f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};
template <>
struct Op<float> {
  static constexpr int kPlanes = 3;
  static constexpr int kVPlanes = 3;
  static __device__ __forceinline__ void pair(const float* p, uint32_t* out) {
    split3(*reinterpret_cast<const float2*>(p), out);
  }
  static __device__ __forceinline__ void pair(float2 v, uint32_t* out) {
    split3(v, out);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float f32(float v) { return v; }
};

// acc += A B over plane pairs (pa, pb) with pa + pb <= max(PA, PB) - 1: all
// of them for bf16 operands, the six of order <= 2^-16 for three planes
template <int PA, int PB>
__device__ __forceinline__ void mma_planes(float* acc, const uint32_t (*a)[4],
                                           const uint32_t (*b)[2]) {
  constexpr int kOrder = (PA > PB ? PA : PB) - 1;
#pragma unroll
  for (int pa = PA - 1; pa >= 0; --pa)
#pragma unroll
    for (int pb = PB - 1; pb >= 0; --pb)
      if (pa + pb <= kOrder) mma_bf16(acc, a[pa], b[pb]);
}

struct Params {
  const float* a;
  const void* b;
  const void* c;
  const void* x;
  float* y;
  int C, H, l, N, P;
  int group;   // heads per block
  int groups;  // ceil(H / group)
  int n_it;    // i-tiles, ceil(l / 64)
  int lpad;    // n_it * 64
  int sj;      // S columns per pass: min(lpad, 256)
};

// one phase-1 stage: rows [i0, i0 + 64) of c and [j0, j0 + 64) of b, both
// over N columns [n0, n0 + kNK), zero past l and N
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_cb(T* st, const T* __restrict__ cg,
                                        const T* __restrict__ bg, int l, int N,
                                        int i0, int j0, int n0, int tid) {
  if constexpr (ALIGNED) {
    constexpr int kV = 16 / (int)sizeof(T);
    constexpr int kChunks = kNK / kV;
    for (int q = tid; q < 2 * kBM * kChunks; q += kThreads) {
      const int which = q / (kBM * kChunks);
      const int r = (q / kChunks) % kBM, col = (q % kChunks) * kV;
      const int row = (which ? j0 : i0) + r, n = n0 + col;
      const T* src = which ? bg : cg;
      const bool in = row < l && n < N;
      cp_async16(st + (which * kBM + r) * kCBPitch + col,
                 in ? src + (size_t)row * N + n : src, in ? 16 : 0);
    }
  } else {
    for (int q = tid; q < 2 * kBM * kNK; q += kThreads) {
      const int which = q / (kBM * kNK);
      const int r = (q / kNK) % kBM, col = q % kNK;
      const int row = (which ? j0 : i0) + r, n = n0 + col;
      const T* src = which ? bg : cg;
      st[(which * kBM + r) * kCBPitch + col] =
          (row < l && n < N) ? src[(size_t)row * N + n] : Op<T>::zero();
    }
  }
}

// one phase-2 stage: x rows [j0, j0 + kJS) of heads h and h + 1 (the
// second only when h + 1 < h_end), P columns [p0, p0 + 64), zero elsewhere
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_x(T* st, const T* __restrict__ xg, int l,
                                       int H, int P, int j0, int h, int h_end,
                                       int p0, int tid) {
  if constexpr (ALIGNED) {
    constexpr int kV = 16 / (int)sizeof(T);
    constexpr int kChunks = kPT / kV;
    for (int q = tid; q < 2 * kJS * kChunks; q += kThreads) {
      const int k = q / (kJS * kChunks);
      const int r = (q / kChunks) % kJS, col = (q % kChunks) * kV;
      const int j = j0 + r, p = p0 + col;
      const bool in = j < l && p < P && h + k < h_end;
      cp_async16(st + (k * kJS + r) * kXPitch + col,
                 in ? xg + ((size_t)j * H + h + k) * P + p : xg, in ? 16 : 0);
    }
  } else {
    for (int q = tid; q < 2 * kJS * kPT; q += kThreads) {
      const int k = q / (kJS * kPT);
      const int r = (q / kPT) % kJS, col = q % kPT;
      const int j = j0 + r, p = p0 + col;
      st[(k * kJS + r) * kXPitch + col] =
          (j < l && p < P && h + k < h_end)
              ? xg[((size_t)j * H + h + k) * P + p] : Op<T>::zero();
    }
  }
}

// e[k] for k in [0, i0 + 64): 0 at i0, sum a(i0, k] above it (a = 0 past
// l), -sum a(k, i0] below it; so e_i - e_j = sum a(j, i] = cum_i - cum_j.
// One warp per direction: each lane sums a segment, a shuffle scan gives
// the segment offsets, each lane then writes its running sums.
__device__ __forceinline__ void tile_cum(const float* __restrict__ ah,
                                         float* e, int i0, int l, bool fwd,
                                         int lane) {
  const int n = fwd ? kBM - 1 : i0;  // positions beside i0
  const int seg = (n + 31) >> 5;
  const int m0 = lane * seg + 1, m1 = min(n, (lane + 1) * seg);
  auto term = [&](int m) {
    if (fwd) return i0 + m < l ? ah[i0 + m] : 0.f;
    return -ah[i0 - m + 1];
  };
  float part = 0.f;
  for (int m = m0; m <= m1; ++m) part += term(m);
  float incl = part;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
  for (int m = m0; m <= m1; ++m) {
    run += term(m);
    e[fwd ? i0 + m : i0 - m] = run;
  }
  if (fwd && lane == 0) e[i0] = 0.f;
}

// e^x by ex2.approx.ftz (results below 2^-126 flush to 0; one MUFU op, no
// subnormal fix-up as expf's and __expf's)
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// the A fragment planes of one k16 step of S o L: rows (row0, row0 + 8) of
// the warp's m-tile (S row pointer srow at column 2t of the step) times
// exp(e_i - e_j) for columns col0 + {0, 1, 8, 9} (ecol: e at col0); with
// MASK the entries above the diagonal are 0 (their exp is not used)
template <int VPL, bool MASK>
__device__ __forceinline__ void decayed_a(uint32_t (*af)[4],
                                          const float* srow, int sp,
                                          const float* ecol, float e0,
                                          float e1, int row0, int col0) {
  const float2 ej[2] = {*reinterpret_cast<const float2*>(ecol),
                        *reinterpret_cast<const float2*>(ecol + 8)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float er = r ? e1 : e0;
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const float2 sv =
          *reinterpret_cast<const float2*>(srow + r * 8 * sp + hc * 8);
      const int col = col0 + 8 * hc;
      float2 v = make_float2(sv.x * exp_ftz(er - ej[hc].x),
                             sv.y * exp_ftz(er - ej[hc].y));
      if (MASK) {
        v.x = col <= row ? v.x : 0.f;
        v.y = col + 1 <= row ? v.y : 0.f;
      }
      uint32_t pl[3];
      if constexpr (VPL == 2) split2(v, pl);
      else split3(v, pl);
#pragma unroll
      for (int p = 0; p < VPL; ++p) af[p][r + 2 * hc] = pl[p];
    }
  }
}

__host__ __device__ constexpr int ring_bytes(int elem) {
  return kStages * kStageElems * elem;
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_kernel(const Params prm) {
  using O = Op<T>;
  constexpr int PL = O::kPlanes, VPL = O::kVPlanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* S = reinterpret_cast<float*>(smem + ring_bytes(sizeof(T)));
  const int sp = prm.sj + 8;  // S pitch: == 8 mod 32, conflict-free pairs
  float* E = S + kBM * sp;    // [heads of the group][lpad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3;  // m16 tile of the i-tile
  const int wh = warp >> 2;  // phase 1: column half; phase 2: head of pair

  // blocks numbered heaviest i-tile first
  const int per_tile = prm.C * prm.groups;
  const int it = prm.n_it - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const int ci = rem / prm.groups, grp = rem % prm.groups;
  const int h_begin = grp * prm.group;
  const int h_end = min(prm.H, h_begin + prm.group);
  const int l = prm.l, N = prm.N, P = prm.P, H = prm.H;
  const int i0 = it * kBM, J = i0 + kBM;

  const T* cg = static_cast<const T*>(prm.c) + (size_t)ci * l * N;
  const T* bg = static_cast<const T*>(prm.b) + (size_t)ci * l * N;
  const T* xg = static_cast<const T*>(prm.x) + (size_t)ci * l * H * P;
  const float* ag = prm.a + (size_t)ci * H * l;
  float* yg = prm.y + (size_t)ci * l * H * P;

  const int n_pairs = (h_end - h_begin + 1) / 2;
  const int n_pc = (P + kPT - 1) / kPT;
  const int n_ns = (N + kNK - 1) / kNK;

  const int row0 = i0 + 16 * mt + g, row1 = row0 + 8;
  const int last_causal = i0 + 16 * mt;  // columns <= it are causal for all
                                         // of the warp's rows

  for (int jb = 0; jb < J; jb += prm.sj) {  // passes over S's columns
    const int cols = min(J, jb + prm.sj) - jb;

    const int n_jc = cols / kJC, n_u = n_jc * n_ns;
    const int n_sl = cols / kJS, n_t = n_pairs * n_pc * n_sl;
    // one stream of copies through the ring for the pass: phase 1's stages
    // (chunk of S, slice of N), then phase 2's (pair, P tile, slice of x),
    // so that phase 2's first copies fly while phase 1 ends
    int ld = 0, ld_a = 0, ld_b = 0, ld_q = 0;  // the next stage's counters
    auto issue = [&]() {
      T* slot = ring + (ld % kStages) * kStageElems;
      if (ld < n_u) {
        load_cb<T, ALIGNED>(slot, cg, bg, l, N, i0, jb + ld_b * kJC,
                            ld_a * kNK, tid);
        if (++ld_a == n_ns) {
          ld_a = 0;
          if (++ld_b == n_jc) ld_b = 0;
        }
      } else if (ld < n_u + n_t) {
        load_x<T, ALIGNED>(slot, xg, l, H, P, jb + ld_a * kJS,
                           h_begin + 2 * ld_q, h_end, ld_b * kPT, tid);
        if (++ld_a == n_sl) {
          ld_a = 0;
          if (++ld_b == n_pc) {
            ld_b = 0;
            ++ld_q;
          }
        }
      }
      ++ld;
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) issue();

    // ---- phase 1: S[:, jb : jb + cols] = C_i B_j^T, 64 columns at a
    // time, over slices of N ----
    {
      if (jb == 0) {
        // the decay's prefix sums of every head of the group, once per
        // block, behind the first copies (read after phase 1's barriers)
        for (int job = warp; job < 2 * (h_end - h_begin); job += kThreads / 32)
          tile_cum(ag + (size_t)(h_begin + job / 2) * l,
                   E + (job / 2) * prm.lpad, i0, l, (job & 1) == 0, lane);
      }
      int u = 0;
      for (int jc = 0; jc < n_jc; ++jc) {
        float acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[q][k] = 0.f;
        // warp (mt, wh): rows 16 mt.., columns 32 wh.. of the chunk; none
        // of them causal when the columns all lie above the rows
        const bool live = jb + jc * kJC + 32 * wh <= last_causal + 15;
        for (int ns = 0; ns < n_ns; ++ns, ++u) {
          cp_async_wait<kStages - 2>();
          __syncthreads();  // stage u landed; slot u - 1 is free
          issue();
          if (!live) continue;
          const T* cs = ring + (u % kStages) * kStageElems;
          const T* bs = cs + kBM * kCBPitch;
#pragma unroll
          for (int kk = 0; kk < kNK / 16; ++kk) {
            uint32_t af[PL][4];
            uint32_t tmp[PL];
            const T* ap = cs + (16 * mt + g) * kCBPitch + kk * 16 + 2 * t;
            O::pair(ap, tmp);
#pragma unroll
            for (int p = 0; p < PL; ++p) af[p][0] = tmp[p];
            O::pair(ap + 8 * kCBPitch, tmp);
#pragma unroll
            for (int p = 0; p < PL; ++p) af[p][1] = tmp[p];
            O::pair(ap + 8, tmp);
#pragma unroll
            for (int p = 0; p < PL; ++p) af[p][2] = tmp[p];
            O::pair(ap + 8 * kCBPitch + 8, tmp);
#pragma unroll
            for (int p = 0; p < PL; ++p) af[p][3] = tmp[p];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t bf[PL][2];
              const T* bp =
                  bs + (32 * wh + 8 * q + g) * kCBPitch + kk * 16 + 2 * t;
              O::pair(bp, tmp);
#pragma unroll
              for (int p = 0; p < PL; ++p) bf[p][0] = tmp[p];
              O::pair(bp + 8, tmp);
#pragma unroll
              for (int p = 0; p < PL; ++p) bf[p][1] = tmp[p];
              mma_planes<PL, PL>(acc[q], af, bf);
            }
          }
        }
        // the 64 columns of chunk jc are complete (zero when N == 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* dst = S + (16 * mt + g) * sp + jc * kJC + 32 * wh + 8 * q +
                       2 * t;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[q][0], acc[q][1]);
          *reinterpret_cast<float2*>(dst + 8 * sp) =
              make_float2(acc[q][2], acc[q][3]);
        }
      }
      __syncthreads();  // S complete (phase 2's first copies are in flight)
    }

    // ---- phase 2: y[i-tile, h] (+)= (S o L_h) @ x[:, h], two heads at a
    // time, over (pair, P tile, slice of kJS columns) ----
    int tt = n_u;  // the stage index continues phase 1's
    for (int q = 0; q < n_pairs; ++q) {
      const int h = h_begin + 2 * q + wh;
      const bool live = h < h_end;
      const float* e = E + (live ? h - h_begin : 0) * prm.lpad;
      const float e0 = e[row0], e1 = e[row1];
      for (int pc = 0; pc < n_pc; ++pc) {
        float acc[8][4];
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[n8][k] = 0.f;
        for (int s = 0; s < n_sl; ++s, ++tt) {
          cp_async_wait<kStages - 2>();
          __syncthreads();  // stage tt landed; slot tt - 1 is free
          issue();
          const int js = jb + s * kJS;  // first column of the slice
          // a slice past the warp's last row is all above the diagonal
          if (!live || js > last_causal + 15) continue;
          const T* xs =
              ring + (tt % kStages) * kStageElems + wh * kJS * kXPitch;
          // A = S o L for rows (row0, row1) x columns js + 16 kk + 2t +
          // {0, 1, 8, 9}, every step of the slice first (independent ALU
          // work), then the products; the causal mask only where a step
          // reaches past the warp's first row
          uint32_t af[kJS / 16][VPL][4];
          const float* srow = S + (16 * mt + g) * sp + (js - jb) + 2 * t;
          const float* ecol = e + js + 2 * t;
          if (js + kJS - 1 <= last_causal) {
#pragma unroll
            for (int kk = 0; kk < kJS / 16; ++kk)
              decayed_a<VPL, false>(af[kk], srow + kk * 16, sp,
                                    ecol + kk * 16, e0, e1, row0,
                                    js + kk * 16 + 2 * t);
          } else {
#pragma unroll
            for (int kk = 0; kk < kJS / 16; ++kk)
              decayed_a<VPL, true>(af[kk], srow + kk * 16, sp,
                                   ecol + kk * 16, e0, e1, row0,
                                   js + kk * 16 + 2 * t);
          }
#pragma unroll
          for (int np = 0; np < kPT / 16; ++np) {
            if (pc * kPT + np * 16 >= P) break;
#pragma unroll
            for (int kk = 0; kk < kJS / 16; ++kk) {
              uint32_t bf[2][PL][2];  // n8 tiles 2 np and 2 np + 1
              if constexpr (sizeof(T) == 2) {
                const int mi = lane >> 3;
                const T* p = xs +
                             (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kXPitch +
                             np * 16 + (mi >> 1) * 8;
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                    "{%0,%1,%2,%3}, [%4];\n"
                    : "=r"(bf[0][0][0]), "=r"(bf[0][0][1]),
                      "=r"(bf[1][0][0]), "=r"(bf[1][0][1])
                    : "r"(smem_addr(p)));
              } else {
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  const T* p = xs + (kk * 16 + 2 * t) * kXPitch + np * 16 +
                               nt * 8 + g;
                  uint32_t tmp[PL];
                  O::pair(make_float2(O::f32(p[0]), O::f32(p[kXPitch])),
                          tmp);
#pragma unroll
                  for (int k = 0; k < PL; ++k) bf[nt][k][0] = tmp[k];
                  O::pair(make_float2(O::f32(p[8 * kXPitch]),
                                      O::f32(p[9 * kXPitch])), tmp);
#pragma unroll
                  for (int k = 0; k < PL; ++k) bf[nt][k][1] = tmp[k];
                }
              }
              mma_planes<VPL, PL>(acc[2 * np], af[kk], bf[0]);
              mma_planes<VPL, PL>(acc[2 * np + 1], af[kk], bf[1]);
            }
          }
        }
        if (!live) continue;
        // y for (head h, P tile pc) is complete
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int p = pc * kPT + n8 * 8 + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? row1 : row0;
            if (row >= l || p >= P) continue;
            float* dst = yg + ((size_t)row * H + h) * P + p;
            float v0 = acc[n8][2 * r], v1 = acc[n8][2 * r + 1];
            if constexpr (ALIGNED) {  // P even: the pair is in range
              if (jb > 0) {
                const float2 old = *reinterpret_cast<float2*>(dst);
                v0 += old.x;
                v1 += old.y;
              }
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = jb > 0 ? dst[0] + v0 : v0;
              if (p + 1 < P) dst[1] = jb > 0 ? dst[1] + v1 : v1;
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass rewrites S and the ring
  }
}

int smem_bytes(int elem, int lpad, int sj, int group) {
  return ring_bytes(elem) + kBM * (sj + 8) * 4 + group * lpad * 4;
}

template <typename T, bool ALIGNED>
cudaError_t launch(const Params& prm, int smem, int device,
                   cudaStream_t st) {
  static int configured[kMaxDevices] = {};  // bytes set per device
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[device] < smem) {  // dynamic shared memory above 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_kernel<T, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[device] = smem;
  }
  const int64_t blocks = (int64_t)prm.C * prm.n_it * prm.groups;
  ssd_intra_kernel<T, ALIGNED><<<(unsigned)blocks, kThreads, smem, st>>>(prm);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// y = ssd_intra_chunk(a, b, c, x) in f32 on the wrapper's plan: `group`
// heads per block, the 16-byte path when `aligned`, and `smem` the dynamic
// shared memory the plan computed (checked against this file's layout).
// in_bf16: b, c and x are bf16 (else f32). Launches on `stream` of device
// `device` and returns the cudaError_t of the launch (0 = ok).
int ssd_intra_launch(const void* a, const void* b, const void* c,
                     const void* x, float* y, int C, int H, int l, int N,
                     int P, int in_bf16, int group, int aligned, int smem,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C <= 0 || H <= 0 || l <= 0 || P <= 0) return 0;
  if (group <= 0 || N < 0) return cudaErrorInvalidValue;
  Params prm{static_cast<const float*>(a), b, c, x, y, C, H, l, N, P};
  prm.group = group;
  prm.groups = (H + group - 1) / group;
  prm.n_it = (l + kBM - 1) / kBM;
  prm.lpad = prm.n_it * kBM;
  prm.sj = prm.lpad < kMaxSJ ? prm.lpad : kMaxSJ;
  const int elem = in_bf16 ? 2 : 4;
  if (smem != smem_bytes(elem, prm.lpad, prm.sj, group))
    return cudaErrorInvalidValue;
  if ((int64_t)C * prm.n_it * prm.groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (aligned && !(aligned16(b) && aligned16(c) && aligned16(x) &&
                   (N * elem) % 16 == 0 && (P * elem) % 16 == 0))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16)
    err = aligned ? launch<bf16, true>(prm, smem, device, st)
                  : launch<bf16, false>(prm, smem, device, st);
  else
    err = aligned ? launch<float, true>(prm, smem, device, st)
                  : launch<float, false>(prm, smem, device, st);
  return static_cast<int>(err);
}

const char* ssd_intra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
