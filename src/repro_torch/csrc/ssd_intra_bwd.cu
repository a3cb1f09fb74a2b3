// Backward of the Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains through its plain jnp
// SSD (src/repro/models/ssm.py:29, ssd_chunked's intra-chunk einsum), whose
// gradient JAX's autodiff makes. The forward is csrc/ssd_intra.cu. Per chunk
// c and head h, with cum = cumsum(a[c, h]), L[i, j] = exp(cum_i - cum_j) for
// i >= j (0 above the diagonal), S = C B^T (shared by the heads), M = S * L
// and y = M x, the backward of dy (f32) is:
//   dx     = M^T dy
//   dM     = dy x^T                         (lower triangle)
//   dS     = sum_h dM * L                   dC = dS B,  dB = dS^T C
//   G      = dM * M
//   dcum_i = sum_j G[i, j] - sum_k G[k, i]  da_t = sum_{i >= t} dcum_i
// x, b and c are f32 or bf16; every result is f32.
//
// What bounds it. At the mamba2-780m training shape (C 4, H 48, l 256, N
// 128, P 64, f32) the least work is 0.86 G multiply-adds over the causal
// pairs (dM and dx per head, S, dC and dB once a chunk); with f32 operands
// as three bf16 planes (six plane products a multiply-add) the bf16 tensor
// cores take 0.0104 ms, under the 0.0120 ms that the 40.2 MB of operands
// and results take over HBM. So the kernel is bound by bytes once the
// products run on tensor cores, the work is spread over the SMs and no
// (C, H, l, l) intermediate reaches HBM; the first version (f32 FMAs on the
// CUDA cores, a (C, H, l, l) dM * L buffer) was bound by the CUDA cores'
// 0.0256 ms. In practice the main launch is bound by latency: one block of
// eight warps an SM (its shared memory and registers), four row tiles of
// two heads a warpgroup on the longest column tile.
//
// Three launches on one stream:
// 1. ssd_bwd_scores_kernel: S^T = B_j C_i^T for every causal 64 x 64 tile
//    pair (i >= j) of a chunk, one warpgroup a pair on wgmma, written as
//    f32 tiles (0.66 MB at the training shape).
// 2. ssd_bwd_main_kernel: a cluster of kCluster blocks owns (chunk,
//    64-column tile j, group of kHeads heads), clusters numbered heaviest
//    column tile first; each block takes kSub heads, its two warpgroups a
//    head each at a time (named barriers, no block-wide sync between
//    heads). It walks the row tiles i >= j. Per row tile the block loads
//    the S^T tile (16-byte loads issued during the row tile before) and
//    extends each head's cum over the tile. Per (row tile, head) a
//    warpgroup converts x_j and dy_i, copied ahead by cp.async while the
//    step before ran, into bf16 planes in 8 x 8 core-matrix layout; runs
//    dM^T = x_j dy_i^T on wgmma (A from registers, B = dy from shared memory
//    through a descriptor); per element L, M, G's row and column sums and
//    dS^T += dM^T L in registers; and dx_j += M^T dy_i on wgmma, A the M^T
//    accumulator fragments split into planes, B the same dy planes read
//    transposed. dx_j's running sum over the row tiles goes through a
//    swizzled shared tile: the tile of the row tile before is copied in
//    by cp.async and the new sum written back with 16-byte stores (the
//    block alone writes it). G's column sums finish in the block; its row
//    sums over the tile's 64 columns go to a (C, H, tiles, l) buffer. At
//    the end of a row tile each block adds its warpgroups' dS^T (heads hb,
//    hb + 2 plus hb + 1, hb + 3), rank 0 adds the other ranks' block sums
//    in rank order through distributed shared memory and writes the
//    group's partial dS^T with 16-byte stores: one (C, ceil(H / 8), l, l)
//    buffer, 6.3 MB at the training shape.
// 3. ssd_bwd_finish_kernel: dC = dS B (row tiles of dS) and dB = dS^T C,
//    the groups' partials summed in group order as they are staged, the
//    next k tile's loads in flight during the products (mma.sync); and one
//    warp per (chunk, head) for da: G's row sums over the column tiles in
//    order, minus its column sums, then the reverse prefix sum.
// Planes. An f32 operand goes into the products as three exact bf16 planes
// (v = p0 + p1 + p2, each the rounded remainder of the ones before) and the
// six plane products of order <= 2^-16 are kept; a bf16 operand is one
// exact plane. dy, M and dS are f32 on every path; x, b and c are one plane
// on the bf16 path. The decay is ex2.approx of the difference of f32 prefix
// sums from the chunk's start (the plain version's cum, scanned 32
// positions at a time), with positions past l and above the diagonal at
// -inf.
// Deterministic: no atomics; every sum runs in an order fixed by the shapes
// (heads within a warpgroup, the warpgroups, the cluster's ranks, the
// groups, row tiles for dx, column tiles for G's row sums), so every call
// repeats bit for bit.
// Any l <= 1024, N and P: rows, columns, N and P past the edge are zero in
// the staged tiles, P runs in 64-wide tiles (one tile keeps the cp.async
// pipeline; more are staged in turn), and operands off the 16-byte
// conditions load element by element.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kT = 64;            // rows and columns of an l x l tile
constexpr int kHeads = 8;         // heads per cluster (per partial dS)
constexpr int kSub = 4;           // heads per block
constexpr int kCluster = kHeads / kSub;
constexpr int kMainThreads = 256;  // two warpgroups
constexpr int kFinThreads = 256;
constexpr int kPlane = kT * kT;   // bf16 elements of a staged plane
constexpr int kSPitch = kT + 4;   // f32 elements per row of the S exchange
constexpr int kMaxLen = 1024;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// A staged 64 x 64 bf16 plane is 8 x 8 core matrices of 8 rows x 8
// columns, each 128 contiguous bytes (row r of a core matrix at 16 r
// bytes), row-major over the core matrices: the layout wgmma reads
// without swizzle, and one ldmatrix row is 16 contiguous bytes.
// elements per row of a raw 64 x 64 tile: rows 16 bytes apart mod 128,
// so that a quarter warp's 16-byte reads of eight rows are conflict-free
__host__ __device__ constexpr int raw_pitch(int elem) {
  return elem == 4 ? kT + 4 : kT + 8;
}

__host__ __device__ constexpr int cm(int r, int c) {
  return ((r >> 3) * 8 + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}
// descriptor strides (bytes) between core matrices of such a plane:
// along its columns 128, along its rows 1024
constexpr int kColStride = 128, kRowStride = 1024;

// ---- PTX helpers ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor without swizzle: start address, and the
// byte strides between core matrices along K (lbo) and along M or N (sbo)
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 64 f32, the warpgroup's accumulator) += A B: A (64 x 16 bf16) in
// registers, B (16 x 64 bf16) in shared memory; TB = 1 reads B with n
// along the core matrices' rows (MN-major)
template <int TB>
__device__ __forceinline__ void wgmma64(float* d, const uint32_t* a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      "{%32,%33,%34,%35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's shared-memory stores visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a pure register operation: not volatile
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x by ex2.approx.ftz (2^-inf = 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// barrier of one warpgroup (128 threads); ids 1 and 2 (0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// the cluster barrier in halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ---- end of PTX helpers ----

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// an f32 pair (v0 low, v1 high) as NP bf16 planes, each the remainder of
// the ones before rounded to nearest even: NP = 1 is exact for a bf16
// source, NP = 3 for any normal f32 (v = p0 + p1 + p2)
template <int NP>
__device__ __forceinline__ void split(float v0, float v1, uint32_t* p) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    p[k] = bf16x2_bits(h);
    if (k + 1 < NP) {
      const float2 f = __bfloat1622float2(h);
      v0 -= f.x;
      v1 -= f.y;
    }
  }
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Planes {
  static constexpr int kN = 3;
};
template <>
struct Planes<__nv_bfloat16> {
  static constexpr int kN = 1;
};

// the plane pairs (pa, pb) a product keeps: pa + pb <= max(PA, PB) - 1,
// every pair when a side has one plane, the six of order <= 2^-16 for
// three planes each
template <int PA, int PB>
__device__ __forceinline__ constexpr bool keep(int pa, int pb) {
  return pa + pb <= (PA > PB ? PA : PB) - 1;
}

// acc[n] += A B_n for four n8 tiles over the kept plane pairs, small
// terms first, the plane pair the outer loop (mma.sync)
template <int PA, int PB>
__device__ __forceinline__ void mma_tiles(float (*acc)[4],
                                          const uint32_t (*a)[4],
                                          const uint32_t (*b)[4][2]) {
#pragma unroll
  for (int pa = PA - 1; pa >= 0; --pa)
#pragma unroll
    for (int pb = PB - 1; pb >= 0; --pb)
      if (keep<PA, PB>(pa, pb))
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(acc[n], a[pa], b[pb][n]);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// elements (row, cc) and (row, cc + 1) of a row-major source with row
// stride ld, 0 at rows >= rmax and columns >= cmax; `pairs`: the two load
// as one 4- or 8-byte word (source, ld and cc aligned to it)
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* __restrict__ src,
                                            int64_t ld, int row, int rmax,
                                            int cc, int cmax, bool pairs) {
  float2 v = make_float2(0.f, 0.f);
  if (row < rmax && cc < cmax) {
    const T* p = src + row * ld + cc;
    if (pairs && cc + 1 < cmax) {
      if constexpr (sizeof(T) == 4) {
        v = *reinterpret_cast<const float2*>(p);
      } else {
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      }
    } else {
      v.x = f32(p[0]);
      if (cc + 1 < cmax) v.y = f32(p[1]);
    }
  }
  return v;
}

// the (row, column) of element pair q of a staged plane: 32 pairs a core
// matrix, four a row of it, so that a warp's stores fill one core matrix
__device__ __forceinline__ int pair_row(int q) {
  return (q >> 8) * 8 + ((q & 31) >> 2);
}
__device__ __forceinline__ int pair_col(int q) {
  return ((q >> 5) & 7) * 8 + (q & 3) * 2;
}

// NP planes of rows [r0, r0 + 64) x columns [c0, c0 + 64) of a row-major
// source (load_pair's zeros past the edges) into dst + plane * kPlane, by
// NTHR threads: every load first, then the splits
template <int NP, int NTHR, typename T>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const T* __restrict__ src, int64_t ld,
                                      int r0, int rmax, int c0, int cmax,
                                      bool pairs, int tid) {
  constexpr int kIt = kT * (kT / 2) / NTHR;
  float2 v[kIt];
#pragma unroll
  for (int u = 0; u < kIt; ++u) {
    const int q = tid + u * NTHR;
    v[u] = load_pair(src, ld, r0 + pair_row(q), rmax, c0 + pair_col(q), cmax,
                     pairs);
  }
#pragma unroll
  for (int u = 0; u < kIt; ++u) {
    const int q = tid + u * NTHR;
    uint32_t pl[NP];
    split<NP>(v[u].x, v[u].y, pl);
#pragma unroll
    for (int k = 0; k < NP; ++k)
      *reinterpret_cast<uint32_t*>(dst + k * kPlane +
                                   cm(pair_row(q), pair_col(q))) = pl[k];
  }
}

// a 64 x 64 tile of a row-major source into raw[row * raw_pitch + col] as
// it is, 0 at rows >= rmax and columns >= cmax, by one warpgroup: 16-byte
// cp.async copies when `async` (source, ld and cmax whole 16-byte
// vectors), else element loads
template <typename T>
__device__ __forceinline__ void fetch_tile(T* raw, const T* __restrict__ src,
                                           int64_t ld, int r0, int rmax,
                                           int c0, int cmax, bool async,
                                           int wtid) {
  constexpr int kP = raw_pitch(sizeof(T));
  if (async) {
    constexpr int kV = 16 / (int)sizeof(T), kC = kT / kV;
    for (int q = wtid; q < kT * kC; q += 128) {
      const int r = q / kC, col = (q % kC) * kV;
      const int row = r0 + r, cc = c0 + col;
      const bool in = row < rmax && cc < cmax;
      cp_async16(raw + r * kP + col, in ? src + row * ld + cc : src,
                 in ? 16 : 0);
    }
  } else {
    for (int q = wtid; q < kT * kT; q += 128) {
      const int r = q / kT, col = q % kT;
      const int row = r0 + r, cc = c0 + col;
      raw[r * kP + col] =
          row < rmax && cc < cmax ? src[row * ld + cc] : zero<T>();
    }
  }
}

// NP planes of a raw 64 x 64 tile, by one warpgroup, eight elements (a
// 16-byte row of a core matrix in each plane) a thread at a time: a
// quarter warp takes the eight rows of one core matrix
template <int NP, typename T>
__device__ __forceinline__ void convert_tile(__nv_bfloat16* dst,
                                             const T* raw, int wtid) {
  constexpr int kP = raw_pitch(sizeof(T));
#pragma unroll
  for (int q = wtid; q < kT * (kT / 8); q += 128) {
    const int cmi = q >> 3, rr = q & 7;
    const T* src = raw + ((cmi >> 3) * 8 + rr) * kP + (cmi & 7) * 8;
    float v[8];
    if constexpr (sizeof(T) == 4) {
      const float4 u0 = *reinterpret_cast<const float4*>(src);
      const float4 u1 = *reinterpret_cast<const float4*>(src + 4);
      v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w;
      v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
    } else {
      // a bf16 is the high half of its f32
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
    uint32_t pl[NP][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t p3[NP];
      split<NP>(v[2 * k], v[2 * k + 1], p3);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) pl[pp][k] = p3[pp];
    }
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
      *reinterpret_cast<uint4*>(dst + pp * kPlane + cmi * 64 + rr * 8) =
          make_uint4(pl[pp][0], pl[pp][1], pl[pp][2], pl[pp][3]);
  }
}

// A fragments (m16 x k16, NP planes) from a staged [m][k] plane: rows
// m0.., columns k0..
template <int NP>
__device__ __forceinline__ void frag_a(uint32_t (*a)[4],
                                       const __nv_bfloat16* st, int m0,
                                       int k0, int lane) {
  const int mi = lane >> 3;
  const __nv_bfloat16* p =
      st + cm(m0 + (mi & 1) * 8 + (lane & 7), k0 + (mi >> 1) * 8);
#pragma unroll
  for (int k = 0; k < NP; ++k) ldsm_x4(a[k], p + k * kPlane);
}

// A fragments (m16 x k16) from a staged [k][m] plane (the transpose):
// rows m0.. of A are its columns m0.., A's k0.. its rows k0..
template <int NP>
__device__ __forceinline__ void frag_a_t(uint32_t (*a)[4],
                                         const __nv_bfloat16* st, int m0,
                                         int k0, int lane) {
  const int mi = lane >> 3;
  const __nv_bfloat16* p =
      st + cm(k0 + (mi >> 1) * 8 + (lane & 7), m0 + (mi & 1) * 8);
#pragma unroll
  for (int k = 0; k < NP; ++k) ldsm_x4_t(a[k], p + k * kPlane);
}

// B fragments of four n8 tiles (n0 + 8 n..) x k16 from a staged [k][n]
// plane: b[plane][tile][2]
template <int NP>
__device__ __forceinline__ void frag_b4_t(uint32_t (*b)[4][2],
                                          const __nv_bfloat16* st, int n0,
                                          int k0, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* p =
        st + cm(k0 + (mi & 1) * 8 + (lane & 7), n0 + 16 * h + (mi >> 1) * 8);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      uint32_t r[4];
      ldsm_x4_t(r, p + k * kPlane);
      b[k][2 * h][0] = r[0];
      b[k][2 * h][1] = r[1];
      b[k][2 * h + 1][0] = r[2];
      b[k][2 * h + 1][1] = r[3];
    }
  }
}

struct Params {
  const float* a;
  const void* b;
  const void* c;
  const void* x;
  const float* dy;
  float* part;  // (C, groups, l, l): the groups' dS^T, causal tiles only
  float* rowp;  // (C, H, tiles, l): G's row sums per column tile
  float* da;    // (C, H, l): G's column sums, then da
  float* db;
  float* dc;
  float* dx;
  float* s;     // (C, tiles (tiles + 1) / 2, 64, 64): S^T of the causal tiles
  int C, H, l, N, P;
  int tiles;   // ceil(l / 64)
  int groups;  // ceil(H / kHeads)
  int pairs_bc;   // b and c load two elements a word
  int async_x;    // x and dy tiles by 16-byte cp.async
  int async_dy;
  int async_dx;   // dx tiles by 16-byte copies and stores
  int quad_part;  // the partials load and store four elements a word
};

// shared memory of the main kernel: each warpgroup's planes (np of x,
// three of dy; at the end of a row tile the area holds the dS exchange),
// each warpgroup's raw x and dy tiles and its dx tile, S^T, cum of the
// block's heads over the column tile and the row tile, the row sums'
// exchange and the column sums; the same for every l
__host__ __device__ constexpr int stage_bytes(int np) {
  return 2 * (np + 3) * kPlane * 2;
}
__host__ __device__ constexpr int raw_bytes(int elem) {
  return kT * (raw_pitch(elem) * elem + raw_pitch(4) * 4);
}
constexpr int kDxBytes = kT * kT * 4;
__host__ __device__ constexpr int main_smem(int np, int elem) {
  return stage_bytes(np) + 2 * raw_bytes(elem) + 2 * kDxBytes +
         kT * kSPitch * 4 + kSub * 2 * kT * 4 + 2 * 4 * kT * 4 +
         kSub * kT * 4;
}
// the finish kernel's: dS^T's three planes and np planes of b or c
__host__ __device__ constexpr int finish_smem(int np) {
  return (3 + np) * kPlane * 2;
}
// a block may use 227 KB: the kernels' limit, for every shape
static_assert(main_smem(3, 4) <= 232448 && main_smem(1, 2) <= 232448 &&
                  finish_smem(3) <= 232448,
              "shared memory past a block's 227 KB");

// element (row, col) of a 64 x 64 f32 dx tile: 16-byte chunks of a row
// XOR-swizzled by the row, so that the MMA fragments' rows and the 16-byte
// chunks of a row both fall in distinct banks
__device__ __forceinline__ int dxo(int row, int col) {
  return row * kT + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// S^T[j][i] = sum_n B[j][n] C[i][n] for one causal tile pair (it >= jt) of
// a chunk, blocks numbered (chunk, it (it + 1) / 2 + jt): two warpgroups
// on wgmma, warpgroup w over the 64-column slices w, w + 2, .. of N, their
// sums added in that order; written as 64 x 64 f32 rows
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_scores_kernel(const Params prm) {
  constexpr int PI = Planes<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, wr = warp & 3;
  const int wtid = tid & 127;
  __nv_bfloat16* bs =
      reinterpret_cast<__nv_bfloat16*>(smem) + wg * 2 * PI * kPlane;  // [j][n]
  __nv_bfloat16* cs = bs + PI * kPlane;                              // [i][n]
  const int l = prm.l, N = prm.N;
  const int pairs = prm.tiles * (prm.tiles + 1) / 2;
  const int ci = (int)blockIdx.x / pairs;
  int jt = (int)blockIdx.x % pairs, it = 0;
  while (jt > it) jt -= ++it;
  const T* bg = static_cast<const T*>(prm.b) + (int64_t)ci * l * N;
  const T* cg_ = static_cast<const T*>(prm.c) + (int64_t)ci * l * N;
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  for (int n0 = wg * kT; n0 < N; n0 += 2 * kT) {
    wg_sync(wg);  // the planes are free
    stage<PI, 128>(bs, bg, N, jt * kT, l, n0, N, prm.pairs_bc, wtid);
    stage<PI, 128>(cs, cg_, N, it * kT, l, n0, N, prm.pairs_bc, wtid);
    fence_async_smem();
    wg_sync(wg);
    uint32_t af[kT / 16][PI][4];
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      frag_a<PI>(af[kk], bs, 16 * wr, 16 * kk, lane);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int pa = PI - 1; pa >= 0; --pa)
#pragma unroll
        for (int pb = PI - 1; pb >= 0; --pb)
          if (keep<PI, PI>(pa, pb))
            wgmma64<0>(acc, af[kk][pa],
                       make_desc(cs + pb * kPlane + cm(0, 16 * kk),
                                 kColStride, kRowStride));
    wgmma_commit_wait();
  }
  // the second warpgroup's sum through shared memory, then rows out
  __syncthreads();  // every plane is read
  float* ex = reinterpret_cast<float*>(smem);
  if (wg == 1) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(ex + (16 * wr + g + 8 * r) * kSPitch +
                                   8 * n8 + 2 * t) =
            make_float2(acc[4 * n8 + 2 * r], acc[4 * n8 + 2 * r + 1]);
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* e = ex + (16 * wr + g + 8 * r) * kSPitch + 8 * n8 + 2 * t;
        e[0] = acc[4 * n8 + 2 * r] + e[0];
        e[1] = acc[4 * n8 + 2 * r + 1] + e[1];
      }
  }
  __syncthreads();
  float* out = prm.s + ((int64_t)ci * pairs + blockIdx.x % pairs) * kT * kT;
  for (int e = tid; e < kT * (kT / 4); e += 256)
    *reinterpret_cast<float4*>(out + e * 4) = *reinterpret_cast<const float4*>(
        ex + (e >> 4) * kSPitch + (e & 15) * 4);
}

template <typename T>
__global__ void __launch_bounds__(kMainThreads, 1)
ssd_bwd_main_kernel(const Params prm) {
  constexpr int PI = Planes<T>::kN;  // planes of x, b, c
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* raws = smem + stage_bytes(PI);
  float* rdxs = reinterpret_cast<float*>(raws + 2 * raw_bytes(sizeof(T)));
  float* sx = rdxs + 2 * kT * kT;
  float* cums = sx + kT * kSPitch;      // [head of the block][j tile, i tile]
  float* rowx = cums + kSub * 2 * kT;  // [wg][warp][64]
  float* colgs = rowx + 2 * 4 * kT;    // [head of the block][64]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wr = warp & 3, wtid = tid & 127;
  const int l = prm.l, H = prm.H, P = prm.P;

  // clusters numbered heaviest column tile first; rank r of the cluster
  // takes heads kSub r.. of its group of kHeads
  const int per_tile = prm.C * prm.groups;
  const int cid = (int)(blockIdx.x / kCluster);
  const int jt = cid / per_tile, rem = cid % per_tile;
  const int ci = rem / prm.groups, grp = rem % prm.groups;
  const int hb = grp * kHeads + rank * kSub;
  const int nh = max(0, min(H, hb + kSub) - hb);  // heads of this block
  const int j0 = jt * kT;

  const int64_t row = (int64_t)H * P;  // stride of a position in x, dy, dx
  const T* xg = static_cast<const T*>(prm.x) + (int64_t)ci * l * row;
  const float* dyg = prm.dy + (int64_t)ci * l * row;
  float* dxg = prm.dx + (int64_t)ci * l * row;

  // this warpgroup's planes, raw tiles and dx tile
  __nv_bfloat16* xs = stg + wg * (PI + 3) * kPlane;
  __nv_bfloat16* dys = xs + PI * kPlane;
  T* rx = reinterpret_cast<T*>(raws + wg * raw_bytes(sizeof(T)));
  float* rdy = reinterpret_cast<float*>(rx + kT * raw_pitch(sizeof(T)));
  float* rdx = rdxs + wg * kT * kT;

  const int n_pt = (P + kT - 1) / kT;
  const bool pipe = n_pt == 1;  // the next step's tiles fly behind this one
  const int nq = (nh - wg + 1) / 2;  // heads hb + 2 q + wg
  // x of head q's column tile and dy of row tile it, P tile pt, into the
  // raw tiles: one cp.async group
  auto fetch = [&](int it, int q, int pt, bool with_x) {
    const int64_t hp = (int64_t)(hb + 2 * q + wg) * P;
    if (with_x)
      fetch_tile<T>(rx, xg + hp, row, j0, l, pt * kT, P, prm.async_x, wtid);
    fetch_tile<float>(rdy, dyg + hp, row, it * kT, l, pt * kT, P,
                      prm.async_dy, wtid);
    cp_async_commit();
  };
  // dx of head q's column tile, P tile pt, as the row tiles before it left
  // it (none when it is the first), into the dx tile: one cp.async group
  auto fetch_dx = [&](int it, int q, int pt) {
    if (it > jt) {
      const float* src = dxg + (int64_t)(hb + 2 * q + wg) * P + pt * kT;
      for (int e = wtid; e < kT * (kT / 4); e += 128) {
        const int r = e >> 4, c = (e & 15) * 4, j = j0 + r, p = pt * kT + c;
        float* dst = rdx + dxo(r, c);
        if (prm.async_dx) {
          const bool in = j < l && p < P;
          cp_async16(dst, in ? src + j * row + c : src, in ? 16 : 0);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dst[k] = j < l && p + k < P ? src[j * row + c + k] : 0.f;
        }
      }
    }
    cp_async_commit();
  };
  // the fetched x and dy as planes, once this warpgroup is done with the
  // planes before; one_left: the last cp.async group (a dx tile) may fly on
  auto land = [&](bool with_x, bool one_left) {
    if (one_left)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    wg_sync(wg);
    if (with_x) convert_tile<PI>(xs, rx, wtid);
    convert_tile<3>(dys, rdy, wtid);
    fence_async_smem();
    wg_sync(wg);
  };
  // S^T tile (j tile, row tile it) of the first launch, four 16-byte
  // loads a thread, issued a row tile ahead
  const float* sg = prm.s + (int64_t)ci * (prm.tiles * (prm.tiles + 1) / 2) *
                                kT * kT;
  float4 snext[4];
  auto load_s = [&](int it) {
    const float4* src = reinterpret_cast<const float4*>(
        sg + (int64_t)(it * (it + 1) / 2 + jt) * kT * kT);
#pragma unroll
    for (int u = 0; u < 4; ++u) snext[u] = src[tid + u * kMainThreads];
  };
  load_s(jt);
  if (nq > 0 && pipe) {
    fetch(jt, 0, 0, true);  // in flight during the first row tile's set-up
    fetch_dx(jt, 0, 0);
  }
  for (int q = tid; q < kSub * kT; q += kMainThreads) colgs[q] = 0.f;
  float carry = 0.f;  // warp w < nh: cum of head hb + w up to the i tile

  // this warp's rows of the tile (local j): jr and jr + 8
  const int jr = 16 * wr + g;

  for (int it = jt; it < prm.tiles; ++it) {
    const int i0 = it * kT;
    // the other ranks are done reading this block's dS exchange
    if (it > jt) cluster_wait();
    __syncthreads();  // S^T's and the row tile's cum are free
    if (warp < nh) {
      // cum of head hb + warp from the chunk's start, 32 positions at a
      // time with the running carry (0 past l): the column tile's on the
      // first row tile, then each row tile's
      const float* ab = prm.a + ((int64_t)ci * H + hb + warp) * l;
      float* cw = cums + warp * 2 * kT;
      for (int base = it == jt ? 0 : i0; base < i0 + kT; base += 32) {
        float v = base + lane < l ? ab[base + lane] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float w = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += w;
        }
        if (base >= i0) {
          cw[kT + base - i0 + lane] = carry + v;
          if (it == jt) cw[base - i0 + lane] = carry + v;
        }
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    // S^T of the tile, loaded during the previous row tile's exchange
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + u * kMainThreads;
      *reinterpret_cast<float4*>(sx + (e >> 4) * kSPitch + (e & 15) * 4) =
          snext[u];
    }
    __syncthreads();  // S^T and cum complete

    // ---- the heads, two at a time: warpgroup wg takes hb + 2 q + wg ----
    float dsacc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) dsacc[k] = 0.f;
    for (int q = 0; q < nq; ++q) {
      const int hl = 2 * q + wg, h = hb + hl;
      float* dxh = dxg + (int64_t)h * P;
      const bool more = q + 1 < nq || it + 1 < prm.tiles;
      const int nit = q + 1 < nq ? it : it + 1, nqq = q + 1 < nq ? q + 1 : 0;

      // dM^T = x_j dy_i^T over the P tiles on the warpgroup's tensor cores
      float dm[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) dm[k] = 0.f;
      for (int pt = 0; pt < n_pt; ++pt) {
        if (pipe) {
          land(true, true);  // this step's dx tile may still fly
          if (more) fetch(nit, nqq, 0, true);
          else cp_async_commit();  // keep one group behind the dx tile
        } else {
          fetch(it, q, pt, true);
          land(true, false);
        }
        uint32_t af[kT / 16][PI][4];
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk)
          frag_a<PI>(af[kk], xs, 16 * wr, 16 * kk, lane);
        wgmma_fence();
        // straight-line between the fence and the commit (no branch on P:
        // the planes are zero past it), so that the products pipeline
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
          for (int pa = PI - 1; pa >= 0; --pa)
#pragma unroll
            for (int pb = 2; pb >= 0; --pb)
              if (keep<PI, 3>(pa, pb))
                wgmma64<0>(dm, af[kk][pa],
                           make_desc(dys + pb * kPlane + cm(0, 16 * kk),
                                     kColStride, kRowStride));
        wgmma_commit_wait();
      }

      // per element: L, M = S L (into dm), G's sums, dS^T += dM^T L
      const float* cum = cums + hl * 2 * kT;
      const float cja = cum[jr], cjb = cum[jr + 8];
      float csa = 0.f, csb = 0.f;  // G's sums over i for rows ja, jb
      float rs[8][2];              // G's sums over the rows, per column
      const int ja = j0 + jr, jb = ja + 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int il = 8 * k + 2 * t, i = i0 + il;
        const float2 ci2 = *reinterpret_cast<const float2*>(cum + kT + il);
        const float2 sa =
            *reinterpret_cast<const float2*>(sx + jr * kSPitch + il);
        const float2 sb =
            *reinterpret_cast<const float2*>(sx + (jr + 8) * kSPitch + il);
        const float sv[4] = {sa.x, sa.y, sb.x, sb.y};
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = i + (e & 1), jj = e < 2 ? ja : jb;
          const float d = (e & 1 ? ci2.y : ci2.x) - (e < 2 ? cja : cjb);
          const float lv = exp2_ftz(
              ii < l && jj <= ii ? d * kLog2e : -__int_as_float(0x7f800000));
          const float m = sv[e] * lv;
          gv[e] = dm[4 * k + e] * m;
          dsacc[4 * k + e] = fmaf(dm[4 * k + e], lv, dsacc[4 * k + e]);
          dm[4 * k + e] = m;
        }
        csa += gv[0] + gv[1];
        csb += gv[2] + gv[3];
        rs[k][0] = gv[0] + gv[2];
        rs[k][1] = gv[1] + gv[3];
      }
      // column sums: over the quad (t); row sums: over g
      csa += __shfl_xor_sync(0xffffffffu, csa, 1);
      csb += __shfl_xor_sync(0xffffffffu, csb, 1);
      csa += __shfl_xor_sync(0xffffffffu, csa, 2);
      csb += __shfl_xor_sync(0xffffffffu, csb, 2);
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = rs[k][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          rs[k][e] = v;
        }
      if (t == 0) {
        colgs[hl * kT + jr] += csa;
        colgs[hl * kT + jr + 8] += csb;
      }
      float* rw = rowx + (wg * 4 + wr) * kT;
      if (g == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<float2*>(rw + 8 * k + 2 * t) =
              make_float2(rs[k][0], rs[k][1]);
      }

      // M^T as A fragments: the accumulator fragments of k16 step kk, each
      // split into three planes
      uint32_t am[kT / 16][3][4];
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // a0: rows g, k 2t; a1: rows g + 8; a2: k 2t + 8; a3: both
          const float* src = dm + 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
          uint32_t p3[3];
          split<3>(src[0], src[1], p3);
#pragma unroll
          for (int k = 0; k < 3; ++k) am[kk][k][f] = p3[k];
        }
      // dx_j (+)= M^T dy_i over the P tiles, the staged one first: the
      // accumulator starts from the dx tile, and the sum goes back through
      // it to 16-byte stores
      for (int pt = n_pt - 1; pt >= 0; --pt) {
        if (pipe) {
          cp_async_wait<1>();  // this step's dx tile (the next x, dy fly)
        } else {
          if (pt != n_pt - 1) {
            wg_sync(wg);  // the dx tile before is read
            fetch(it, q, pt, false);
          }
          fetch_dx(it, q, pt);
          if (pt != n_pt - 1) land(false, false);
          else cp_async_wait<0>();
        }
        wg_sync(wg);
        float acc[32];
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 v = make_float2(0.f, 0.f);
            if (it > jt)
              v = *reinterpret_cast<const float2*>(
                  rdx + dxo(jr + 8 * r, 8 * n8 + 2 * t));
            acc[4 * n8 + 2 * r] = v.x;
            acc[4 * n8 + 2 * r + 1] = v.y;
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
          for (int pa = 2; pa >= 0; --pa)
#pragma unroll
            for (int pb = 2; pb >= 0; --pb)
              if (keep<3, 3>(pa, pb))
                wgmma64<1>(acc, am[kk][pa],
                           make_desc(dys + pb * kPlane + cm(16 * kk, 0),
                                     kRowStride, kColStride));
        wgmma_commit_wait();
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(rdx + dxo(jr + 8 * r, 8 * n8 + 2 * t)) =
                make_float2(acc[4 * n8 + 2 * r], acc[4 * n8 + 2 * r + 1]);
        wg_sync(wg);
        float* dst0 = dxh + pt * kT;
        for (int e = wtid; e < kT * (kT / 4); e += 128) {
          const int r = e >> 4, c = (e & 15) * 4, j = j0 + r, p = pt * kT + c;
          const float4 v = *reinterpret_cast<const float4*>(rdx + dxo(r, c));
          if (j < l && p < P) {
            float* dst = dst0 + j * row + c;
            if (prm.async_dx) {
              *reinterpret_cast<float4*>(dst) = v;
            } else {
              dst[0] = v.x;
              if (p + 1 < P) dst[1] = v.y;
              if (p + 2 < P) dst[2] = v.z;
              if (p + 3 < P) dst[3] = v.w;
            }
          }
        }
      }

      // G's row sums of this head over the tile's columns: the four warps
      // in order
      wg_sync(wg);  // the row sums are in; the dx tile is read
      if (wtid < kT && i0 + wtid < l) {
        const float* rx4 = rowx + wg * 4 * kT + wtid;
        const float v = ((rx4[0] + rx4[kT]) + rx4[2 * kT]) + rx4[3 * kT];
        prm.rowp[(((int64_t)ci * H + h) * prm.tiles + jt) * l + i0 + wtid] =
            v;
      }
      if (pipe) {
        if (more) fetch_dx(nit, nqq, 0);
        else cp_async_commit();
      }
    }

    // ---- the group's dS tile: in each block the first warpgroup's sum
    // plus the second's, exchanged through the staging area; then rank 0
    // adds the other ranks' block sums in rank order through distributed
    // shared memory and writes dS^T[j][i] in 16-byte stores ----
    __syncthreads();  // every head done; the staging area is free
    if (it + 1 < prm.tiles) load_s(it + 1);
    float* ex = reinterpret_cast<float*>(stg);
    if (wg == 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* d = ex + jr * kSPitch + 8 * k + 2 * t;
        *reinterpret_cast<float2*>(d) =
            make_float2(dsacc[4 * k], dsacc[4 * k + 1]);
        *reinterpret_cast<float2*>(d + 8 * kSPitch) =
            make_float2(dsacc[4 * k + 2], dsacc[4 * k + 3]);
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = jr + (e < 2 ? 0 : 8), il = 8 * k + 2 * t + (e & 1);
          dsacc[4 * k + e] += ex[jl * kSPitch + il];
          if (rank != 0) ex[jl * kSPitch + il] = dsacc[4 * k + e];
        }
    }
    cluster_arrive();
    cluster_wait();  // every rank's block sum is in its staging area
    if (rank == 0 && wg == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = jr + (e < 2 ? 0 : 8), il = 8 * k + 2 * t + (e & 1);
#pragma unroll
          for (int r = 1; r < kCluster; ++r)
            dsacc[4 * k + e] +=
                *cluster.map_shared_rank(ex + jl * kSPitch + il, r);
        }
    }
    cluster_arrive();  // done reading the other ranks (waited on above)
    if (rank == 0 && wg == 0) {
      // the sum into rank 0's own exchange (read by no other rank), then
      // rows of dS^T out
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = jr + (e < 2 ? 0 : 8), il = 8 * k + 2 * t + (e & 1);
          ex[jl * kSPitch + il] = dsacc[4 * k + e];
        }
      wg_sync(0);
      float* pg = prm.part + ((int64_t)ci * prm.groups + grp) * l * l;
      for (int e = wtid; e < kT * (kT / 4); e += 128) {
        const int jl = e >> 4, il = (e & 15) * 4, j = j0 + jl, i = i0 + il;
        const float4 v = *reinterpret_cast<const float4*>(ex + jl * kSPitch +
                                                          il);
        if (j < l && i < l) {
          float* dst = pg + (int64_t)j * l + i;
          if (prm.quad_part) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            dst[0] = v.x;
            if (i + 1 < l) dst[1] = v.y;
            if (i + 2 < l) dst[2] = v.z;
            if (i + 3 < l) dst[3] = v.w;
          }
        }
      }
    }
  }
  cluster_wait();  // no rank exits while another reads its shared memory

  // G's column sums of the block's heads over every row tile: da's
  // buffer holds them until the finish kernel
  __syncthreads();
  for (int q = tid; q < nh * kT; q += kMainThreads) {
    const int hl = q / kT, j = j0 + q % kT;
    if (j < l) prm.da[((int64_t)ci * H + hb + hl) * l + j] = colgs[q];
  }
}

// four neighbouring elements p[0..3] at columns j..j + 3, 0 at columns >=
// l; `quad`: one 16-byte load (p aligned, l a multiple of 4)
__device__ __forceinline__ float4 load4(const float* p, int j, int l,
                                        bool quad) {
  if (quad) return *reinterpret_cast<const float4*>(p);
  float4 v;
  v.x = j < l ? p[0] : 0.f;
  v.y = j + 1 < l ? p[1] : 0.f;
  v.z = j + 2 < l ? p[2] : 0.f;
  v.w = j + 3 < l ? p[3] : 0.f;
  return v;
}

// Blocks [0, n_bc): dC (role 0) and dB (role 1), a block making 64 rows x
// 64 columns of N, heaviest first; then one warp per (chunk, head) for da.
template <typename T>
__global__ void __launch_bounds__(kFinThreads)
ssd_bwd_finish_kernel(const Params prm) {
  constexpr int PI = Planes<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // dS^T [j][i]
  __nv_bfloat16* bs = as + 3 * kPlane;                         // b, c [k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int l = prm.l, N = prm.N, T_ = prm.tiles;
  const int n_nc = (N + kT - 1) / kT;
  const int per = 2 * prm.C * n_nc;
  const int n_bc = T_ * per;

  if ((int)blockIdx.x >= n_bc) {
    // da: G's row sums over the column tiles in order, minus its column
    // sums, then the sum from the end; every load first
    const int r = ((int)blockIdx.x - n_bc) * (kFinThreads / 32) + warp;
    if (r >= prm.C * prm.H) return;
    const float* rp = prm.rowp + (int64_t)r * T_ * l;
    float* dab = prm.da + (int64_t)r * l;
    const int nseg = (l + 31) / 32;
    float v[kMaxLen / 32];
#pragma unroll
    for (int sgm = 0; sgm < kMaxLen / 32; ++sgm) {
      v[sgm] = 0.f;
      const int i = 32 * sgm + lane;
      if (sgm < nseg && i < l) {
        float rsum = rp[i];
        for (int k = 1; k <= i / kT; ++k) rsum += rp[(int64_t)k * l + i];
        v[sgm] = rsum - dab[i];
      }
    }
    float carry = 0.f;
#pragma unroll
    for (int sgm = kMaxLen / 32 - 1; sgm >= 0; --sgm) {
      if (sgm >= nseg) continue;  // uniform over the warp
      float w = v[sgm];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, w, o);
        if (lane + o < 32) w += u;
      }
      w += carry;
      if (32 * sgm + lane < l) dab[32 * sgm + lane] = w;
      carry = __shfl_sync(0xffffffffu, w, 0);
    }
    return;
  }

  // k tiles u + 1 for both roles: dC at row tile u, dB at column tile
  // T - 1 - u
  const int u = T_ - 1 - (int)blockIdx.x / per;
  const int rem = (int)blockIdx.x % per;
  const int role = rem / (prm.C * n_nc);
  const int ci = rem % (prm.C * n_nc) / n_nc, nc = rem % n_nc;
  const int o = role == 0 ? u : T_ - 1 - u;
  const T* src = static_cast<const T*>(role == 0 ? prm.b : prm.c) +
                 (int64_t)ci * l * N;
  const float* pc = prm.part + (int64_t)ci * prm.groups * l * l;
  const int64_t ll = (int64_t)l * l;
  const int wr = warp & 3, wc = warp >> 2;  // rows 16 wr.., columns 32 wc..
  const bool quad = prm.quad_part;

  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
  const int kt_lo = role == 0 ? 0 : o, kt_hi = role == 0 ? o : T_ - 1;
  // k tile kt's loads, in registers: the dS^T tile (j tile, i tile) of the
  // first kPre groups' partials (thread q takes row q / 16 and four
  // neighbouring columns) and the tile of b or c
  constexpr int kQ = kT * kT / 4 / kFinThreads;     // float4 a thread
  constexpr int kIt = kT * (kT / 2) / kFinThreads;  // b or c pairs a thread
  const float* base[kQ];
  bool in[kQ];
  int iq[kQ];  // the first column (i) of each
  constexpr int kPre = 6;  // the groups of H = 48 (mamba2-780m) in one go
  float4 w[kPre][kQ];
  float2 bv[kIt];
  auto issue = [&](int kt) {
    const int ti = role == 0 ? o : kt, tj = role == 0 ? kt : o;
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      const int q = tid + e * kFinThreads;
      const int j = tj * kT + q / (kT / 4);
      iq[e] = ti * kT + (q % (kT / 4)) * 4;
      in[e] = j < l && iq[e] < l;
      base[e] = pc + (int64_t)j * l + iq[e];
    }
#pragma unroll
    for (int gg = 0; gg < kPre; ++gg)
#pragma unroll
      for (int e = 0; e < kQ; ++e)
        w[gg][e] = gg < prm.groups && in[e]
                       ? load4(base[e] + gg * ll, iq[e], l, quad)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int v = 0; v < kIt; ++v) {
      const int q = tid + v * kFinThreads;
      bv[v] = load_pair(src, N, kt * kT + pair_row(q), l,
                        nc * kT + pair_col(q), N, prm.pairs_bc);
    }
  };
  issue(kt_lo);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    // the groups' partials summed in order
    float4 sum[kQ];
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      sum[e] = w[0][e];
#pragma unroll
      for (int gg = 1; gg < kPre; ++gg)
        if (gg < prm.groups) {
          sum[e].x += w[gg][e].x;
          sum[e].y += w[gg][e].y;
          sum[e].z += w[gg][e].z;
          sum[e].w += w[gg][e].w;
        }
    }
    for (int g0 = kPre; g0 < prm.groups; g0 += 4) {
      float4 w2[4][kQ];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
#pragma unroll
        for (int e = 0; e < kQ; ++e)
          w2[gg][e] = g0 + gg < prm.groups && in[e]
                          ? load4(base[e] + (g0 + gg) * ll, iq[e], l, quad)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
#pragma unroll
        for (int e = 0; e < kQ; ++e)
          if (g0 + gg < prm.groups) {
            sum[e].x += w2[gg][e].x;
            sum[e].y += w2[gg][e].y;
            sum[e].z += w2[gg][e].z;
            sum[e].w += w2[gg][e].w;
          }
    }
    __syncthreads();  // the planes are free
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      const int q = tid + e * kFinThreads;
      const int r = q / (kT / 4), col = (q % (kT / 4)) * 4;
      uint32_t p0[3], p1[3];
      split<3>(sum[e].x, sum[e].y, p0);
      split<3>(sum[e].z, sum[e].w, p1);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint2*>(as + k * kPlane + cm(r, col)) =
            make_uint2(p0[k], p1[k]);
    }
#pragma unroll
    for (int v = 0; v < kIt; ++v) {
      const int q = tid + v * kFinThreads;
      uint32_t pl[PI];
      split<PI>(bv[v].x, bv[v].y, pl);
#pragma unroll
      for (int k = 0; k < PI; ++k)
        *reinterpret_cast<uint32_t*>(bs + k * kPlane +
                                     cm(pair_row(q), pair_col(q))) = pl[k];
    }
    __syncthreads();
    if (kt < kt_hi) issue(kt + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t af[3][4];
      if (role == 0)
        frag_a_t<3>(af, as, 16 * wr, 16 * kk, lane);  // dS rows i
      else
        frag_a<3>(af, as, 16 * wr, 16 * kk, lane);  // dS^T rows j
      if (nc * kT + 32 * wc < N) {
        uint32_t bf[PI][4][2];
        frag_b4_t<PI>(bf, bs, 32 * wc, 16 * kk, lane);
        mma_tiles<3, PI>(acc, af, bf);
      }
    }
  }
  float* out = (role == 0 ? prm.dc : prm.db) + (int64_t)ci * l * N;
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rw = o * kT + 16 * wr + g + 8 * r;
      const int col = nc * kT + 32 * wc + 8 * n8 + 2 * t;
      if (rw < l && col < N) {
        out[(int64_t)rw * N + col] = acc[n8][2 * r];
        if (col + 1 < N) out[(int64_t)rw * N + col + 1] = acc[n8][2 * r + 1];
      }
    }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
cudaError_t launch(Params prm, int device, cudaStream_t st) {
  constexpr int PI = Planes<T>::kN;
  static int configured[kMaxDevices] = {};  // main kernel bytes per device
  static bool fin_configured[kMaxDevices] = {};
  static bool sc_configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int smem = main_smem(PI, sizeof(T));
  const int fsmem = finish_smem(PI);
  cudaError_t err;
  if (configured[device] < smem) {  // dynamic shared memory above 48 KB
    err = cudaFuncSetAttribute(ssd_bwd_main_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    configured[device] = smem;
  }
  if (!fin_configured[device]) {
    err = cudaFuncSetAttribute(ssd_bwd_finish_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fsmem);
    if (err != cudaSuccess) return err;
    fin_configured[device] = true;
  }
  if (!sc_configured[device]) {
    err = cudaFuncSetAttribute(ssd_bwd_scores_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * PI * kPlane * 2);
    if (err != cudaSuccess) return err;
    sc_configured[device] = true;
  }
  ssd_bwd_scores_kernel<T>
      <<<(unsigned)(prm.C * (prm.tiles * (prm.tiles + 1) / 2)), 256,
         4 * PI * kPlane * 2, st>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      (int64_t)prm.C * prm.tiles * prm.groups * kCluster));
  cfg.blockDim = dim3(kMainThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_main_kernel<T>, prm);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_nc = (prm.N + kT - 1) / kT;
  const int64_t fin = (int64_t)prm.tiles * 2 * prm.C * n_nc +
                      ((int64_t)prm.C * prm.H + kFinThreads / 32 - 1) /
                          (kFinThreads / 32);
  ssd_bwd_finish_kernel<T><<<(unsigned)fin, kFinThreads, fsmem, st>>>(prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Heads per cluster of the main kernel: one partial dS^T each.
int ssd_intra_bwd_group_heads() { return kHeads; }

// The workspace of a call, in floats: S^T of the causal tiles (C, T (T +
// 1) / 2, 64, 64) with T = ceil(l / 64), the groups' partial dS^T (C,
// ceil(H / 8), l, l) and G's row sums (C, H, T, l).
int64_t ssd_intra_bwd_workspace_floats(int n_c, int n_h, int l) {
  const int64_t tiles = (l + kT - 1) / kT;
  return (int64_t)n_c * (tiles * (tiles + 1) / 2) * kT * kT +
         (int64_t)n_c * ((n_h + kHeads - 1) / kHeads) * l * l +
         (int64_t)n_c * n_h * tiles * l;
}

// Backward of the intra-chunk block (see the header). a (C, H, l) f32; b, c
// (C, l, N) and x (C, l, H, P) in bf16 when `bf16`, else f32; dy (C, l, H,
// P) f32; ws the workspace (ssd_intra_bwd_workspace_floats, 16-byte
// aligned). Outputs, all f32: da (C, H, l), db and dc (C, l, N), dx (C, l,
// H, P). Three launches on `stream`; returns the first cudaError_t (0 =
// ok).
int ssd_intra_bwd_launch(const void* a, const void* b, const void* c,
                         const void* x, const void* dy, void* ws, void* da,
                         void* db, void* dc, void* dx, int n_c, int n_h,
                         int l, int n, int p, int bf16, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l < 1 || l > kMaxLen || n_c < 1 || n_h < 1 || n < 1 || p < 1 ||
      !aligned(ws, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (l + kT - 1) / kT;
  float* sbuf = static_cast<float*>(ws);
  float* part = sbuf + (int64_t)n_c * (tiles * (tiles + 1) / 2) * kT * kT;
  float* rowp = part + (int64_t)n_c * ((n_h + kHeads - 1) / kHeads) * l * l;
  Params prm{static_cast<const float*>(a), b, c, x,
             static_cast<const float*>(dy), part, rowp,
             static_cast<float*>(da), static_cast<float*>(db),
             static_cast<float*>(dc), static_cast<float*>(dx), sbuf};
  prm.C = n_c;
  prm.H = n_h;
  prm.l = l;
  prm.N = n;
  prm.P = p;
  prm.tiles = (l + kT - 1) / kT;
  prm.groups = (n_h + kHeads - 1) / kHeads;
  if ((int64_t)n_c * prm.tiles * prm.groups * kCluster > 0x7fffffff ||
      (int64_t)n_c * n_h > 0x3fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = bf16 ? 2 : 4;
  prm.pairs_bc = aligned(b, 2 * elem) && aligned(c, 2 * elem) && n % 2 == 0;
  prm.async_x = aligned(x, 16) && (p * elem) % 16 == 0;
  prm.async_dy = aligned(dy, 16) && p % 4 == 0;
  prm.async_dx = aligned(dx, 16) && p % 4 == 0;
  prm.quad_part = aligned(part, 16) && l % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<__nv_bfloat16>(prm, device, st)
             : launch<float>(prm, device, st);
  return static_cast<int>(err);
}

const char* ssd_intra_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
