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
// equal T one-token steps. Here the launch plan (the route, the
// instruction, the tiles, the K schedule, the planes and every reduction
// order) is chosen from the two types, K and N alone; R and counts only
// decide how many blocks run, which row tiles a block issues and which rows
// it writes. A row's result therefore depends only on its own x row, w[g],
// K and the types: not on R, counts, the other rows, the row tile it lands
// in or the grid.
//
// Types. x and w are f32 or bf16 and y has x's type: (f32, f32), (f32,
// bf16) and (bf16, bf16). A bf16 w under f32 x computes what x @ w.float()
// computes (bf16 -> f32 is exact) without a widened copy of the weights. A
// bf16 y is the f32 result rounded once to nearest even.
//
// Empty rows. counts, when given, holds each group's number of filled rows
// (the MoE capacity slots fill in order, so the rest are zero rows). Rows
// at or past counts[g] are written as zeros without being computed, and a
// block wholly past it (a group with count 0 above all) reads nothing.
//
// What bounds it: at the serving paths' shapes, bytes. A decode step reads
// every expert's weights once for a few rows each, a few multiply-adds a
// weight element, far below the 295 operations a byte where the card turns
// compute-bound. Two routes, chosen by the types:
//
// 1. bf16 w (experts, heads): tensor cores, grouped_matmul_wgmma_kernel.
//    A block owns 128 output columns of one group (64 a consumer
//    warpgroup) and up to 48 rows (more rows take more blocks along y) and
//    walks all of K: no split-K, so each output's K order is fixed by K.
//    One producer warp keeps a ring of stages in flight with TMA and
//    mbarriers (3-d tensor maps for w and x, encoded on the host through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda); a stage is
//    64 rows of K for f32 x (6 stages) or 128 for bf16 x (4 stages): w's
//    two 64-column tiles as they lie, bf16 and 128-byte swizzled, never
//    widened, and x's filled rows only, in 8-row boxes of 128 bytes,
//    swizzled. The warpgroups compute y^T = w^T x^T, so that x's rows sit
//    on wgmma's N side in row tiles of 16 and a decode's 8 rows cost one
//    tile, not a 64-row A tile. Per stage they split the filled rows of x
//    into bf16 planes in the core-matrix layout a K-major B descriptor
//    reads (f32 x: three exact planes hi, mid, lo with x = hi + mid + lo for
//    normal f32; bf16 x: one), a quarter warp reading eight rows of one
//    swizzled chunk and writing 128 contiguous bytes; load w's fragments
//    with ldmatrix.trans into registers (the A operand: w read N-major, as it
//    lies); hand the stage back; and issue for each k16 step and each row
//    tile that holds a filled row one m64n(16 P)k16 over the tile's P planes
//    side by side, each plane's sums in its own accumulator columns. A
//    stage is prepared while the one before runs on the tensor cores.
//    Accuracy. Hopper's tensor cores truncate the addends of an
//    accumulation to the accumulator's exponent, so a long chain of MMAs
//    onto one running sum loses about an ulp of the sum a step. Here a step
//    of two stages starts its accumulators from zero; the step's plane sums
//    are added in one fixed order, smallest first ((lo + mid) + hi), and
//    folded into an f32 running sum with the rounding error carried (TwoSum
//    into an error term); y = run + err. The error stays near an ulp of the
//    step's partial sums, not of the whole sum, and sums of 16384 terms stay
//    far inside 1e-5 of max |y|.
// 2. f32 x and f32 w (routers, N <= 32; any other N the same way, in
//    column chunks): CUDA cores, grouped_matmul_warp_kernel. A cluster of CL
//    blocks (from K: one for every 512 rows of K, at most 8) owns one row
//    and a chunk of NC columns (8, 16 or 32, from N); thread t of the
//    cluster's T = 128 CL takes k = t, t + T, ... in ascending order, one
//    fused multiply-add chain per column, reading w as whole 16-byte rows
//    w[k, c0 : c0 + NC] with several rows in flight. A fixed xor butterfly
//    (16, 8, 4, 2, 1) combines each warp's lanes, the warps are added in
//    order, and rank 0 adds the ranks' sums in order through distributed
//    shared memory. A router's weights are read by R x CL blocks at once
//    instead of one block walking K.
//
// Deterministic: no atomics, and every order above is fixed by the types,
// K and N, so every call repeats bit for bit and a row gives the same bits
// at any R, beside any other rows, in any row tile.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---- the tensor-core route ----
constexpr int kWGs = 2;          // consumer warpgroups a block
constexpr int kWgCols = 64;      // output columns a warpgroup (wgmma's M)
constexpr int kCols = kWgCols * kWGs;  // output columns a block
constexpr int kConsumers = 128 * kWGs;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kRows = 48;        // rows a block, at most
constexpr int kRowTile = 16;     // rows a row tile
constexpr int kTiles = kRows / kRowTile;
constexpr int kFold = 2;         // stages a step (between folds)
constexpr int kXBox = 8;         // x rows a TMA box

// what differs with x's type: the planes, the stage, the ring
template <typename TX>
struct Cfg {
  static constexpr bool kF32 = sizeof(TX) == 4;
  static constexpr int P = kF32 ? 3 : 1;  // bf16 planes of x
  static constexpr int kStageK = kF32 ? 64 : 128;  // K a stage
  static constexpr int kStages = kF32 ? 6 : 4;     // the ring
  static constexpr int kWBox = kStageK * kWgCols * 2;  // a warpgroup's w
  static constexpr int kWBytes = kWBox * kWGs;          // a w stage
  static constexpr int kXBytes = kRows * kStageK * (int)sizeof(TX);
  // x arrives in boxes of 8 rows x 128 bytes, 128-byte swizzled, kXSlabs
  // of them side by side along a stage's K
  static constexpr int kXSlabs = kStageK * (int)sizeof(TX) / 128;
  static constexpr int kBoxBytes = kXBox * 128;
  static constexpr int kPlanes = P * kRows * kStageK * 2;  // a buffer
  // dynamic shared memory: the w ring, the x ring, two planes buffers,
  // the barriers, and room to align the base to 1024 bytes (the 128-byte
  // swizzle's atom); one block an SM
  static constexpr int kSmem = kStages * (kWBytes + kXBytes) + 2 * kPlanes +
                               2 * kStages * 8 + 1024;
  static_assert(kSmem <= 232448, "one block's shared memory");
};

// ---- the CUDA-core route ----
constexpr int kWarpThreads = 128;  // a block: four warps
constexpr int kClusterK = 512;     // K a block, before another block joins
constexpr int kMaxCluster = 8;     // the portable cluster size

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier and TMA ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait for the barrier's phase of this parity; a wait past about ten
// seconds traps (a fault the launch reports) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// a box of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// ---- wgmma ----
// descriptor of a K-major B operand without swizzle: start address, byte
// strides between core matrices along K (lbo) and along N (sbo)
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 16 f32) = (acc ? d : 0) + A B: A (64 x 16 bf16) in registers, B
// (16 x 16 bf16, K-major) in shared memory
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
// the same with B 16 x 48 (three planes of 16 rows side by side)
__device__ __forceinline__ void wgmma_n48(float* d, const uint32_t* a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23}, {%24,%25,%26,%27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <int P>
__device__ __forceinline__ void wgmma_planes(float* d, const uint32_t* a,
                                             uint64_t b, int acc) {
  if constexpr (P == 3)
    wgmma_n48(d, a, b, acc);
  else
    wgmma_n16(d, a, b, acc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warp's wgmmas are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins a register at this point of the program, so that the compiler
// neither reads an accumulator before the wgmma wait nor writes an operand
// while a wgmma may still read it (cute's warpgroup_fence_operand)
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
// this thread's shared-memory stores visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warpgroups' barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// four 8 x 8 b16 matrices, transposed; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---- arithmetic ----
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the three bf16 planes of an f32 pair (a low, b high), x = p0 + p1 + p2
// exactly for normal f32 (quant_matmul.split_bf16x3 is the CPU twin)
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = __fsub_rn(a, f0.x), rb = __fsub_rn(b, f0.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  p0 = bf16x2_bits(h0);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(
      __floats2bfloat162_rn(__fsub_rn(ra, f1.x), __fsub_rn(rb, f1.y)));
}

// s += v; returns the rounding error of that sum, exactly (Knuth's
// branch-free TwoSum)
__device__ __forceinline__ float two_sum(float& s, float v) {
  const float t = __fadd_rn(s, v);
  const float vv = __fsub_rn(t, s);
  const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, vv)), __fsub_rn(v, vv));
  s = t;
  return e;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int filled_rows(const int* counts, int g, int R) {
  return counts ? min(R, max(counts[g], 0)) : R;
}

// Byte offset in a planes buffer of plane p's (row, k), stages of SK: the
// buffer holds, for each row tile t, its P planes, each two 8-row groups of
// SK / 8 core matrices (8 rows x 8 k, 16 bytes a row), so that one K-major
// B descriptor (groups SK * 16 bytes apart) reads a tile's P planes side by
// side.
template <int P, int SK>
__device__ __forceinline__ int plane_off(int p, int row, int k) {
  const int group = ((row / kRowTile) * P + p) * 2 + (row / 8) % 2;
  return (group * (SK / 8) + k / 8) * 128 + (row % 8) * 16 + (k % 8) * 2;
}

// 16-byte chunk c of row `row` of a raw x stage: slab c / 8 (kRows rows
// of 128 bytes each), chunk c % 8 of the row swizzled with row % 8
__device__ __forceinline__ const uint8_t* x_chunk(const uint8_t* raw, int row,
                                                  int c) {
  return raw + (c / 8) * (kRows * 128) + row * 128 +
         (((c % 8) ^ (row % 8)) * 16);
}

// One stage's row halves [0, halves) (8 rows each) from the raw x stage
// into the planes: f32 x as three exact bf16 planes, bf16 x as it is. A
// quarter warp takes eight rows of one 16-byte chunk: its reads fall on
// distinct swizzled chunks and its writes on 128 contiguous bytes.
template <typename TX, int SK>
__device__ __forceinline__ void split_stage(const uint8_t* raw,
                                            uint8_t* planes, int halves,
                                            int tid) {
  constexpr int kChunks = SK * (int)sizeof(TX) / 16;  // 16-byte chunks a row
  for (int e = tid; e < halves * 8 * kChunks; e += kConsumers) {
    const int row = (e / (8 * kChunks)) * 8 + e % 8;
    const int c = (e / 8) % kChunks;
    if constexpr (sizeof(TX) == 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(x_chunk(raw, row, c));
      uint32_t lo[3], hi[3];
      split3(v.x, v.y, lo[0], lo[1], lo[2]);
      split3(v.z, v.w, hi[0], hi[1], hi[2]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(planes + plane_off<3, SK>(p, row, 4 * c)) =
            make_uint2(lo[p], hi[p]);
    } else {
      *reinterpret_cast<uint4*>(planes + plane_off<1, SK>(0, row, 8 * c)) =
          *reinterpret_cast<const uint4*>(x_chunk(raw, row, c));
    }
  }
}

template <typename TX>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                                const __grid_constant__ CUtensorMap tm_x,
                                TX* __restrict__ y,
                                const int* __restrict__ counts, int R, int K,
                                int N) {
  using C = Cfg<TX>;
  constexpr int P = C::P;
  constexpr int SK = C::kStageK;
  constexpr int KK = SK / 16;  // k16 steps a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = smem;                        // the w ring
  uint8_t* xs = ws + C::kStages * C::kWBytes;  // the raw x ring
  uint8_t* planes = xs + C::kStages * C::kXBytes;  // two planes buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + 2 * C::kPlanes);
  uint64_t* empty = full + C::kStages;

  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int active = min(kRows, filled_rows(counts, g, R) - r0);
  TX* yg = y + (int64_t)g * R * N;
  if (active <= 0) {  // the block's rows are all past the count: zeros,
    if (tid < kConsumers)  // nothing read
      for (int i = tid; i < kRows * kCols; i += kConsumers) {
        const int r = r0 + i / kCols, c = n0 + i % kCols;
        if (r < R && c < N) store(&yg[(int64_t)r * N + c], 0.f);
      }
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nst = (K + SK - 1) / SK;

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      // the filled rows' 8-row groups, kXSlabs boxes each
      const int boxes = (active + kXBox - 1) / kXBox;
      for (int st = 0; st < nst; ++st) {
        const int s = st % C::kStages;
        if (st >= C::kStages)
          mbar_wait(&empty[s], ((st / C::kStages) + 1) & 1);
        mbar_expect_tx(&full[s],
                       C::kWBytes + boxes * C::kXSlabs * C::kBoxBytes);
#pragma unroll
        for (int q = 0; q < kWGs; ++q)
          tma_load_3d(ws + s * C::kWBytes + q * C::kWBox, &tm_w,
                      n0 + q * kWgCols, st * SK, g, &full[s]);
        for (int b = 0; b < boxes; ++b)
#pragma unroll
          for (int h = 0; h < C::kXSlabs; ++h)
            tma_load_3d(xs + s * C::kXBytes + h * (kRows * 128) +
                            b * C::kBoxBytes,
                        &tm_x, st * SK + h * (128 / (int)sizeof(TX)),
                        r0 + b * kXBox, g, &full[s]);
      }
    }
    return;
  }

  // the consumer warpgroups: warpgroup wg takes columns n0 + 64 wg
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  // step[t]: the step's sums of row tile t, plane p's 16 rows at d[8 p ..
  // 8 p + 7]; run and err: the folded sums and their carried errors
  float step[kTiles][8 * P], run[kTiles][8], err[kTiles][8];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int i = 0; i < 8 * P; ++i) step[t][i] = 0.f;
  // ldmatrix.trans rows: lane l reads row k = (l / 16) * 8 + l % 8 (plus
  // the k16 step's 16 kk) at 16-byte chunk 2 warp + (l / 8) % 2 of the
  // 128-byte w row, swizzled (chunk ^ k % 8, k % 8 = l % 8)
  const int ld_k = (lane / 16) * 8 + lane % 8;
  const int ld_chunk = (2 * warp + (lane / 8) % 2) ^ (lane % 8);
  auto fence_step = [&]() {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int i = 0; i < 8 * P; ++i) fence_reg(step[t][i]);
  };
  uint32_t a0[KK][4], a1[KK][4];
  auto wait_for = [&](int pending) {  // then a0/a1 and step are settled
    if (pending) wgmma_wait<1>(); else wgmma_wait<0>();
    fence_step();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(a0[kk][i]), fence_reg(a1[kk][i]);
  };

  const int tiles = (active + kRowTile - 1) / kRowTile;
#pragma unroll
  for (int rt = 0; rt < kTiles; ++rt)
#pragma unroll
    for (int i = 0; i < 8; ++i) run[rt][i] = err[rt][i] = 0.f;

  // a stage's operands: its filled x rows split into planes buffer st %
  // 2, w's fragments into registers; then the stage goes back to the
  // producer
  auto prepare = [&](int st, uint32_t(&a)[KK][4]) {
    const int s = st % C::kStages;
    uint8_t* pl = planes + (st % 2) * C::kPlanes;
    mbar_wait(&full[s], (st / C::kStages) & 1);
    split_stage<TX, SK>(xs + s * C::kXBytes, pl, (active + 7) / 8, tid);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      ldsm_x4_t(a[kk], ws + s * C::kWBytes + wg * C::kWBox +
                           (16 * kk + ld_k) * 128 + ld_chunk * 16);
    fence_async_smem();
    wg_sync();  // every thread's planes written, every read of the stage
    if (tid == 0) mbar_arrive(&empty[s]);
  };
  // a prepared stage's wgmmas into step (committed, not waited): its k16
  // steps and the row tiles that hold a filled row, in order, each one
  // m64n(16 P)k16 over the tile's planes side by side; the step's first
  // stage starts step from zero
  auto issue = [&](int st, uint32_t(&a)[KK][4]) {
    uint8_t* pl = planes + (st % 2) * C::kPlanes;
    const int first = st % kFold == 0;
    fence_step();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int rt = 0; rt < kTiles; ++rt)
        if (rt < tiles)
          wgmma_planes<P>(step[rt], a[kk],
                          make_desc(pl + plane_off<P, SK>(
                                             0, kRowTile * rt, 16 * kk),
                                    128, (SK / 8) * 128),
                          !(first && kk == 0));
    wgmma_commit();
    fence_step();
  };
  // a completed step into (run, err): each row half (8 rows) that holds
  // a filled row; the planes' sums added smallest first, (lo + mid) + hi
  auto fold = [&]() {
#pragma unroll
    for (int rt = 0; rt < kTiles; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (kRowTile * rt + 8 * h < active)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = step[rt][8 * (P - 1) + 4 * h + e];
#pragma unroll
            for (int p = P - 2; p >= 0; --p)
              v = __fadd_rn(v, step[rt][8 * p + 4 * h + e]);
            err[rt][4 * h + e] = __fadd_rn(
                err[rt][4 * h + e], two_sum(run[rt][4 * h + e], v));
          }
  };
  // Stages alternate between two sets of fragment registers and planes
  // buffers; a stage is prepared while the stage before runs on the
  // tensor cores, and a step (kFold stages) is folded while the next
  // step's first stage is being prepared.
  prepare(0, a0);
  issue(0, a0);
  for (int st = 1; st <= nst; ++st) {
    // stage st - 1 is in flight; stage st (if any) goes next
    const bool fold_now = st % kFold == 0 || st == nst;
    if (st < nst && !fold_now) {  // chain stage st onto the step
      if (st % 2) prepare(st, a1); else prepare(st, a0);
      if (st % 2) issue(st, a1); else issue(st, a0);
      continue;
    }
    if (st < nst) {  // prepare the next step's first stage, then fold
      wait_for(1);   // the stage that last read its registers is done
      if (st % 2) prepare(st, a1); else prepare(st, a0);
    }
    wait_for(0);
    fold();
    if (st < nst) {
      if (st % 2) issue(st, a1); else issue(st, a0);
    }
  }

  // d[4h + e] of row tile rt: output column 16 warp + lane / 4 + 8 (e /
  // 2) of the warpgroup's 64, row 16 rt + 8 h + 2 (lane % 4) + e % 2
#pragma unroll
  for (int rt = 0; rt < kTiles; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = kRowTile * rt + 8 * h + 2 * (lane % 4) + e % 2;
        const int r = r0 + rl;
        const int c =
            n0 + kWgCols * wg + 16 * warp + lane / 4 + 8 * (e / 2);
        if (r < R && c < N)
          store(&yg[(int64_t)r * N + c],
                rl < active
                    ? __fadd_rn(run[rt][4 * h + e], err[rt][4 * h + e])
                    : 0.f);
      }
}

// The CUDA-core route: a cluster of CL blocks per (column chunk, row,
// group), rank q of the cluster at blockIdx.x % CL
template <int NC, bool kVec>
__global__ void __launch_bounds__(kWarpThreads)
    grouped_matmul_warp_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               float* __restrict__ y,
                               const int* __restrict__ counts, int R, int K,
                               int N, int64_t sxg, int64_t sxr, int64_t swg,
                               int64_t swk, int CL) {
  constexpr int V = NC / 4;                      // 16-byte vectors a w row
  constexpr int U = NC == 8 ? 8 : NC == 16 ? 4 : 2;  // w rows in flight
  constexpr int kWarps = kWarpThreads / 32;
  __shared__ float part[kWarps][NC];
  __shared__ float block_sum[NC];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.z, r = blockIdx.y, c0 = (blockIdx.x / CL) * NC;
  const int tid = threadIdx.x;
  float* yr = y + ((int64_t)g * R + r) * N + c0;
  if (r >= filled_rows(counts, g, R)) {  // the whole cluster leaves
    if (rank == 0 && tid < NC && c0 + tid < N) yr[tid] = 0.f;
    return;
  }
  const float* xr = x + g * sxg + r * sxr;
  const float* wg = w + g * swg + c0;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  auto load = [&](int k, float* v) {
    const float* p = wg + (int64_t)k * swk;
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < V; ++q) {  // N % 4 == 0: a vector is whole or out
        const float4 f = c0 + 4 * q < N
                             ? *reinterpret_cast<const float4*>(p + 4 * q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z,
        v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) v[j] = c0 + j < N ? p[j] : 0.f;
    }
  };
  // thread t of the cluster's T takes k = t, t + T, ... ascending: U rows
  // loaded, then chained in order
  const int nt = kWarpThreads * CL;
  int k = rank * kWarpThreads + tid;
  for (; k + (U - 1) * nt < K; k += U * nt) {
    float v[U][NC], a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = xr[k + u * nt];
      load(k + u * nt, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = __fmaf_rn(a[u], v[u][j], acc[j]);
  }
  for (; k < K; k += nt) {
    float v[NC];
    const float a = xr[k];
    load(k, v);
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = __fmaf_rn(a, v[j], acc[j]);
  }
  // the lanes by a fixed butterfly, the warps in order, the ranks in order
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  if (tid % 32 == 0)
#pragma unroll
    for (int j = 0; j < NC; ++j) part[tid / 32][j] = acc[j];
  __syncthreads();
  if (tid < NC) {
    float s = part[0][tid];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) s = __fadd_rn(s, part[i][tid]);
    block_sum[tid] = s;
  }
  cluster.sync();
  if (rank == 0 && tid < NC && c0 + tid < N) {
    float s = block_sum[tid];
    for (int q = 1; q < CL; ++q)
      s = __fadd_rn(s, cluster.map_shared_rank(block_sum, q)[tid]);
    yr[tid] = s;
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// ---- host ----
int warp_cols(int N) { return N <= 8 ? 8 : N <= 16 ? 16 : 32; }
int warp_cluster(int K) {
  return min(kMaxCluster, max(1, (K + kClusterK - 1) / kClusterK));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// errors of this file's own, below any cudaError_t
constexpr int kErrNoEncode = -1;  // CUDA driver without cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;    // a tensor map was refused (alignment)

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-d map of (d2, d1, d0) elements, d0 contiguous, strides s1 and s2 in
// elements; box (b1, b0)
int encode3(CUtensorMap* map, CUtensorMapDataType dt, int elt, const void* p,
            int d0, int d1, int d2, int64_t s1, int64_t s2, int b0, int b1,
            CUtensorMapSwizzle sw) {
  EncodeTiled fn = encode_fn();
  if (!fn) return kErrNoEncode;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(s1 * elt),
                                 (cuuint64_t)(s2 * elt)};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = fn(map, dt, 3, const_cast<void*>(p), dims, strides, box,
                        one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename TX>
int launch_wgmma(const void* x, const void* w, void* y, const int* counts,
                 int G, int R, int K, int N, int64_t sxg, int64_t sxr,
                 int64_t swg, int64_t swk, cudaStream_t st) {
  CUtensorMap tm_w, tm_x;
  int err = encode3(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, N, K, G,
                    swk, swg, kWgCols, Cfg<TX>::kStageK,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = encode3(&tm_x,
                sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                sizeof(TX), x, K, R, G, sxr, sxg, 128 / (int)sizeof(TX),
                kXBox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  static bool attr = false;  // per instantiation
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_matmul_wgmma_kernel<TX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<TX>::kSmem);
    if (e == cudaSuccess)  // all of the SM's shared memory to the carveout
      e = cudaFuncSetAttribute(grouped_matmul_wgmma_kernel<TX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((N + kCols - 1) / kCols, (R + kRows - 1) / kRows, G);
  grouped_matmul_wgmma_kernel<TX><<<grid, kThreads, Cfg<TX>::kSmem, st>>>(
      tm_w, tm_x, static_cast<TX*>(y), counts, R, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_warp(const float* x, const float* w, float* y, const int* counts,
                int G, int R, int K, int N, int64_t sxg, int64_t sxr,
                int64_t swg, int64_t swk, cudaStream_t st) {
  const int cl = warp_cluster(K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * ((N + NC - 1) / NC), R, G);
  cfg.blockDim = dim3(kWarpThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = N % 4 == 0 && swk % 4 == 0 && swg % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t e =
      vec ? cudaLaunchKernelEx(&cfg, grouped_matmul_warp_kernel<NC, true>, x,
                               w, y, counts, R, K, N, sxg, sxr, swg, swk, cl)
          : cudaLaunchKernelEx(&cfg, grouped_matmul_warp_kernel<NC, false>, x,
                               w, y, counts, R, K, N, sxg, sxr, swg, swk, cl);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch plan of (x type, w type, K, N), as kernels/grouped_matmul.py's
// plan() mirrors it, into out[0..10]: the route (0 tensor cores, 1 CUDA
// cores), planes, columns a block, rows a block, rows a row tile, K a
// stage, K a step (between folds), stages, threads a block, dynamic shared
// memory, blocks a cluster. On the CUDA-core route planes, the step,
// stages and shared memory are 0, and K a stage is the K stride of a
// thread's chain.
template <typename TX>
void describe_wgmma(int* out) {
  using C = Cfg<TX>;
  const int v[11] = {0, C::P, kCols, kRows, kRowTile, C::kStageK,
                     C::kStageK * kFold, C::kStages, kThreads, C::kSmem, 1};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

}  // namespace

extern "C" void grouped_matmul_describe(int x_bf16, int w_bf16, int K, int N,
                                        int* out) {
  if (!x_bf16 && !w_bf16) {
    const int cl = warp_cluster(K);
    const int v[11] = {1, 0, warp_cols(N), 1, 1, kWarpThreads * cl, 0, 0,
                       kWarpThreads, 0, cl};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
  } else if (x_bf16) {
    describe_wgmma<__nv_bfloat16>(out);
  } else {
    describe_wgmma<float>(out);
  }
}

// x (G, R, K) with row stride sxr and group stride sxg elements; w (G, K,
// N) with row stride swk and group stride swg elements; y (G, R, N)
// contiguous; counts (G,) int32 or null. x_bf16 / w_bf16 name the types:
// (0, 0), (0, 1) and (1, 1). The tensor-core route ((0, 1), (1, 1)) needs
// x and w 16-byte aligned and every stride a multiple of 16 bytes (the
// wrapper copies operands that are not). Returns 0, a cudaError_t, or one
// of this file's negative codes.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     const int* counts, int G, int R, int K,
                                     int N, int64_t sxg, int64_t sxr,
                                     int64_t swg, int64_t swk, int x_bf16,
                                     int w_bf16, void* stream) {
  if (G <= 0 || R <= 0 || N <= 0 || K <= 0 || G > 65535 || R > 65535 * kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !w_bf16) {
    if (R > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    switch (warp_cols(N)) {
      case 8:
        return launch_warp<8>(xf, wf, yf, counts, G, R, K, N, sxg, sxr, swg,
                              swk, st);
      case 16:
        return launch_warp<16>(xf, wf, yf, counts, G, R, K, N, sxg, sxr, swg,
                               swk, st);
      default:
        return launch_warp<32>(xf, wf, yf, counts, G, R, K, N, sxg, sxr, swg,
                               swk, st);
    }
  }
  if (!w_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    return launch_wgmma<__nv_bfloat16>(x, w, y, counts, G, R, K, N, sxg, sxr,
                                       swg, swk, st);
  return launch_wgmma<float>(x, w, y, counts, G, R, K, N, sxg, sxr, swg, swk,
                             st);
}

extern "C" const char* grouped_matmul_error_string(int err) {
  if (err == kErrNoEncode)
    return "the CUDA driver offers no cuTensorMapEncodeTiled";
  if (err == kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (alignment or "
           "strides)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
