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
//       x[:, row_idx[l, j, s]*bk : +bk] @ (blocks[l, j, s] * scales[l, j, s])
// The blocks of slots past min(nnz, nmax) are never read, and nothing of
// them reaches y (padding may hold anything); an out-of-range layer id
// reads no slot and writes NaN. x is f32 or bf16, y f32.
//
// What bounds it. Counted, every yi-6b shape is bound by bytes once the
// product runs on the bf16 tensor cores: the surviving int8 blocks over the
// HBM rate, at decode (M = 4) and at prefill (M = 128) alike. The serving
// path's x is eq. 5 data, which is exact in bf16 and takes one MMA a step.
//
// Design (it carries csrc/quant_matmul.cu's over; a BSR block is a bk x bn
// row-major int8 tile, which is that kernel's W stage):
// - Tensor cores. mma.sync m16n8k16 bf16 x bf16 -> f32. An int8 level
//   widened to bf16 is exact, and bf16 x is used as it is. f32 x first goes
//   through a small pass (bsr_x_to_bf16) that writes its bf16 copy and
//   flags, per block of the pass, whether any element differs from its
//   copy. The main kernel reads the flags on the device: when every element
//   is exact in bf16 (eq. 5 activations, level / 2^(a-1) with |level| <=
//   127: the serving path), it stages the copy and runs one MMA a step;
//   otherwise it stages f32 x and splits each fragment into three bf16
//   planes x = x0 + x1 + x2 (exact for normal f32; the CPU twin is
//   quant_matmul.split_bf16x3), skipping the plane-1 and plane-2 MMAs where
//   a warp vote finds them all zero. No argument asks for either path, and
//   nothing trusts the caller. The copy is made once per call: a split
//   inside the kernel is redone by every warp of every column tile.
// - The weight fragment is read from 32-bit words of the staged int8 tile:
//   thread (g, t) of a warp reads the word holding columns 4g..4g+3 and
//   feeds byte j to n8 tile j, so output column 4g + j of the warp's 32 sits
//   at MMA column g of tile j and each thread stores 8 contiguous columns.
// - Per-block scales. A scale belongs to a block, so each slot's sum
//   starts from zero and is folded into the running sum as
//   run = fmaf(scale, slot, run), slot by slot in ascending order. On eq. 5
//   data with power-of-two scales every sum is exact.
// - Accuracy off the grid. The MMA's f32 accumulator truncates its addends
//   to the largest one, so on the three-plane path a k16 step never
//   accumulates onto a large sum: its MMAs start from zero (planes 1 and 2
//   in their own accumulator) and the step is folded straight into the
//   running sum with its rounding errors carried (fold: exact TwoSum and
//   fma residues). The split reduce carries its errors the same way. A sum
//   of thousands of f32 terms then stays within about 1e-5 of the exact
//   product at yi-6b widths, closer than an f32 matmul comes.
// - Deterministic split-K over the slot axis. Split z (blockIdx.z) takes
//   slots [z * S, (z + 1) * S) of its column; split, it writes f32 partial
//   sums to a workspace and a second kernel adds the splits in split order.
//   No atomics. S comes from the wrapper's plan(), which reads M, K / bk,
//   go, bn and the SM count and never nmax, nnz, L or the layer: a layer's
//   own packing (loop runtime) and the padded envelope (scan runtime) cut
//   every column's slots alike, the envelope's extra splits add exact
//   zeros, and the two runtimes agree bit for bit.
// - 16-byte cp.async.cg copies of the gathered x slice (x[:, row_idx*bk +
//   kc : +64]) and of 64 rows of the int8 block into a ring of stages (4
//   bf16 stages; the f32 path fits 2 or 3 into the same bytes). The split's
//   row offsets and scales are read into shared memory at the start, beside
//   the column's slot count rather than after it. Rows are padded (x: 8
//   elements, W: 16 bytes) so the fragment reads hit distinct banks. Ragged
//   edges (M, bk, bn) are zero-filled by cp.async's src-size operand.
// - The tile height is a template: 16 rows (decode) or 64 by 128 columns,
//   4 warps across the columns (32 each) and, at 64 rows, 2 down the rows.
//   The launch bounds keep 4 (16 rows) or 2 (64 rows) blocks on an SM; the
//   two paths share two sets of accumulators (slot and running sums, or
//   running sums and their errors) to fit.
// - Operands that miss the 16-byte conditions (pointer alignment, K * elem,
//   bk * elem or bn not a multiple of 16 bytes) take the same kernel with
//   element-wise masked loads and stores (ALIGNED = false); both paths stage
//   the same values, so they give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 64;             // rows of a block's K per stage
constexpr int kStages = 4;          // bf16 stages in the ring
constexpr int kWPitch = kBN + 16;   // bytes per staged W row
constexpr int kXPitch = kBK + 8;    // elements per staged x row
constexpr int kMaxSlots = 128;      // slots per split (the plan's S), most
constexpr int kMaxPre = 128;        // blocks of the bf16 copy pass, most
constexpr int kPreThreads = 1024;   // and its threads per block
constexpr int kMaxDevices = 64;

// BM rows by kBN columns per block: one warp per 32 columns, and 2 down
// the rows when BM >= 64; kMinBlocks resident per SM (launch bounds)
template <int BM>
struct Warps {
  static constexpr int kN = kBN / 32;
  static constexpr int kM = BM == 16 ? 1 : 2;
  static constexpr int kThreads = 32 * kN * kM;
  static constexpr int kRows = BM / kM;  // rows per warp
  static constexpr int kMT = kRows / 16;  // m16 tiles per warp
  static constexpr int kMinBlocks = BM == 16 ? 4 : 2;
};

// one stage: BM rows of x (as T), then kBK rows of the int8 block
template <typename T, int BM>
struct Stage {
  static constexpr int kX = BM * kXPitch * (int)sizeof(T);
  static constexpr int kBytes = kX + kBK * kWPitch;
};

// the ring, then the split's row offsets (int) and scales (f32)
template <int BM>
struct Smem {
  static constexpr int kRing = kStages * Stage<__nv_bfloat16, BM>::kBytes;
  static constexpr int kF32Stages = kRing / Stage<float, BM>::kBytes;
  static constexpr int kTotal = kRing + kMaxSlots * 8;
  static_assert(kF32Stages >= 2, "the f32 path needs two stages");
};

// one call's operands and plan
struct Args {
  const void* x;             // (M, K) bf16 or f32
  const __nv_bfloat16* xb;   // f32 x's bf16 copy, or null
  const int* inexact;        // per copy-pass block: a copy differs
  int n_pre;                 // copy-pass blocks
  const int8_t* blocks;
  const float* scales;
  const int* row_idx;
  const int* nnz;
  const int* layer;
  float* y;
  float* part;  // splits * M * N f32 partial sums, when split
  int M, K, L, go, nmax, bk, bn;
  int slots;    // S: slots per split
};

// where a block is: its tile, its warp's place in it, its split's slots
struct Tile {
  int tid, lane, g, t, wn, wrow, m0, n0;
  int64_t slot0;  // the split's first slot
  int count;      // its valid slots
  const int* s_col;
  const float* s_scale;
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

// s += v; returns the rounding error of that sum, exactly (Knuth's
// branch-free TwoSum)
__device__ __forceinline__ float two_sum(float& s, float v) {
  const float t = __fadd_rn(s, v);
  const float vv = __fsub_rn(t, s);
  const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, vv)), __fsub_rn(v, vv));
  s = t;
  return e;
}

// run + err += scale * slot: the product's rounding error (an fma gives it
// exactly) and the sum's are carried in err, so each element's f32 result
// is as close to the exact sum as the slot sums allow
__device__ __forceinline__ void fold(float& run, float& err, float scale,
                                     float slot) {
  const float p = __fmul_rn(scale, slot);
  const float pe = __fmaf_rn(scale, slot, -p);
  err = __fadd_rn(err, __fadd_rn(two_sum(run, p), pe));
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}

// one stage of one slot: x rows [m0, m0 + BM) at columns xcol + [0, kn)
// (xcol < 0: a row index out of range, read as zeros) and rows [0, kn) of
// the block's k-chunk `w` (already offset to row kc), columns [n0, n0 +
// kBN) of bn
template <typename T, int BM, bool ALIGNED>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const T* __restrict__ x, const int8_t* __restrict__ w,
    int xcol, int kn, int M, int K, int bn, int m0, int n0, int tid) {
  constexpr int kThreads = Warps<BM>::kThreads;
  T* xs = reinterpret_cast<T*>(st);
  int8_t* ws = reinterpret_cast<int8_t*>(st + Stage<T, BM>::kX);
  const bool x_ok = xcol >= 0;
  if constexpr (ALIGNED) {
    constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
    constexpr int kRowChunks = kBK / kVec;
    for (int i = tid; i < BM * kRowChunks; i += kThreads) {
      const int r = i / kRowChunks, c = (i % kRowChunks) * kVec;
      const int gm = m0 + r;
      const bool in = x_ok && gm < M && c < kn;
      cp_async16(xs + r * kXPitch + c,
                 in ? x + (int64_t)gm * K + xcol + c : x, in ? 16 : 0);
    }
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const bool in = r < kn && n0 + c < bn;
      cp_async16(ws + r * kWPitch + c, in ? w + r * bn + n0 + c : w,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r;
      xs[r * kXPitch + c] = (x_ok && gm < M && c < kn)
                                ? x[(int64_t)gm * K + xcol + c]
                                : zero_of(T());
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      ws[r * kWPitch + c] =
          (r < kn && n0 + c < bn) ? w[r * bn + n0 + c] : int8_t(0);
    }
  }
}

// the B fragments of one k16 step for the warp's 32 columns (column 4g +
// jj at MMA column g of n8 tile jj); ws points at thread (g, t)'s word in
// the step's row 2t, and rows 2t + 1, 2t + 8 and 2t + 9 follow
__device__ __forceinline__ void b_fragments(const unsigned char* ws,
                                            uint32_t (&b)[4][2]) {
  const uint32_t r0 = *reinterpret_cast<const uint32_t*>(ws) ^ 0x80808080u;
  const uint32_t r1 =
      *reinterpret_cast<const uint32_t*>(ws + kWPitch) ^ 0x80808080u;
  const uint32_t r2 =
      *reinterpret_cast<const uint32_t*>(ws + 8 * kWPitch) ^ 0x80808080u;
  const uint32_t r3 =
      *reinterpret_cast<const uint32_t*>(ws + 9 * kWPitch) ^ 0x80808080u;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    b[jj][0] = levels_bf16x2(r0, r1, jj);
    b[jj][1] = levels_bf16x2(r2, r3, jj);
  }
}

// The block's slots through a ring of STAGES stages of x as T. bf16: u is
// the slot's sum (one MMA a step, straight into it), v the running sum.
// f32: u is the running sum and v its carried error; each k16 step is
// folded in as it comes. Either way u holds the result at the end.
template <typename T, int BM, bool ALIGNED, int STAGES>
__device__ __forceinline__ void mainloop(
    const Args& a, const Tile& tl, const T* __restrict__ x,
    unsigned char* smem, float (&u)[Warps<BM>::kMT][4][4],
    float (&v)[Warps<BM>::kMT][4][4]) {
  constexpr int MT = Warps<BM>::kMT;
  constexpr int kStage = Stage<T, BM>::kBytes;
  const int nchunk = (a.bk + kBK - 1) / kBK;
  const int steps = tl.count * nchunk;
  const int64_t block_bytes = (int64_t)a.bk * a.bn;
  auto fetch = [&](int step) {
    const int s = step / nchunk;
    const int kc = (step - s * nchunk) * kBK;
    const int xcol = tl.s_col[s];
    load_stage<T, BM, ALIGNED>(
        smem + (step % STAGES) * kStage, x,
        a.blocks + (tl.slot0 + s) * block_bytes + (int64_t)kc * a.bn,
        xcol < 0 ? -1 : xcol + kc, min(kBK, a.bk - kc), a.M, a.K, a.bn,
        tl.m0, tl.n0, tl.tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) fetch(s);
    cp_async_commit();
  }

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free to refill
    if (it + STAGES - 1 < steps) fetch(it + STAGES - 1);
    cp_async_commit();

    const int s = it / nchunk;
    const int kc = (it - s * nchunk) * kBK;
    const int kn = min(kBK, a.bk - kc);  // rows of this stage, uniform
    const float sc = tl.s_scale[s];
    const unsigned char* st = smem + (it % STAGES) * kStage;
    const T* xs = reinterpret_cast<const T*>(st);
    const unsigned char* ws =
        st + Stage<T, BM>::kX + tl.wn * 32 + 4 * tl.g + 2 * tl.t * kWPitch;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk * 16 >= kn) break;  // zero rows past bk add nothing
      uint32_t b[4][2];
      b_fragments(ws + kk * 16 * kWPitch, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (sizeof(T) == 2) {
          uint32_t af[4];
          const T* p = xs + (tl.wrow + mt * 16 + (tl.lane & 15)) * kXPitch +
                       kk * 16 + (tl.lane >> 4) * 8;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
              : "r"(smem_addr(p)));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_bf16(u[mt][jj], af, b[jj]);
        } else {
          const T* p =
              xs + (tl.wrow + mt * 16 + tl.g) * kXPitch + kk * 16 + 2 * tl.t;
          uint32_t af[3][4];
          split3(*reinterpret_cast<const float2*>(p), af[0][0], af[1][0],
                 af[2][0]);
          split3(*reinterpret_cast<const float2*>(p + 8 * kXPitch), af[0][1],
                 af[1][1], af[2][1]);
          split3(*reinterpret_cast<const float2*>(p + 8), af[0][2], af[1][2],
                 af[2][2]);
          split3(*reinterpret_cast<const float2*>(p + 8 * kXPitch + 8),
                 af[0][3], af[1][3], af[2][3]);
          // planes 1 and 2 only where some lane of the warp has them (a
          // warp-uniform vote: every lane takes part in an mma.sync)
          const bool p1 = __any_sync(
              0xffffffffu, (af[1][0] | af[1][1] | af[1][2] | af[1][3]) != 0u);
          const bool p2 = __any_sync(
              0xffffffffu, (af[2][0] | af[2][1] | af[2][2] | af[2][3]) != 0u);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float hi[4] = {0.f, 0.f, 0.f, 0.f};
            float lo[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(hi, af[0], b[jj]);
            if (p1) mma_bf16(lo, af[1], b[jj]);
            if (p2) mma_bf16(lo, af[2], b[jj]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              fold(u[mt][jj][c], v[mt][jj][c], sc, hi[c]);
              v[mt][jj][c] = __fmaf_rn(sc, lo[c], v[mt][jj][c]);
            }
          }
        }
      }
    }
    if constexpr (sizeof(T) == 2) {
      if (kc + kBK >= a.bk) {  // the slot's last stage: fold in its scale
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              v[i][jj][c] = fmaf(sc, u[i][jj][c], v[i][jj][c]);
              u[i][jj][c] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();  // no copy may land after the loop ends
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        u[i][jj][c] = sizeof(T) == 2 ? v[i][jj][c]
                                     : __fadd_rn(u[i][jj][c], v[i][jj][c]);
}

// y (or split z's partial sums) for the block's BM x kBN tile of block
// column j over slots [z * S, (z + 1) * S) of that column
template <typename T, int BM, bool ALIGNED>
__global__ void __launch_bounds__(Warps<BM>::kThreads, Warps<BM>::kMinBlocks)
bsr_matmul_kernel(const Args a) {
  constexpr int MT = Warps<BM>::kMT;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_col = reinterpret_cast<int*>(smem + Smem<BM>::kRing);
  float* s_scale = reinterpret_cast<float*>(s_col + kMaxSlots);
  Tile tl;
  tl.tid = threadIdx.x;
  tl.lane = tl.tid & 31;
  tl.g = tl.lane >> 2;
  tl.t = tl.lane & 3;
  const int warp = tl.tid >> 5;
  tl.wn = warp % Warps<BM>::kN;
  tl.wrow = warp / Warps<BM>::kN * Warps<BM>::kRows;
  const int col_tiles = (a.bn + kBN - 1) / kBN;
  const int j = blockIdx.x / col_tiles;
  tl.n0 = (blockIdx.x % col_tiles) * kBN;
  tl.m0 = blockIdx.y * BM;
  tl.s_col = s_col;
  tl.s_scale = s_scale;
  const int gi = a.K / a.bk;

  // the copy pass's flags, read beside the layer id
  int inexact = 0;
  if constexpr (sizeof(T) == 4)
    if (a.xb != nullptr && tl.tid < a.n_pre) inexact = a.inexact[tl.tid];
  const int l = *a.layer;
  const bool layer_ok = l >= 0 && l < a.L;
  tl.slot0 = 0;
  tl.count = 0;
  if (layer_ok) {
    const int first = blockIdx.z * a.slots;
    tl.slot0 = ((int64_t)l * a.go + j) * a.nmax + first;
    // the split's row indices and scales beside the column's count (a
    // padding slot's are read with them and never used)
    const int have = min(a.slots, a.nmax - first);
    for (int i = tl.tid; i < have; i += Warps<BM>::kThreads) {
      const int r = a.row_idx[tl.slot0 + i];
      s_col[i] = (r >= 0 && r < gi) ? r * a.bk : -1;
      s_scale[i] = a.scales[tl.slot0 + i];
    }
    const int cnt = min(max(a.nnz[(int64_t)l * a.go + j], 0), a.nmax);
    tl.count = max(0, min(a.slots, cnt - first));
  }
  const bool exact = !__syncthreads_or(inexact);  // also s_col's barrier

  float u[MT][4][4], v[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) u[i][jj][c] = v[i][jj][c] = 0.f;
  if constexpr (sizeof(T) == 2) {
    mainloop<T, BM, ALIGNED, kStages>(a, tl, static_cast<const T*>(a.x),
                                      smem, u, v);
  } else {
    if (a.xb != nullptr && exact)
      mainloop<__nv_bfloat16, BM, ALIGNED, kStages>(a, tl, a.xb, smem, u, v);
    else
      mainloop<float, BM, ALIGNED, Smem<BM>::kF32Stages>(
          a, tl, static_cast<const float*>(a.x), smem, u, v);
  }

  // thread (g, t) holds columns 8t..8t+7 of the warp's 32 (column 4c + jj
  // at MMA column c of tile jj) for rows g and g + 8 of each m16 tile
  const int64_t N = (int64_t)a.go * a.bn;
  const int col = tl.n0 + tl.wn * 32 + 8 * tl.t;  // within block column j
  float* out = gridDim.z > 1 ? a.part + (int64_t)blockIdx.z * a.M * N : a.y;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.m0 + tl.wrow + mt * 16 + tl.g + 8 * h;
      if (row >= a.M) continue;
      float o[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        o[jj] = layer_ok ? u[mt][jj][2 * h] : nan;
        o[4 + jj] = layer_ok ? u[mt][jj][2 * h + 1] : nan;
      }
      float* dst = out + (int64_t)row * N + (int64_t)j * a.bn + col;
      if constexpr (ALIGNED) {
        if (col >= a.bn) continue;  // bn % 16 == 0: 8 columns all in or out
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (col + c < a.bn) dst[c] = o[c];
      }
    }
  }
}

// xb = bf16(x), four elements a thread at a time; inexact[block] = whether
// any element of the block's share differs from its copy (NaN does)
__global__ void __launch_bounds__(kPreThreads)
bsr_x_to_bf16(const float4* __restrict__ x, uint2* __restrict__ xb,
              int* __restrict__ inexact, int64_t n4) {
  int off = 0;
  for (int64_t i = (int64_t)blockIdx.x * kPreThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kPreThreads) {
    const float4 e = x[i];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(e.x, e.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(e.z, e.w);
    const float2 fl = __bfloat1622float2(lo), fh = __bfloat1622float2(hi);
    off |= (fl.x != e.x) | (fl.y != e.y) | (fh.x != e.z) | (fh.y != e.w);
    xb[i] = make_uint2(bf16x2_bits(lo), bf16x2_bits(hi));
  }
  off = __syncthreads_or(off);
  if (threadIdx.x == 0) inexact[blockIdx.x] = off;
}

// y = sum over splits z = 0, 1, ... of part[z], added in split order with
// the rounding errors carried (two_sum)
__global__ void __launch_bounds__(256)
bsr_split_reduce(const float* __restrict__ part, float* __restrict__ y,
                 int64_t mn, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i], e = 0.f;
    for (int z = 1; z < splits; ++z) e += two_sum(s, part[z * mn + i]);
    y[i] = s + e;
  }
}

template <typename T, int BM, bool ALIGNED>
cudaError_t launch(const Args& a, int splits, int device,
                   cudaStream_t stream) {
  constexpr int smem = Smem<BM>::kTotal;
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {  // dynamic shared memory above 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_matmul_kernel<T, BM, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const int row_tiles = (a.M + BM - 1) / BM;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err;
  if (a.xb != nullptr) {
    bsr_x_to_bf16<<<a.n_pre, kPreThreads, 0, stream>>>(
        static_cast<const float4*>(a.x),
        reinterpret_cast<uint2*>(const_cast<__nv_bfloat16*>(a.xb)),
        const_cast<int*>(a.inexact), (int64_t)a.M * a.K / 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 grid(a.go * ((a.bn + kBN - 1) / kBN), row_tiles, splits);
  bsr_matmul_kernel<T, BM, ALIGNED>
      <<<grid, Warps<BM>::kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = (int64_t)a.M * a.go * a.bn;
  const int blocks = (int)(mn / 256 + 1 < 8192 ? mn / 256 + 1 : 8192);
  bsr_split_reduce<<<blocks, 256, 0, stream>>>(a.part, a.y, mn, splits);
  return cudaGetLastError();
}

template <typename T, bool ALIGNED>
cudaError_t launch_bm(int bm, const Args& a, int splits, int device,
                      cudaStream_t stream) {
  switch (bm) {
    case 16:
      return launch<T, 16, ALIGNED>(a, splits, device, stream);
    case 64:
      return launch<T, 64, ALIGNED>(a, splits, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// y = x @ W[layer] on the plan the wrapper chose: tile height bm (16 or
// 64), `slots` slots per split and `splits` splits (slots * splits >= nmax)
// with the partial sums in `part` (splits * M * go * bn f32, unused when
// splits is 1), and the 16-byte path when `aligned`, which it checks again
// here. For f32 x, `xb` (M * K bf16) and `inexact` (n_pre ints) take the
// bf16 copy and its flags; null xb skips the copy (the three-plane path).
// x, the packing and y are contiguous. Launches on `stream` of device
// `device` and returns the first cudaError_t of the launches (0 = ok).
int bsr_matmul_launch(const void* x, int x_is_bf16, void* xb, void* inexact,
                      int n_pre, const void* blocks, const void* scales,
                      const void* row_idx, const void* nnz, const void* layer,
                      void* y, void* part, int M, int K, int L, int go,
                      int nmax, int bk, int bn, int bm, int slots, int splits,
                      int aligned, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || go <= 0 || bn <= 0) return 0;
  if (bk <= 0 || K % bk != 0 || slots < 1 || slots > kMaxSlots ||
      splits < 1 || splits > 65535 || (int64_t)slots * splits < nmax ||
      (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = x_is_bf16 ? 2 : 4;
  if (aligned && !(aligned16(x) && aligned16(blocks) && aligned16(y) &&
                   aligned16(part) && ((int64_t)K * elem) % 16 == 0 &&
                   (bk * elem) % 16 == 0 && bn % 16 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // the copy: f32 x on the 16-byte path whose bf16 rows are 16-byte chunks
  if (xb && (x_is_bf16 || !aligned || !inexact || n_pre < 1 ||
             n_pre > kMaxPre || !aligned16(xb) || K % 8 != 0 || bk % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,
               static_cast<const __nv_bfloat16*>(xb),
               static_cast<const int*>(inexact),
               n_pre,
               static_cast<const int8_t*>(blocks),
               static_cast<const float*>(scales),
               static_cast<const int*>(row_idx),
               static_cast<const int*>(nnz),
               static_cast<const int*>(layer),
               static_cast<float*>(y),
               static_cast<float*>(part),
               M, K, L, go, nmax, bk, bn, slots};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    err = aligned ? launch_bm<__nv_bfloat16, true>(bm, a, splits, device, st)
                  : launch_bm<__nv_bfloat16, false>(bm, a, splits, device, st);
  else
    err = aligned ? launch_bm<float, true>(bm, a, splits, device, st)
                  : launch_bm<float, false>(bm, a, splits, device, st);
  return static_cast<int>(err);
}

const char* bsr_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
