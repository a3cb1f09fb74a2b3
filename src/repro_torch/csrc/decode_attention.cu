// Paged decode / verify attention for Hopper (sm_90a): one launch, K/V
// shared across the head group and the query tokens, keys split across a
// thread-block cluster, every sum in an order fixed by the query row alone.
//
// Computes the attention of the paged decode and speculative verify pass
// (repro_torch.models.layers.decode_attention_multi; the reference leaves
// it to XLA: src/repro/models/layers.py:281, attention_scores :110). There
// is no Pallas kernel behind it: the port writes it by hand so that a query
// row's output depends on nothing but its own inputs. Row (b, t, h) at
// position pe = pos[b] + t attends keys lo..hi of its kv head
// kvh = h / G (G = H_true / KV), with hi = min(pe, Sv - 1) and
// lo = max(0, pe - window + 1) for a sliding window (0 = full); heads
// h >= H_true are zero padding and write zeros. The key at position
// pos[b] + t' (t' < T) is read from k_new / v_new (B, T, KV, dh) when they
// are given, else from the view. Three forms: bf16 throughout; f32 q over
// bf16 K/V (the compressed serving path's: q leaves the block-sparse kernel
// in f32, the paged views are bf16, and the kernel widens them exactly
// instead of the caller copying them to f32); f32 throughout. In f32, with
// round_t the rounding to the type of q (f32 or bf16):
//   s_j = round_t(round_t(q . k_j) / scale)     scale = round_t(sqrt(dh))
//   e_j = exp(s_j - max_j s_j),   p_j = round_t(e_j / sum_j e_j)
//   out = round_t(sum_j p_j v_j)
// which is the plain version's arithmetic (kernels/decode_attention.py),
// with the sums in another order.
//
// The order. Keys are cut into chunks of ABSOLUTE positions, 128 keys
// over bf16 K/V and 64 over f32 (chunk_keys). A chunk's scores, maxes, exp
// sum and p . v partial depend on the chunk's keys and the row alone:
// q . k over bf16 K/V on tensor cores (mma.sync m16n8k16 bf16 -> f32), d in
// k16 steps in turn, f32 q as three bf16 planes hi + mid + lo (exact, so
// each product is exact) added in that order each step; over f32 K/V one
// fmaf chain over d; the chunk's exp sum over groups of 8 keys in turn,
// each group (x0 + x1) + (x2 + x3) with x_t the sum of keys 2t and 2t+1;
// its p . v in k16 steps of keys in turn (f32 p as three planes likewise;
// over f32 K/V one fmaf chain over its keys). A row's max is the max of its
// chunk maxes (exact in any order); its exp sum and its output add the
// chunk sums and partials of its own chunks lo/chunk..hi/chunk in
// ascending order, one at a time, each kept apart until then. So nothing
// of the order comes from T, B, H, Sv, the tile or the cluster: a T-token
// verify pass gives each position what T one-token steps give, bit for bit,
// which the speculative accept rule stands on. An MMA output element
// depends only on its own row of A and column of B, so a row's place in the
// tile changes nothing either.
//
// The launch. A cluster of CTAs serves one query tile: one (b, kv head) and
// up to 64 rows (the G heads of that kv head times up to 64/G of the T
// tokens), so each K and V row loaded serves every row of the tile. The
// tile's chunks are dealt to the cluster's CTAs in turn (chunk g to rank
// g % cluster). Each CTA streams its K tiles through a ring of 16-byte
// cp.async copies (neighbouring threads on neighbouring addresses), keeps
// its scores in shared memory (bf16 scores are exact in bf16; past the
// plan's `cache` chunks they are recomputed from K, the same bits), and
// the cluster exchanges row maxes and chunk sums through distributed
// shared memory. Then each CTA streams its V tiles, writes each chunk's
// p . v partial into its own shared memory, and after a cluster barrier
// every CTA adds a share of the tile's (row, dim) outputs over the chunk
// partials of the whole cluster in chunk order. When a CTA owns more chunks
// than its `slots` of partials, the partials are added in rounds, the
// running sum kept in shared memory between them. No scratch in device
// memory, one launch for every row form.
//
// What bounds it: bytes at decode (each attended K and V row read once,
// q read and the output written once; 4 dh FLOPs per (row, key) are far
// below the tensor-core rate, three times that for f32 q), the bf16
// tensor-core rate for long verify and prefix tiles. The plan
// (kernels/decode_attention.py: plan) sizes the query tile and the
// cluster from the shapes and the SM count so that B x KV tiles fill the
// card, and each K/V byte crosses HBM once, in its own type. In practice
// it runs latency-bound: a chunk's steps are short chains of dependent
// instructions at 16 warps an SM, and the cluster's exchanges add fixed
// costs of a few microseconds (PERF.md, section 6).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDh = 256;
constexpr int kMaxGroup = 16;
constexpr int kMaxMTiles = 4;  // 16-row MMA tiles in a query tile
constexpr int kMaxCluster = 8;
constexpr int kSmemMax = 232448;     // 227 KB a block

// ring stages of K/V tiles: one in flight while one is used (the loads
// outrun the work a tile carries)
constexpr int kStages = 2;

// keys per chunk, by absolute position (a type's own constant: bf16 128,
// f32 64, whose K/V tiles are twice as wide)
__host__ __device__ constexpr int chunk_keys(int elt) {
  return elt == 2 ? 128 : 64;
}

// threads a CTA: one warp to each 8-key group of a chunk (16 warps in
// bf16, 8 in f32), so that each thread's share of a chunk's per-(row, key)
// work is one group's and the SM has warps to hide its latencies with
__host__ __device__ constexpr int cta_threads(int elt) {
  return chunk_keys(elt) / 8 * 32;
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Dynamic shared memory of a CTA, in byte offsets. The one place the
// layout is known: the Python plan (kernels/decode_attention.py: plan)
// sizes its launches through decode_attention_smem and
// decode_attention_chunk_keys below. The CPU tests' emulation keeps a
// copy, held equal to these two on the card.
struct Layout {
  int dh_pad;  // dh up to a multiple of 16
  int pitch;   // q / K / V row pitch, elements
  int ppitch;  // partial row pitch, floats
  int rows;    // 16 * m_tiles
  int acc_n;   // running-sum floats a CTA keeps between rounds
  int q, ring, scores, planes, partial, csum, acc, rowf, total;
};

// q_elt: bytes of q, p and the output; kv_elt: of K and V. f32 q over bf16
// K/V keeps q and p also as three bf16 planes (`planes`, q's in the q
// region), and stages f32 q through the partials before splitting it.
__host__ __device__ inline Layout make_layout(int q_elt, int kv_elt,
                                              int m_tiles, int dh, int sv,
                                              int cluster, int cache,
                                              int slots) {
  Layout l;
  l.dh_pad = (dh + 15) / 16 * 16;
  l.pitch = l.dh_pad + 8;
  l.ppitch = l.dh_pad + 4;
  l.rows = 16 * m_tiles;
  const int C = chunk_keys(kv_elt), SP = C + 8;  // score / p row pitch
  const bool split = q_elt == 4 && kv_elt == 2;
  const int nch = (sv + C - 1) / C;
  const int nk_cap = (nch + cluster - 1) / cluster;
  const int threads = cta_threads(kv_elt);
  const int per = cluster * threads * 4;  // 4-dim groups a thread
  l.acc_n = (l.rows * l.dh_pad + per - 1) / per * threads * 4;
  int off = 0;
  l.q = off;
  off += align16(l.rows * l.pitch * (split ? 3 * 2 : q_elt));
  l.ring = off;
  off += align16(kStages * C * l.pitch * kv_elt);
  l.scores = off;  // `cache` chunks and one more to compute into
  off += align16((cache + 1) * l.rows * SP * q_elt);
  l.planes = off;  // p as three bf16 planes (f32 q over bf16 K/V)
  off += align16(split ? 3 * l.rows * SP * 2 : 0);
  l.partial = off;
  off += align16(slots * l.rows * l.ppitch * 4);
  l.csum = off;
  off += align16(nk_cap * l.rows * 4);
  l.acc = off;
  off += align16(l.acc_n * 4);
  l.rowf = off;  // local max, row max, row sum (f32), lo, hi (int), and
                 // two buffers of C / 8 rows of max(rows, 32) floats
  off += align16((5 * l.rows + 2 * (C / 8) * (l.rows > 32 ? l.rows : 32)) *
                 4);
  l.total = off;
  return l;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ float round_t(float x);
template <> __device__ __forceinline__ float round_t<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + mid + lo exactly, each a bf16 (8 significant bits apiece of
// x's 24), so that each plane's product with a bf16 value is exact in f32
__device__ __forceinline__ void split3(float x, __nv_bfloat16* hi,
                                       __nv_bfloat16* mid,
                                       __nv_bfloat16* lo) {
  *hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(*hi);
  *mid = __float2bfloat16_rn(r);
  *lo = __float2bfloat16_rn(r - __bfloat162float(*mid));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_new;  // null: every key from the view
  const void* v_new;
  void* out;
  const void* pos;
  int T, H, h_true, KV, Sv, dh, window, group;
  int tokens;  // query tokens a tile takes
  int n_tt;    // tiles over T
  int cluster, cache, slots;
  int pos64, vec;
  float scale;
  Layout lay;
};


// T: q, p and the output (the type the plain version rounds to); KT: K and
// V. bf16 K/V run on tensor cores (f32 q and p as three exact bf16 planes),
// f32 K/V on CUDA-core fmaf. DP: the head width padded to 16 when it is
// known at compile time (the models' 128), else 0 and read from the layout
template <typename T, typename KT, int MT, int DP>
__global__ void __launch_bounds__(cta_threads(sizeof(KT)), 1)
    decode_attention_kernel(const Args a) {
  constexpr bool kMma = sizeof(KT) == 2;
  constexpr bool kSplit = kMma && sizeof(T) == 4;
  constexpr int NP = kSplit ? 3 : 1;  // bf16 planes of q and p
  constexpr int ST = kStages;
  constexpr int VQ = 16 / sizeof(T), VK = 16 / sizeof(KT);  // a 16-B copy
  constexpr int R = 16 * MT;  // rows of the tile, padded
  constexpr int C = chunk_keys(sizeof(KT)), SP = C + 8;
  constexpr int kThreads = cta_threads(sizeof(KT)), kWarps = kThreads / 32;
  constexpr int NT = C / (8 * kWarps);  // 8-key groups (MMA n-tiles) a warp
  static_assert(NT >= 1 && R * 32 % kThreads == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the MMA fragment layout every per-(row, key) step of a chunk uses:
  // thread (warp, g, t4) holds rows mt * 16 + g + 8 h and keys
  // 8 (NT warp + n) + 2 t4 + u of the chunk, for every mt < MT, n < NT
  // and h, u < 2
  const int g = lane >> 2, t4 = lane & 3;
  const Layout& L = a.lay;
  const int dh = a.dh, dp = DP ? DP : L.dh_pad;
  const int pitch = DP ? DP + 8 : L.pitch, pp = DP ? DP + 4 : L.ppitch;

  // the tile: blockIdx.x / cs = (b * KV + kvh) * n_tt + its token tile
  const int tile = blockIdx.x / cs;
  const int kvh = (tile / a.n_tt) % a.KV;
  const int b = tile / (a.n_tt * a.KV);
  const int t0 = (tile % a.n_tt) * a.tokens;
  const int tn = min(a.tokens, a.T - t0);
  const int G = a.group;
  const int nrows = G * tn;  // row i: token t0 + i / G, head kvh * G + i % G
  const int pb = a.pos64 ? static_cast<int>(
                               static_cast<const int64_t*>(a.pos)[b])
                         : static_cast<const int*>(a.pos)[b];
  const int Sv = a.Sv;

  T* qs = reinterpret_cast<T*>(smem + L.q);  // f32 or bf16 K/V: q as is
  // bf16 K/V: q's planes, [NP][R][pitch] (plane 0 is q itself in bf16)
  __nv_bfloat16* qpl = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* ppl = reinterpret_cast<__nv_bfloat16*>(smem + L.planes);
  KT* ring = reinterpret_cast<KT*>(smem + L.ring);
  T* sc = reinterpret_cast<T*>(smem + L.scores);
  float* part = reinterpret_cast<float*>(smem + L.partial);
  float* csum = reinterpret_cast<float*>(smem + L.csum);
  float* accs = reinterpret_cast<float*>(smem + L.acc);
  float* lmax = reinterpret_cast<float*>(smem + L.rowf);
  float* rmax = lmax + R;
  float* rsum = rmax + R;
  int* rlo = reinterpret_cast<int*>(rsum + R);
  int* rhi = rlo + R;
  // two buffers of [C / 8][max(R, 32)] floats for the key groups' partials
  float* wsc = reinterpret_cast<float*>(rhi + R);
  constexpr int WP = R > 32 ? R : 32;

  // the tile's chunks: from its first token's lo to its last token's hi
  const int pe0 = pb + t0, pe1 = pb + t0 + tn - 1;
  const int klo = a.window > 0 ? max(0, pe0 - a.window + 1) : 0;
  const int khi = min(pe1, Sv - 1);
  const int cf = klo / C;
  const int nch = khi >= klo ? khi / C - cf + 1 : 0;
  const int nk = nch > rank ? (nch - rank + cs - 1) / cs : 0;  // mine
  const int rounds = max(1, ((nch + cs - 1) / cs + a.slots - 1) / a.slots);
  const int ncache = min(nk, a.cache);
  // The job stream through the ring, in the order the passes consume it:
  // pass 1 the K tile of each of my chunks; pass 2 the K tiles of the
  // uncached ones; pass 3 the V tile of each, after its K if uncached.
  const int n1 = nk, n2 = nk - ncache;
  const int njobs = n1 + n2 + ncache + 2 * (nk - ncache);

  // this thread's share of a 16-byte-copied tile: rows kk0, kk0 + kstep,
  // ... at element d0 (when a row's pieces divide the threads)
  const int per = dp / VK;  // 16-byte pieces a K/V row
  const bool even = a.vec && kThreads % per == 0;
  const int kstep = even ? kThreads / per : 0;
  const int kk0 = even ? tid / per : 0, d0 = even ? (tid % per) * VK : 0;
  const int64_t kvrow = static_cast<int64_t>(a.KV) * dh;  // one position
  const int64_t vbase = (static_cast<int64_t>(b) * Sv * a.KV + kvh) * dh;
  const int64_t nbase =
      (static_cast<int64_t>(b) * a.T * a.KV + kvh) * dh - pb * kvrow;

  auto src_row = [&](bool is_v, int j) -> const KT* {
    if (a.k_new != nullptr && j >= pb && j < pb + a.T)
      return static_cast<const KT*>(is_v ? a.v_new : a.k_new) + nbase +
             j * kvrow;
    return static_cast<const KT*>(is_v ? a.v : a.k) + vbase + j * kvrow;
  };

  auto issue = [&](int job) {  // job into ring slot job % ST
    if (job >= njobs) return;
    KT* dst = ring + (job % ST) * C * pitch;
    bool is_v = false;
    int i = job;
    if (job >= n1 + n2) {
      const int c3 = job - n1 - n2;
      if (c3 < ncache) {
        is_v = true;
        i = c3;
      } else {
        i = ncache + (c3 - ncache) / 2;
        is_v = (c3 - ncache) % 2;
      }
    } else if (job >= n1) {
      i = ncache + job - n1;
    }
    const int j0 = (cf + i * cs + rank) * C;
    if (even) {
      for (int kk = kk0; kk < C; kk += kstep) {
        const int j = j0 + kk;
        const bool in = j < Sv && d0 < dh;
        cp_async16(dst + kk * pitch + d0,
                   in ? static_cast<const void*>(src_row(is_v, j) + d0) : a.k,
                   in ? 16 : 0);
      }
    } else if (a.vec) {
      for (int p = tid; p < C * per; p += kThreads) {
        const int kk = p / per, d = (p % per) * VK, j = j0 + kk;
        const bool in = j < Sv && d < dh;
        cp_async16(dst + kk * pitch + d,
                   in ? static_cast<const void*>(src_row(is_v, j) + d) : a.k,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < C * dp; e += kThreads) {
        const int kk = e / dp, d = e % dp, j = j0 + kk;
        dst[kk * pitch + d] =
            j < Sv && d < dh ? src_row(is_v, j)[d] : from_f<KT>(0.f);
      }
    }
  };

  // q of the tile's rows (zeros past them), in the first copy group; f32
  // q over bf16 K/V lands in the partials' space first, to be split
  const T* q = static_cast<const T*>(a.q);
  auto q_row = [&](int i) {
    return q + ((static_cast<int64_t>(b) * a.T + t0 + i / G) * a.H +
                kvh * G + i % G) * dh;
  };
  T* qdst = kSplit ? reinterpret_cast<T*>(part) : qs;
  const int qpitch = kSplit ? pp : pitch;  // within one partial slot
  if (a.vec) {
    const int perq = dp / VQ;
    for (int p = tid; p < R * perq; p += kThreads) {
      const int i = p / perq, d = (p % perq) * VQ;
      const bool in = i < nrows && d < dh;
      cp_async16(qdst + i * qpitch + d,
                 in ? static_cast<const void*>(q_row(i) + d) : a.q,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < R * dp; e += kThreads) {
      const int i = e / dp, d = e % dp;
      qdst[i * qpitch + d] =
          i < nrows && d < dh ? q_row(i)[d] : from_f<T>(0.f);
    }
  }
  cp_async_commit();
  // the first jobs in flight before anything else
  for (int j = 0; j < ST - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  int job = 0;
  // wait for the next job's tile, put the one ST - 1 later in flight into
  // the slot all threads have finished with, and return the tile
  auto next = [&]() -> const KT* {
    cp_async_wait<ST - 2>();
    __syncthreads();
    issue(job + ST - 1);
    cp_async_commit();
    return ring + (job++ % ST) * C * pitch;
  };

  for (int i = tid; i < R; i += kThreads) {
    int lo = 1, hi = 0;  // a padding row: no keys
    if (i < nrows) {
      const int pe = pb + t0 + i / G;
      hi = min(pe, Sv - 1);
      lo = a.window > 0 ? max(0, pe - a.window + 1) : 0;
    }
    rlo[i] = lo;
    rhi[i] = hi;
  }
  cp_async_wait<ST - 1>();  // q; the jobs stay in flight
  __syncthreads();
  if constexpr (kSplit) {
    for (int e = tid; e < R * dp; e += kThreads) {
      const int i = e / dp, d = e % dp;
      split3(to_f(qdst[i * qpitch + d]), qpl + i * pitch + d,
             qpl + (R + i) * pitch + d, qpl + (2 * R + i) * pitch + d);
    }
    __syncthreads();
  }
  // this thread's rows: their key ranges
  int my_lo[MT][2], my_hi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      my_lo[mt][h] = rlo[mt * 16 + g + 8 * h];
      my_hi[mt][h] = rhi[mt * 16 + g + 8 * h];
    }
  auto live = [&](int mt, int h, int j) {
    return j >= my_lo[mt][h] && j <= my_hi[mt][h];
  };

  auto slot = [&](int i) { return sc + i * R * SP; };
  auto key = [&](int n, int u) { return 8 * (NT * warp + n) + 2 * t4 + u; };
  auto at = [&](int mt, int h, int n, int u) {  // this thread's (row, key)
    return (mt * 16 + g + 8 * h) * SP + key(n, u);
  };

  // s = round_t(round_t(q . k) / scale) of every (row, key) of chunk c
  // into s, in this thread's places; with `mx`, each row's max over its
  // keys of the chunk folded into the running max of this thread's rows
  float wmax[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmax[mt][0] = wmax[mt][1] = -INFINITY;
  auto scores = [&](const KT* kt, T* s, int c, bool mx) {
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    if constexpr (kMma) {
      // warp w: keys 8 (NT w + n) .. + 7 of the chunk for every 16-row
      // tile, d in k16 steps in turn, each step q's planes in turn
      const __nv_bfloat16* qb =
          kSplit ? qpl : reinterpret_cast<const __nv_bfloat16*>(qs);
      for (int ks = 0; ks < dp / 16; ++ks) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ldmatrix_x2(bf[n], kt + (8 * (NT * warp + n) + (lane & 7)) * pitch +
                                 16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t af[4];
            ldmatrix_x4(af, qb + (pl * R + mt * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * pitch +
                                16 * ks + (lane >> 4) * 8);
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(acc[mt][n], af, bf[n]);
          }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (my_lo[mt][e >> 1] > my_hi[mt][e >> 1]) continue;  // no keys
            const T* qr = qs + (mt * 16 + g + 8 * (e >> 1)) * pitch;
            const KT* kr = kt + key(n, e & 1) * pitch;
            float x = 0.f;
            for (int d = 0; d < dh; ++d) x = fmaf(qr[d], kr[d], x);
            acc[mt][n][e] = x;
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, u = e & 1;
          if (my_lo[mt][h] > my_hi[mt][h]) continue;  // a row with no keys
          const float v = round_t<T>(round_t<T>(acc[mt][n][e]) / a.scale);
          s[at(mt, h, n, u)] = from_f<T>(v);
          if (mx && live(mt, h, c * C + key(n, u)))
            wmax[mt][h] = fmaxf(wmax[mt][h], v);
        }
    // no barrier: each thread reads back only the scores it wrote, until
    // the next job's barrier (p . v reads every thread's p after it)
  };

  // pass 1: scores and the rows' maxes
  for (int i = 0; i < nk; ++i)
    scores(next(), slot(i < ncache ? i : a.cache), cf + i * cs + rank, true);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = wmax[mt][h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t4 == 0) wsc[warp * WP + mt * 16 + g + 8 * h] = m;
    }
  __syncthreads();
  for (int row = tid; row < R; row += kThreads) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wsc[w * WP + row]);
    lmax[row] = m;
  }
  cluster.sync();  // every CTA's lmax final
  for (int row = tid; row < R; row += kThreads) {
    float m = -INFINITY;
    for (int r = 0; r < cs; ++r)
      m = fmaxf(m, *cluster.map_shared_rank(lmax + row, r));
    rmax[row] = m;
  }
  __syncthreads();
  float my_m[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) my_m[mt][h] = rmax[mt * 16 + g + 8 * h];

  // pass 2: each chunk's exp sum of each row: per 8-key group the thread
  // adds its keys 2 t4 and 2 t4 + 1, the quad a butterfly; then the
  // C / 8 groups in order
  for (int i = 0; i < nk; ++i) {
    const int c = cf + i * cs + rank;
    T* s = slot(i < ncache ? i : a.cache);
    float* ws = wsc + (i & 1) * (C / 8) * WP;
    if (i >= ncache) scores(next(), s, c, false);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float e = 0.f;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (live(mt, h, c * C + key(n, u)))
              e += expf(to_f(s[at(mt, h, n, u)]) - my_m[mt][h]);
          e += __shfl_xor_sync(0xffffffffu, e, 1);
          e += __shfl_xor_sync(0xffffffffu, e, 2);
          if (t4 == 0) ws[(NT * warp + n) * WP + mt * 16 + g + 8 * h] = e;
        }
    __syncthreads();  // the buffer is written again two chunks on
    for (int row = tid; row < R; row += kThreads) {
      float x = ws[row];
#pragma unroll
      for (int grp = 1; grp < C / 8; ++grp) x += ws[grp * WP + row];
      csum[i * R + row] = x;
    }
  }
  __syncthreads();
  cluster.sync();  // every CTA's chunk sums final
  // each row's sum over its own chunks in ascending order: the CTA
  // gathers 32 chunks' sums of every row at a time into the spare score
  // slot, then a thread a row adds its own in turn
  {
    float* gath = reinterpret_cast<float*>(slot(a.cache));  // [R][33]
    const bool has = tid < R && rlo[tid % R] <= rhi[tid % R];
    const int r0 = has ? rlo[tid] / C - cf : 0;
    const int r1 = has ? rhi[tid] / C - cf : -1;
    float total = 0.f;
    for (int gb = 0; gb < nch; gb += 32) {
      constexpr int NG = R * 32 / kThreads;  // every load in flight at once
      float x[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int e = tid + k * kThreads, gg = gb + e % 32;
        x[k] = gg < nch ? *cluster.map_shared_rank(
                              csum + (gg / cs) * R + e / 32, gg % cs)
                        : 0.f;
      }
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int e = tid + k * kThreads;
        gath[(e / 32) * 33 + e % 32] = x[k];
      }
      __syncthreads();
      const int lo = max(r0, gb), hi = min(r1, gb + 31);
#pragma unroll 8
      for (int gg = lo; gg <= hi; ++gg) total += gath[tid * 33 + gg - gb];
      __syncthreads();
    }
    if (tid < R) rsum[tid] = total;
  }
  __syncthreads();
  float my_sum[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) my_sum[mt][h] = rsum[mt * 16 + g + 8 * h];

  // pass 3 in rounds of `slots` chunks a CTA: p . v partials, then the
  // cluster's partials of the round added in chunk order
  T* out = static_cast<T*>(a.out);
  for (int qr = 0; qr < rounds; ++qr) {
    const int i0 = qr * a.slots, i1 = min(nk, i0 + a.slots);
    for (int i = i0; i < i1; ++i) {
      const int c = cf + i * cs + rank;
      T* s = slot(i < ncache ? i : a.cache);
      if (i >= ncache) scores(next(), s, c, false);
      // p's planes are one buffer for every chunk: no warp may still be
      // reading the last chunk's (a recomputed chunk's next() waited too)
      if (kSplit && i > i0 && i < ncache) __syncthreads();
      // p in place of s (0 off the row's keys and on padding rows)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float p = 0.f;
              if (live(mt, h, c * C + key(n, u)))
                p = round_t<T>(expf(to_f(s[at(mt, h, n, u)]) - my_m[mt][h]) /
                               my_sum[mt][h]);
              s[at(mt, h, n, u)] = from_f<T>(p);
              if constexpr (kSplit) {
                const int o = at(mt, h, n, u);
                split3(p, ppl + o, ppl + R * SP + o, ppl + 2 * R * SP + o);
              }
            }
      const KT* vt = next();  // its __syncthreads publishes p
      float* po = part + (i - i0) * R * pp;
      if constexpr (kMma) {
        // warp w: dims 8 nt .. 8 nt + 7 for nt = w, w + kWarps, ...; keys
        // in k16 steps in turn, each step p's planes in turn
        const __nv_bfloat16* pb_ =
            kSplit ? ppl : reinterpret_cast<const __nv_bfloat16*>(s);
        for (int nt = warp; nt < dp / 8; nt += kWarps) {
          float acc[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < C / 16; ++ks) {
            uint32_t bf[2];
            ldmatrix_x2_trans(
                bf, vt + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             pitch + 8 * nt);
#pragma unroll
            for (int pl = 0; pl < NP; ++pl)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                uint32_t af[4];
                ldmatrix_x4(af, pb_ + (pl * R + mt * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * SP +
                                    16 * ks + (lane >> 4) * 8);
                mma_bf16(acc[mt], af, bf);
              }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(po + (mt * 16 + g + 8 * h) * pp +
                                         8 * nt + 2 * t4) =
                  make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);
        }
      } else {
        for (int e = tid; e < R * dp; e += kThreads) {
          const int row = e / dp, d = e % dp;
          float acc = 0.f;
          for (int kk = 0; kk < C; ++kk)
            acc = fmaf(s[row * SP + kk], vt[kk * pitch + d], acc);
          po[row * pp + d] = acc;
        }
      }
    }
    cluster.sync();  // the round's partials final
    // CTA `rank` adds 4-dim groups (tid + k * kThreads) * cs + rank of the
    // tile's (row, dim) outputs (dealt across the cluster, so that no one
    // SM reads every partial) over the round's chunks in order, sixteen
    // 16-byte loads in flight at a time
    const int g_lo = qr * a.slots * cs;
    const int g_hi = min(nch, (qr + 1) * a.slots * cs) - 1;
    const bool last = qr == rounds - 1;
    int k = 0;
    for (int e = tid * cs + rank; e < nrows * (dp / 4);
         e += kThreads * cs, ++k) {
      const int row = e / (dp / 4), d = 4 * (e % (dp / 4));
      float4 acc = qr ? reinterpret_cast<const float4*>(accs)[k * kThreads +
                                                              tid]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      if (rlo[row] <= rhi[row]) {
        const int g0 = max(g_lo, rlo[row] / C - cf);
        const int g1 = min(g_hi, rhi[row] / C - cf);
        const int off = row * pp + d - qr * a.slots * R * pp;
        int r = g0 % cs, ii = g0 / cs;  // owner and its chunk index
        for (int gb = g0; gb <= g1; gb += 16) {
          float4 x[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            x[u] = gb + u <= g1
                       ? *reinterpret_cast<const float4*>(
                             cluster.map_shared_rank(part, r) + ii * R * pp +
                             off)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
            if (++r == cs) {
              r = 0;
              ++ii;
            }
          }
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (gb + u <= g1) {
              acc.x += x[u].x;
              acc.y += x[u].y;
              acc.z += x[u].z;
              acc.w += x[u].w;
            }
        }
      }
      if (last) {
        T* o = out + ((static_cast<int64_t>(b) * a.T + t0 + row / G) * a.H +
                      kvh * G + row % G) * dh;
        const float v4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (d + u < dh) o[d + u] = from_f<T>(v4[u]);
      } else {
        reinterpret_cast<float4*>(accs)[k * kThreads + tid] = acc;
      }
    }
    cluster.sync();  // no partial is overwritten or freed while read
  }
  cp_async_wait<0>();

  // the zero-padding heads of the tile's tokens, by the kv head 0 tiles
  const int hz = a.H - a.h_true;
  if (kvh == 0 && hz > 0) {
    for (int e = rank * kThreads + tid; e < tn * hz * dh; e += cs * kThreads) {
      const int t = t0 + e / (hz * dh), h = a.h_true + (e / dh) % hz;
      out[((static_cast<int64_t>(b) * a.T + t) * a.H + h) * dh + e % dh] =
          from_f<T>(0.f);
    }
  }
}

template <typename T, typename KT, int MT, int DP>
cudaError_t launch(const Args& a, int device, int grid, cudaStream_t st) {
  auto kern = decode_attention_kernel<T, KT, MT, DP>;
  // the shared memory this kernel may take on each device, raised (a host
  // call that costs more than the launch) only when a plan needs more
  static int allowed[64] = {};
  cudaError_t err = cudaSuccess;
  if (device >= 64 || a.lay.total > allowed[device]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.lay.total);
    if (err != cudaSuccess) return err;
    if (device < 64) allowed[device] = a.lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(cta_threads(sizeof(KT)));
  cfg.dynamicSmemBytes = static_cast<size_t>(a.lay.total);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename KT, int DP>
cudaError_t dispatch_mt(const Args& a, int m_tiles, int device, int grid,
                        cudaStream_t st) {
  switch (m_tiles) {
    case 1: return launch<T, KT, 1, DP>(a, device, grid, st);
    case 2: return launch<T, KT, 2, DP>(a, device, grid, st);
    case 3: return launch<T, KT, 3, DP>(a, device, grid, st);
    default: return launch<T, KT, 4, DP>(a, device, grid, st);
  }
}

template <typename T, typename KT>
cudaError_t dispatch(const Args& a, int m_tiles, int device, int grid,
                     cudaStream_t st) {
  return a.lay.dh_pad == 128
             ? dispatch_mt<T, KT, 128>(a, m_tiles, device, grid, st)
             : dispatch_mt<T, KT, 0>(a, m_tiles, device, grid, st);
}

}  // namespace

extern "C" {

// Dynamic shared memory, bytes, of a launch with this plan.
int decode_attention_smem(int q_elt, int kv_elt, int m_tiles, int dh, int sv,
                          int cluster, int cache, int slots) {
  return make_layout(q_elt, kv_elt, m_tiles, dh, sv, cluster, cache, slots)
      .total;
}

// Keys per chunk over K/V of kv_elt bytes.
int decode_attention_chunk_keys(int kv_elt) { return chunk_keys(kv_elt); }

// out (B, T, H, dh) = attention of q (B, T, H, dh) over the views k, v
// (B, Sv, KV, dh), with the keys at pos[b] .. pos[b] + T - 1 taken from
// k_new, v_new (B, T, KV, dh) when they are not null; all contiguous; q
// and out bf16 (q_bf16) or f32; k, v, k_new, v_new bf16 (kv_bf16) or f32,
// not f32 under bf16 q; pos (B,) int32 (int64 with pos64) on the device.
// Heads h >= h_true write zeros; h_true must be a multiple of kv with
// h_true / kv <= 16; dh <= 256. The plan: `tokens` query tokens a tile,
// clusters of `cluster` CTAs, `cache` chunks of scores and `slots` chunk
// partials a CTA. Returns the cudaError_t of the launch (0 = ok).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* k_new, const void* v_new, void* out,
                            const void* pos, int B, int T_, int H,
                            int h_true, int KV, int Sv, int dh, int window,
                            float scale, int q_bf16, int kv_bf16, int pos64,
                            int tokens,
                            int cluster, int cache, int slots, int device,
                            void* stream) {
  if (dh <= 0 || dh > kMaxDh || KV <= 0 || h_true <= 0 || h_true % KV != 0 ||
      h_true / KV > kMaxGroup || h_true > H || Sv <= 0 || tokens <= 0 ||
      cluster <= 0 || cluster > kMaxCluster || cache < 0 || slots <= 0 ||
      (k_new == nullptr) != (v_new == nullptr) || (q_bf16 && !kv_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = h_true / KV;
  const int m_tiles = (G * tokens + 15) / 16;
  const int q_elt = q_bf16 ? 2 : 4, kv_elt = kv_bf16 ? 2 : 4;
  if (m_tiles > kMaxMTiles) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.lay = make_layout(q_elt, kv_elt, m_tiles, dh, Sv, cluster, cache, slots);
  if (a.lay.total > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(B) * T_ * H == 0) return 0;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_new = k_new;
  a.v_new = v_new;
  a.out = out;
  a.pos = pos;
  a.T = T_;
  a.H = H;
  a.h_true = h_true;
  a.KV = KV;
  a.Sv = Sv;
  a.dh = dh;
  a.window = window;
  a.group = G;
  a.tokens = tokens;
  a.n_tt = (T_ + tokens - 1) / tokens;
  a.cluster = cluster;
  a.cache = cache;
  a.slots = slots;
  a.pos64 = pos64;
  a.scale = scale;
  bool vec = dh % 8 == 0;  // rows of whole 16-byte pieces in either type
  for (const void* p : {q, k, v, k_new, v_new})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  a.vec = vec;
  const int64_t grid = static_cast<int64_t>(B) * KV * a.n_tt * cluster;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g32 = static_cast<int>(grid);
  if (q_bf16)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(a, m_tiles, device, g32, st);
  else if (kv_bf16)
    err = dispatch<float, __nv_bfloat16>(a, m_tiles, device, g32, st);
  else
    err = dispatch<float, float>(a, m_tiles, device, g32, st);
  return static_cast<int>(err);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
