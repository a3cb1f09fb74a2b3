// Paged decode / verify attention for Hopper (sm_90a): every sum in an
// order fixed by the query row alone.
//
// Computes the attention of the paged decode and speculative verify pass
// (repro_torch.models.layers.decode_attention_multi; the reference leaves
// it to XLA: src/repro/models/layers.py:281, attention_scores :110). There
// is no Pallas kernel behind it: the port writes it by hand so that a query
// row's output depends on nothing but its own inputs. Row (b, t, h) at
// position pe = pos[b] + t attends keys lo..hi of its kv head
// kvh = h / G (G = H_true / KV), with hi = min(pe, Sv - 1) and
// lo = max(0, pe - window + 1) for a sliding window (0 = full); heads
// h >= H_true are zero padding and write zeros, as the zero-padded K/V of
// _expand_kv give. In f32, with round_t the rounding to the input type T
// (f32 or bf16):
//   s_j = round_t(round_t(q . k_j) / scale)     scale = round_t(sqrt(dh))
//   e_j = exp(s_j - max_j s_j),   p_j = round_t(e_j / sum_j e_j)
//   out = round_t(sum_j p_j v_j)
// which is the plain version's arithmetic (kernels/decode_attention.py),
// with the sums in another order.
//
// Why by hand. A speculative verify pass scores T tokens of a row at once
// and must give each position exactly what T one-token decode steps give,
// or the accepted tokens would differ from plain decoding. A library
// product picks its reduction split from the problem's shape, so the sums
// of a row change with T and with the gathered view's length. Here every
// sum has one order for a row whatever T, B, H or Sv are: the order
// depends on the row's own lo..hi only, and keys past hi are never read, so
// a longer view changes nothing. Each q . k runs over d = 0..dh-1 in turn.
// A row takes one of two forms, chosen by its own hi alone, so a verify
// position and the one-token step at that position always take the same:
//
// Short rows (hi < kChunk: every key in chunk 0) run in one launch, one
// block a row (decode_attention_short): thread i takes key lo + i; the exp
// sum is one fixed tree over the threads; p . v runs in warp w over keys
// lo+w, lo+w+8, ... with lane l over dims l, l+32, ..., and the warps'
// partial sums add in warp order. Padded heads write zeros here, for every
// row.
//
// Long rows cut their keys into chunks of kChunk by ABSOLUTE position
// (chunk c holds keys c*kChunk .. c*kChunk + kChunk - 1) and run in four
// more launches, each over blocks (group, chunk) where a group is
// (b, t, kvh) and holds the G heads that share a kv head, so every K and V
// row a block loads serves all G heads; launched only when the view is
// longer than a chunk:
//   1. scores: thread i takes key c*kChunk + i, computes its G scores
//      (q of the G heads in shared memory as f32, k loaded 16 bytes at a
//      time when aligned) into the f32 scratch row of each head, and each
//      head's chunk max;
//   2. exp: the row max over the chunk maxes (exact in any order), e_j back
//      into the scratch, each head's chunk sum;
//   3. p . v: each head's sum over its chunk sums in chunk order, p_j into
//      shared memory, and the chunk's partial p . v, keys in turn, for
//      every (head, dim) of the group;
//   4. reduce: each (row, dim) adds its chunk partials in chunk order and
//      rounds.
//
// What bounds it: bytes. Every unmasked K and V row is read once per head
// (short rows) or once per chunk block (long rows: all G heads use it), q
// is read once and the output written once; 4 dh FLOPs per (row, key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // keys per chunk: one a thread in pass 1
constexpr int kMaxDh = 256;
constexpr int kMaxGroup = 16;  // heads sharing one kv head
constexpr int kMaxOut = kMaxGroup * kMaxDh / kThreads;  // pass 3, a thread

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

// one (b, t) row pair's geometry, the same in every pass
struct Rows {
  int b, t, kvh, lo, hi, c0, c1;
};

__device__ __forceinline__ Rows rows_of(int group, const int* pos, int T_,
                                        int KV, int Sv, int window) {
  Rows r;
  r.kvh = group % KV;
  r.t = (group / KV) % T_;
  r.b = group / (KV * T_);
  const int pe = pos[r.b] + r.t;
  r.hi = min(pe, Sv - 1);
  r.lo = window > 0 ? max(0, pe - window + 1) : 0;
  r.c0 = r.lo / kChunk;
  r.c1 = r.hi / kChunk;
  return r;
}

// index of head h's output row
__device__ __forceinline__ int64_t out_row(const Rows& r, int T_, int H,
                                           int h) {
  return (static_cast<int64_t>(r.b) * T_ + r.t) * H + h;
}

// the block's sum of v in one fixed tree: a butterfly in each warp (every
// lane ends with the same value), then the warps in order
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x / 32;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = red[0];
  for (int i = 1; i < kWarps; ++i) s += red[i];
  return s;
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x / 32;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  return m;
}

// q . k over d = 0..dh-1 in turn; 16-byte loads of k when `vec` holds
template <typename T>
__device__ __forceinline__ float dot_row(const float* qs, const T* k, int dh,
                                         bool vec) {
  float acc = 0.f;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const uint4* k4 = reinterpret_cast<const uint4*>(k);
    for (int c = 0; c < dh / V; ++c) {
      const uint4 raw = __ldg(k4 + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u)
        acc = fmaf(qs[c * V + u], to_f(e[u]), acc);
    }
  } else {
    for (int d = 0; d < dh; ++d) acc = fmaf(qs[d], to_f(k[d]), acc);
  }
  return acc;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* scores;   // (B*T*H, Sv)
  float* cmax;     // (B*T*H, NC)
  float* csum;     // (B*T*H, NC)
  float* partial;  // (B*T*H, NC, dh)
  const int* pos;
  int T, H, h_true, KV, Sv, dh, window, nc, group_size;
  float scale;
  bool vec;
};

// a short row (and every padded head), one block a row
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_short(Args a) {
  __shared__ float qs[kMaxDh];
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][kMaxDh];
  const int64_t row = blockIdx.x;  // ((b * T + t) * H + h)
  const int h = static_cast<int>(row % a.H);
  const int t = static_cast<int>((row / a.H) % a.T);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.H) * a.T));
  const int dh = a.dh;
  T* o = static_cast<T*>(a.out) + row * dh;
  if (h >= a.h_true) {
    for (int d = threadIdx.x; d < dh; d += kThreads) o[d] = from_f<T>(0.f);
    return;
  }
  const Rows r = rows_of((b * a.T + t) * a.KV + h / a.group_size, a.pos,
                         a.T, a.KV, a.Sv, a.window);
  if (r.c1 > 0) return;  // a long row
  const int64_t stride = static_cast<int64_t>(a.KV) * dh;  // one position
  const int64_t base = (static_cast<int64_t>(b) * a.Sv * a.KV + r.kvh) * dh;
  const T* kb = static_cast<const T*>(a.k) + base;
  const T* vb = static_cast<const T*>(a.v) + base;
  float* sc = a.scores + row * a.Sv;
  const T* qr = static_cast<const T*>(a.q) + row * dh;
  for (int d = threadIdx.x; d < dh; d += kThreads) qs[d] = to_f(qr[d]);
  __syncthreads();
  // scores and their max (at most one key a thread: hi < kChunk)
  float m = -INFINITY;
  for (int j = r.lo + threadIdx.x; j <= r.hi; j += kThreads) {
    const float s = round_t<T>(
        round_t<T>(dot_row(qs, kb + j * stride, dh, a.vec)) / a.scale);
    sc[j - r.lo] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);
  float sum = 0.f;
  for (int j = r.lo + threadIdx.x; j <= r.hi; j += kThreads) {
    const float e = expf(sc[j - r.lo] - m);
    sc[j - r.lo] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its __syncthreads publishes the e_j
  // p . v: warp w over keys lo+w, lo+w+8, ..., lane l over dims l, l+32, ...
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  float acc[kMaxDh / 32];
#pragma unroll
  for (int c = 0; c < kMaxDh / 32; ++c) acc[c] = 0.f;
  for (int j = r.lo + w; j <= r.hi; j += kWarps) {
    const float p = round_t<T>(sc[j - r.lo] / sum);
    const T* vr = vb + j * stride;
#pragma unroll
    for (int c = 0; c < kMaxDh / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) acc[c] = fmaf(p, to_f(vr[d]), acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxDh / 32; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) part[w][d] = acc[c];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float s = part[0][d];
    for (int i = 1; i < kWarps; ++i) s += part[i][d];
    o[d] = from_f<T>(s);
  }
}

// The passes take the group size G_ and head width DH_ as template
// arguments where the model's are known (0 = read them from Args), so that
// their loops unroll and their index arithmetic folds.

// pass 1: the G heads' scores of one chunk, and each head's chunk max
template <typename T, int G_, int DH_>
__global__ void __launch_bounds__(kThreads) decode_attention_scores(Args a) {
  extern __shared__ float smem[];  // qs[G][dh]
  __shared__ float red[kWarps];
  const Rows r = rows_of(blockIdx.x, a.pos, a.T, a.KV, a.Sv, a.window);
  const int c = blockIdx.y;
  // a short row runs in decode_attention_short
  if (r.c1 == 0 || c < r.c0 || c > r.c1) return;
  constexpr int NG = G_ ? G_ : kMaxGroup;
  const int G = G_ ? G_ : a.group_size, dh = DH_ ? DH_ : a.dh;
  float* qs = smem;
  const T* q = static_cast<const T*>(a.q);
  const int h0 = r.kvh * G;
  for (int i = threadIdx.x; i < G * dh; i += kThreads)
    qs[i] = to_f(q[out_row(r, a.T, a.H, h0 + i / dh) * dh + i % dh]);
  __syncthreads();
  const int j = c * kChunk + threadIdx.x;
  const bool live = j >= r.lo && j <= r.hi;
  float acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.f;
  if (live) {
    const T* kr = static_cast<const T*>(a.k) +
                  ((static_cast<int64_t>(r.b) * a.Sv + j) * a.KV + r.kvh) *
                      dh;
    if (a.vec) {
      constexpr int V = 16 / sizeof(T);
      const uint4* k4 = reinterpret_cast<const uint4*>(kr);
#pragma unroll 4
      for (int cc = 0; cc < dh / V; ++cc) {
        const uint4 raw = __ldg(k4 + cc);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float kv = to_f(e[u]);
          const int d = cc * V + u;
#pragma unroll
          for (int g = 0; g < NG; ++g)
            if (G_ || g < G) acc[g] = fmaf(qs[g * dh + d], kv, acc[g]);
        }
      }
    } else {
      for (int d = 0; d < dh; ++d) {
        const float kv = to_f(kr[d]);
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (G_ || g < G) acc[g] = fmaf(qs[g * dh + d], kv, acc[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (!G_ && g >= G) break;
    const int64_t row = out_row(r, a.T, a.H, h0 + g);
    float s = -INFINITY;
    if (live) {
      s = round_t<T>(round_t<T>(acc[g]) / a.scale);
      a.scores[row * a.Sv + j] = s;
    }
    s = block_max(s, red);
    if (threadIdx.x == 0) a.cmax[row * a.nc + c] = s;
  }
}

// pass 2: e_j = exp(s_j - the row max) and each head's chunk sum
template <typename T, int G_, int DH_>
__global__ void __launch_bounds__(kThreads) decode_attention_exp(Args a) {
  __shared__ float red[kWarps];
  const Rows r = rows_of(blockIdx.x, a.pos, a.T, a.KV, a.Sv, a.window);
  const int c = blockIdx.y;
  // a short row runs in decode_attention_short
  if (r.c1 == 0 || c < r.c0 || c > r.c1) return;
  const int j = c * kChunk + threadIdx.x;
  const bool live = j >= r.lo && j <= r.hi;
  for (int g = 0; g < a.group_size; ++g) {
    const int64_t row = out_row(r, a.T, a.H, r.kvh * a.group_size + g);
    float m = -INFINITY;
    for (int cc = r.c0; cc <= r.c1; ++cc)
      m = fmaxf(m, a.cmax[row * a.nc + cc]);
    float e = 0.f;
    if (live) {
      e = expf(a.scores[row * a.Sv + j] - m);
      a.scores[row * a.Sv + j] = e;
    }
    e = block_sum(e, red);
    if (threadIdx.x == 0) a.csum[row * a.nc + c] = e;
  }
}

// pass 3: p_j and the chunk's partial p . v of every (head, dim)
template <typename T, int G_, int DH_>
__global__ void __launch_bounds__(kThreads) decode_attention_pv(Args a) {
  extern __shared__ float smem[];  // ps[G][kChunk]
  const Rows r = rows_of(blockIdx.x, a.pos, a.T, a.KV, a.Sv, a.window);
  const int c = blockIdx.y;
  // a short row runs in decode_attention_short
  if (r.c1 == 0 || c < r.c0 || c > r.c1) return;
  constexpr bool kFixed = G_ && DH_;
  constexpr int NOUT =
      kFixed ? (G_ * DH_ + kThreads - 1) / kThreads : kMaxOut;
  const int G = G_ ? G_ : a.group_size, dh = DH_ ? DH_ : a.dh;
  const int h0 = r.kvh * G;
  const int j0 = max(c * kChunk, r.lo), j1 = min(c * kChunk + kChunk - 1,
                                                  r.hi);
  float* ps = smem;
  for (int g = 0; g < G; ++g) {
    const int64_t row = out_row(r, a.T, a.H, h0 + g);
    float denom = 0.f;
    for (int cc = r.c0; cc <= r.c1; ++cc) denom += a.csum[row * a.nc + cc];
    const int j = c * kChunk + threadIdx.x;
    if (j >= j0 && j <= j1)
      ps[g * kChunk + threadIdx.x] =
          round_t<T>(a.scores[row * a.Sv + j] / denom);
  }
  __syncthreads();
  const T* vb = static_cast<const T*>(a.v) +
                (static_cast<int64_t>(r.b) * a.Sv * a.KV + r.kvh) * dh;
  const int64_t stride = static_cast<int64_t>(a.KV) * dh;
  float acc[NOUT];
#pragma unroll
  for (int m = 0; m < NOUT; ++m) acc[m] = 0.f;
  // unrolled so that the V loads of several keys are in flight at once;
  // each accumulator still adds its keys in turn
#pragma unroll 8
  for (int j = j0; j <= j1; ++j) {
    const T* vr = vb + j * stride;
    const int jj = j - c * kChunk;
#pragma unroll
    for (int m = 0; m < NOUT; ++m) {
      const int o = threadIdx.x + m * kThreads;
      if (o < G * dh)
        acc[m] = fmaf(ps[(o / dh) * kChunk + jj], to_f(vr[o % dh]), acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < NOUT; ++m) {
    const int o = threadIdx.x + m * kThreads;
    if (o < G * dh) {
      const int64_t row = out_row(r, a.T, a.H, h0 + o / dh);
      a.partial[(row * a.nc + c) * dh + o % dh] = acc[m];
    }
  }
}

// pass 4: each (row, dim) over its chunk partials in chunk order
template <typename T, int G_, int DH_>
__global__ void __launch_bounds__(kThreads) decode_attention_reduce(Args a) {
  const int64_t row = blockIdx.x;  // ((b * T + t) * H + h)
  const int h = static_cast<int>(row % a.H);
  const int t = static_cast<int>((row / a.H) % a.T);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.H) * a.T));
  T* o = static_cast<T*>(a.out) + row * a.dh;
  if (h >= a.h_true) return;  // written by decode_attention_short
  const Rows r = rows_of((b * a.T + t) * a.KV + h / a.group_size, a.pos, a.T,
                         a.KV, a.Sv, a.window);
  if (r.c1 == 0) return;  // a short row
  for (int d = threadIdx.x; d < a.dh; d += kThreads) {
    float s = 0.f;
    for (int c = r.c0; c <= r.c1; ++c)
      s += a.partial[(row * a.nc + c) * a.dh + d];
    o[d] = from_f<T>(s);
  }
}

template <typename T, int G_, int DH_>
cudaError_t launch(Args a, int B, cudaStream_t st) {
  decode_attention_short<T>
      <<<static_cast<unsigned>(B * a.T * a.H), kThreads, 0, st>>>(a);
  if (a.nc == 1) return cudaGetLastError();  // every row is short
  const dim3 grid(static_cast<unsigned>(B * a.T * a.KV),
                  static_cast<unsigned>(a.nc));
  const size_t q_smem = sizeof(float) * a.group_size * a.dh;
  const size_t p_smem = sizeof(float) * a.group_size * kChunk;
  decode_attention_scores<T, G_, DH_><<<grid, kThreads, q_smem, st>>>(a);
  decode_attention_exp<T, G_, DH_><<<grid, kThreads, 0, st>>>(a);
  decode_attention_pv<T, G_, DH_><<<grid, kThreads, p_smem, st>>>(a);
  decode_attention_reduce<T, G_, DH_>
      <<<static_cast<unsigned>(B * a.T * a.H), 128, 0, st>>>(a);
  return cudaGetLastError();
}

// yi-6b's shape (8 heads to a kv head, dh 128) on the folded passes, any
// other on the general ones
template <typename T>
cudaError_t dispatch(Args a, int B, cudaStream_t st) {
  if (a.group_size == 8 && a.dh == 128) return launch<T, 8, 128>(a, B, st);
  return launch<T, 0, 0>(a, B, st);
}

}  // namespace

extern "C" {

// Scratch floats the launch needs for (B, T, H, Sv, dh): the scores, the
// chunk maxes and sums, and the chunk partials.
int64_t decode_attention_scratch(int B, int T_, int H, int Sv, int dh) {
  const int64_t rows = static_cast<int64_t>(B) * T_ * H;
  const int64_t nc = (Sv + kChunk - 1) / kChunk;
  return rows * (Sv + 2 * nc + nc * dh);
}

// out (B, T, H, dh) = attention of q (B, T, H, dh) over the views k, v
// (B, Sv, KV, dh), all contiguous and of one type (is_bf16: bf16, else
// f32); pos (B,) int32 on the device; scratch of
// decode_attention_scratch(...) f32. Heads h >= h_true write zeros; h_true
// must be a multiple of kv with h_true / kv <= 16; dh <= 256. Returns the
// cudaError_t of the launches (0 = ok).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, void* scratch, const void* pos, int B,
                            int T_, int H, int h_true, int KV, int Sv, int dh,
                            int window, float scale, int is_bf16, int device,
                            void* stream) {
  if (dh <= 0 || dh > kMaxDh || KV <= 0 || h_true <= 0 || h_true % KV != 0 ||
      h_true / KV > kMaxGroup || h_true > H || Sv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(B) * T_ * H == 0) return 0;
  const int64_t rows = static_cast<int64_t>(B) * T_ * H;
  const int nc = (Sv + kChunk - 1) / kChunk;
  float* s = static_cast<float*>(scratch);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.scores = s;
  a.cmax = s + rows * Sv;
  a.csum = a.cmax + rows * nc;
  a.partial = a.csum + rows * nc;
  a.pos = static_cast<const int*>(pos);
  a.T = T_;
  a.H = H;
  a.h_true = h_true;
  a.KV = KV;
  a.Sv = Sv;
  a.dh = dh;
  a.window = window;
  a.nc = nc;
  a.group_size = h_true / KV;
  a.scale = scale;
  const int elt = is_bf16 ? 2 : 4;
  a.vec = (dh * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = dispatch<__nv_bfloat16>(a, B, st);
  else
    err = dispatch<float>(a, B, st);
  return static_cast<int>(err);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
