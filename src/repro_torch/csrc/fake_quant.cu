// MARS fake quantization for Hopper (sm_90a): eq. 5 and eq. 8, elementwise.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fake_quant.py
// (fake_quant, body _kernel :16). For every element, in f32:
//   unsigned (eq. 5): y = rint(clamp(x, 0, 1) * (2^b - 1)) / 2^b
//   signed   (eq. 8): y = rint(clamp(x, -1, 1) * (2^(b-1) - 1)) / 2^(b-1)
// x is f32 or bf16 and y is f32 or bf16, any pair: a bf16 x widens to f32
// exactly, and a bf16 y is the f32 result rounded to nearest even, so the
// pair computes fake_quant(x.float()).to(y's type) in one pass (the callers
// no longer widen or narrow around it with a separate copy).
//
// Bit-exact with jnp/torch: rintf rounds half to even as jnp.round and
// torch.round do (roundf would round half away from zero); the clamp is
// two compares, so a NaN stays NaN as under jnp.clip / torch.clamp (fminf
// and fmaxf would return the other operand); the level count multiplies
// with __fmul_rn (no contraction), and the division by 2^b is a multiply by
// its exact reciprocal.
//
// The backward (fake_quant_bwd_launch) is the straight-through estimator
// that JAX's autodiff gives the reference's plain jnp (core/quant.py:45-61
// and :111-116; no Pallas kernel has a backward): for every element, in f32,
//   grad_in = ((grad / 2^e) * qmax) * m
// with 2^e and qmax the forward's divisor and level count, and m the
// derivative of the clamp as XLA takes it (jnp.clip = min(max(x, lo), 1),
// each side 1/2 on a tie): in clip mode (eq. 5 activations) m = 1 strictly
// inside (lo, 1), 1/2 exactly on lo or 1, 0 outside and for NaN; in noclip
// mode (eq. 8 weights, which the reference quantizes with no clamp) m = 1
// and x is not read. m multiplies, so an infinite grad outside the range
// gives NaN, as under jax.grad. grad is f32 or bf16 and grad_in takes x's
// type (the bf16 result rounded to nearest even), any pair.
//
// What bounds it: bytes. Each element is read once and written once over
// the 3.35 TB/s of HBM; the five f32 operations per element are far below
// the CUDA cores' rate.
//
// Design. The TPU kernel tiles a padded 2-D view into 256x256 VMEM blocks.
// Here the tensor is one flat array, cut into vectors of V elements (V = 8
// when either side is bf16, else 4), so that every load and store is 16
// bytes wide (a side of 8 f32 moves as two 16-byte halves). Each thread
// keeps kUnroll vectors in flight before it computes, which covers the HBM
// latency; a tensor with fewer vectors than a block's threads per SM
// takes one vector a thread instead. The vectors start where y is 16-byte
// aligned (a tensor from torch.empty always is); the elements before that
// point and after the last whole vector are a scalar head and tail. When x
// is not 16-byte aligned at the same element (a view such as x[1:]), the
// body loads x element by element and still stores 16 bytes. The block
// count comes from the device's SM count, queried once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;         // vectors in flight per thread
constexpr int kBlocksPerSm = 8;    // 2048 threads: a full SM
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Quant {
  float lo, qmax, inv_scale;
  __device__ __forceinline__ float operator()(float v) const {
    v = v < lo ? lo : v;  // compares, not fmaxf/fminf: NaN passes through
    v = v > 1.f ? 1.f : v;
    return rintf(__fmul_rn(v, qmax)) * inv_scale;
  }
};

// V elements of type T as whole 16-byte words
template <typename T, int V>
struct alignas(16) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(Vec<T, V>& out, const T* p,
                                         bool vec_load) {
  if (vec_load) {
    constexpr int kWords = V * (int)sizeof(T) / 16;
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      reinterpret_cast<uint4*>(&out)[w] =
          __ldg(reinterpret_cast<const uint4*>(p) + w);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = p[e];
  }
}

// y[i] = quant(x[i]) over n elements. Vectors cover [head, head + nv * V);
// the scalar head [0, head) and tail [head + nv * V, n) go to the first
// threads of the grid.
template <typename Tin, typename Tout, int V, bool VEC_IN>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, int64_t n,
                  int head, int64_t nv, int unroll, Quant q) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t body_end = head + nv * V;
  if (tid < head) store(y + tid, q(to_f32(x[tid])));
  if (tid < n - body_end)
    store(y + body_end + tid, q(to_f32(x[body_end + tid])));

  const Tin* xb = x + head;
  Tout* yb = y + head;
  // a block takes `unroll` runs of kThreads contiguous vectors a step
  const int64_t per_block = (int64_t)kThreads * unroll;
  for (int64_t base = blockIdx.x * per_block + threadIdx.x; base < nv;
       base += gridDim.x * per_block) {
    Vec<Tin, V> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t vi = base + u * kThreads;
      if (u < unroll && vi < nv) load_vec<Tin, V>(in[u], xb + vi * V, VEC_IN);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t vi = base + u * kThreads;
      if (u >= unroll || vi >= nv) continue;
      Vec<Tout, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) store(&out.v[e], q(to_f32(in[u].v[e])));
      constexpr int kWords = V * (int)sizeof(Tout) / 16;
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        reinterpret_cast<uint4*>(yb + vi * V)[w] =
            reinterpret_cast<const uint4*>(&out)[w];
    }
  }
}

// The straight-through estimator of Quant (see the header).
struct Ste {
  float lo, qmax, inv_scale;
  __device__ __forceinline__ float operator()(float x, float g,
                                              bool clip) const {
    const float v = __fmul_rn(__fmul_rn(g, inv_scale), qmax);
    if (!clip) return v;
    // compares are false for NaN, so a NaN x takes m = 0
    const float m = (x > lo && x < 1.f)    ? 1.f
                    : (x == lo || x == 1.f) ? 0.5f
                                            : 0.f;
    return __fmul_rn(v, m);
  }
};

// gi[i] = ste(x[i], g[i]) over n elements, in the forward's layout: vectors
// of V over [head, head + nv * V) where gi is 16-byte aligned, a scalar head
// and tail on the first threads. x and g are loaded 16 bytes at a time where
// they are aligned at the same element (vec_x, vec_g), else element by
// element. x is not read when CLIP is false.
template <typename Tx, typename Tg, int V, bool CLIP>
__global__ void __launch_bounds__(kThreads)
fake_quant_bwd_kernel(const Tx* __restrict__ x, const Tg* __restrict__ g,
                      Tx* __restrict__ gi, int64_t n, int head, int64_t nv,
                      int unroll, bool vec_x, bool vec_g, Ste s) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t body_end = head + nv * V;
  if (tid < head)
    store(gi + tid, s(CLIP ? to_f32(x[tid]) : 0.f, to_f32(g[tid]), CLIP));
  if (tid < n - body_end) {
    const int64_t k = body_end + tid;
    store(gi + k, s(CLIP ? to_f32(x[k]) : 0.f, to_f32(g[k]), CLIP));
  }

  const Tx* xb = x + head;
  const Tg* gb = g + head;
  Tx* ob = gi + head;
  const int64_t per_block = (int64_t)kThreads * unroll;
  for (int64_t base = blockIdx.x * per_block + threadIdx.x; base < nv;
       base += gridDim.x * per_block) {
    Vec<Tg, V> gin[kUnroll];
    Vec<Tx, V> xin[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t vi = base + u * kThreads;
      if (u < unroll && vi < nv) {
        load_vec<Tg, V>(gin[u], gb + vi * V, vec_g);
        if (CLIP) load_vec<Tx, V>(xin[u], xb + vi * V, vec_x);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t vi = base + u * kThreads;
      if (u >= unroll || vi >= nv) continue;
      Vec<Tx, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e)
        store(&out.v[e], s(CLIP ? to_f32(xin[u].v[e]) : 0.f,
                           to_f32(gin[u].v[e]), CLIP));
      constexpr int kWords = V * (int)sizeof(Tx) / 16;
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        reinterpret_cast<uint4*>(ob + vi * V)[w] =
            reinterpret_cast<const uint4*>(&out)[w];
    }
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

// the grid of the vector pass: kUnroll vectors a thread, one when the
// tensor has fewer vectors than a block's threads per SM; at least enough
// threads for the scalar head and tail
void grid_for(int64_t nv, int64_t edge, int device, int* unroll,
              int64_t* blocks) {
  const int sms = sm_count(device);
  *unroll = nv < (int64_t)sms * kThreads ? 1 : kUnroll;
  int64_t b = (nv + (int64_t)kThreads * *unroll - 1) / (kThreads * *unroll);
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  if (b > cap) b = cap;
  const int64_t min_blocks = (edge + kThreads - 1) / kThreads;
  if (b < min_blocks) b = min_blocks;
  *blocks = b < 1 ? 1 : b;
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* xp, void* yp, int64_t n, Quant q, int device,
                   cudaStream_t st) {
  constexpr int V = (sizeof(Tin) == 2 || sizeof(Tout) == 2) ? 8 : 4;
  const Tin* x = static_cast<const Tin*>(xp);
  Tout* y = static_cast<Tout*>(yp);
  // elements before y reaches a 16-byte boundary (sizeof(Tout) divides it)
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y) & 15;
  int64_t head = ya ? (16 - (int64_t)ya) / (int64_t)sizeof(Tout) : 0;
  if (head > n) head = n;
  const int64_t nv = (n - head) / V;
  const int64_t tail = n - head - nv * V;
  const bool vec_in =
      ((reinterpret_cast<uintptr_t>(x + head)) & 15) == 0;
  // kUnroll vectors a thread; one when the tensor has fewer vectors than
  // a block's threads per SM (decode-sized tensors: more blocks, each SM
  // its own)
  int unroll;
  int64_t blocks;
  grid_for(nv, head > tail ? head : tail, device, &unroll, &blocks);
  if (vec_in)
    fake_quant_kernel<Tin, Tout, V, true><<<(int)blocks, kThreads, 0, st>>>(
        x, y, n, (int)head, nv, unroll, q);
  else
    fake_quant_kernel<Tin, Tout, V, false><<<(int)blocks, kThreads, 0, st>>>(
        x, y, n, (int)head, nv, unroll, q);
  return cudaGetLastError();
}

template <typename Tx, typename Tg>
cudaError_t launch_bwd(const void* xp, const void* gp, void* gip, int64_t n,
                       Ste s, bool clip, int device, cudaStream_t st) {
  constexpr int V = (sizeof(Tx) == 2 || sizeof(Tg) == 2) ? 8 : 4;
  const Tx* x = static_cast<const Tx*>(xp);
  const Tg* g = static_cast<const Tg*>(gp);
  Tx* gi = static_cast<Tx*>(gip);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(gi) & 15;
  int64_t head = oa ? (16 - (int64_t)oa) / (int64_t)sizeof(Tx) : 0;
  if (head > n) head = n;
  const int64_t nv = (n - head) / V;
  const int64_t tail = n - head - nv * V;
  const bool vec_x =
      clip && (reinterpret_cast<uintptr_t>(x + head) & 15) == 0;
  const bool vec_g = (reinterpret_cast<uintptr_t>(g + head) & 15) == 0;
  int unroll;
  int64_t blocks;
  grid_for(nv, head > tail ? head : tail, device, &unroll, &blocks);
  if (clip)
    fake_quant_bwd_kernel<Tx, Tg, V, true><<<(int)blocks, kThreads, 0, st>>>(
        x, g, gi, n, (int)head, nv, unroll, vec_x, vec_g, s);
  else
    fake_quant_bwd_kernel<Tx, Tg, V, false><<<(int)blocks, kThreads, 0, st>>>(
        x, g, gi, n, (int)head, nv, unroll, vec_x, vec_g, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = fake_quant(x) over n elements; bits in [1, 24]; in_bf16 / out_bf16
// pick bf16 (else f32) for x and y. Launches on `stream` of device
// `device` and returns the cudaError_t of the launch (0 = ok).
int fake_quant_launch(const void* x, void* y, int64_t n, int in_bf16,
                      int out_bf16, int bits, int is_signed, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int e = is_signed ? bits - 1 : bits;  // 2^e is the divisor
  const Quant q{is_signed ? -1.f : 0.f, ldexpf(1.f, e) - 1.f,
                ldexpf(1.f, -e)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16) err = launch<bf16, bf16>(x, y, n, q, device, st);
  else if (in_bf16) err = launch<bf16, float>(x, y, n, q, device, st);
  else if (out_bf16) err = launch<float, bf16>(x, y, n, q, device, st);
  else err = launch<float, float>(x, y, n, q, device, st);
  return static_cast<int>(err);
}

// grad_in = STE(x, grad) over n elements (see the header); x_bf16 /
// g_bf16 pick bf16 (else f32) for x (and grad_in) and grad; clip 1 is the
// activation mode, 0 the weight mode (x unread). Launches on `stream` and
// returns the cudaError_t of the launch (0 = ok).
int fake_quant_bwd_launch(const void* x, const void* grad, void* grad_in,
                          int64_t n, int x_bf16, int g_bf16, int bits,
                          int is_signed, int clip, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int e = is_signed ? bits - 1 : bits;
  const Ste s{is_signed ? -1.f : 0.f, ldexpf(1.f, e) - 1.f, ldexpf(1.f, -e)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool c = clip != 0;
  if (x_bf16 && g_bf16)
    err = launch_bwd<bf16, bf16>(x, grad, grad_in, n, s, c, device, st);
  else if (x_bf16)
    err = launch_bwd<bf16, float>(x, grad, grad_in, n, s, c, device, st);
  else if (g_bf16)
    err = launch_bwd<float, bf16>(x, grad, grad_in, n, s, c, device, st);
  else
    err = launch_bwd<float, float>(x, grad, grad_in, n, s, c, device, st);
  return static_cast<int>(err);
}

const char* fake_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
