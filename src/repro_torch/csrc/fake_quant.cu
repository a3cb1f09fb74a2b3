// MARS fake quantization for Hopper (sm_90a): eq. 5 and eq. 8, elementwise.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fake_quant.py
// (fake_quant, body _kernel :16). For every element, in f32:
//   unsigned (eq. 5): y = rint(clamp(x, 0, 1) * (2^b - 1)) / 2^b
//   signed   (eq. 8): y = rint(clamp(x, -1, 1) * (2^(b-1) - 1)) / 2^(b-1)
// and y is written in x's type (f32, or bf16 rounded to nearest even).
//
// Bit-exact with jnp/torch: rintf rounds half to even as jnp.round and
// torch.round do (roundf would round half away from zero); the clamp is
// two compares, so a NaN stays NaN as under jnp.clip / torch.clamp (fminf
// and fmaxf would return the other operand); the level count multiplies
// with __fmul_rn (no contraction), and the division by 2^b is a multiply by
// its exact reciprocal.
//
// Design. The TPU kernel tiles a padded 2-D view into 256x256 VMEM blocks.
// Here the tensor is one flat array: a grid-stride loop, one element per
// thread per step, any length, no padding. It is bound by bytes (one read
// and one write per element over 3.35 TB/s); nothing else is worth doing
// for a pass this simple until it shows in a profile (vector loads later).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                  float lo, float qmax, float inv_scale) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float v = to_f32(x[i]);
    v = v < lo ? lo : v;    // compares, not fmaxf/fminf: NaN passes through
    v = v > 1.f ? 1.f : v;
    store(y + i, rintf(__fmul_rn(v, qmax)) * inv_scale);
  }
}

}  // namespace

extern "C" {

// y = fake_quant(x) over n elements; bits in [1, 24]. Launches on `stream`
// of device `device` and returns the cudaError_t of the launch (0 = ok).
int fake_quant_launch(const void* x, void* y, int64_t n, int is_bf16,
                      int bits, int is_signed, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int e = is_signed ? bits - 1 : bits;  // 2^e is the divisor
  const float qmax = ldexpf(1.f, e) - 1.f;
  const float inv_scale = ldexpf(1.f, -e);
  const float lo = is_signed ? -1.f : 0.f;
  // at most 16 blocks per SM of an H100 (132 SMs); the loop strides past it
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    fake_quant_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, lo, qmax, inv_scale);
  else
    fake_quant_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, lo, qmax,
        inv_scale);
  return static_cast<int>(cudaGetLastError());
}

const char* fake_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
