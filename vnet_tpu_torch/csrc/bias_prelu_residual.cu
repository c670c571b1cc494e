// Fused conv-block tail prelu(x + bias + residual), per-channel bias and
// slope, in x's dtype, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/fused.py::fused_bias_prelu_residual.
// Over a row-major (rows, C) view of x, residual and out, with bias and alpha
// of shape (C,) in the same dtype:
//
//     t   = (x + bias) + residual
//     out = max(t, 0) + alpha * min(t, 0)
//
// Rounding. For bfloat16 and float16 every operation is done in float32 and
// rounded to the dtype before the next one, as PyTorch's eager operators do
// one operator at a time; __fadd_rn and __fmul_rn keep the compiler from
// contracting a multiply and an add into one FMA, so the result is bitwise
// equal to the plain version. max and min pass a NaN through, as
// torch.clamp and jnp.maximum do.
//
// Cost. One elementwise pass, bound by memory bandwidth: read x and the
// residual, write out (bias and alpha stay in L1). Each thread moves 16 bytes
// per tensor per step (8 bf16/f16 or 4 f32) where all three are 16-byte
// aligned; the tail of a length that is not a multiple of that, and
// unaligned data, take scalar steps.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and back: one operator's result in T.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ T tail(T x, T res, T bias, T alpha) {
  float t = rnd<T>(__fadd_rn(to_f(x), to_f(bias)));
  t = rnd<T>(__fadd_rn(t, to_f(res)));
  const float pos = t < 0.0f ? 0.0f : t;  // NaN stays NaN
  const float neg = t > 0.0f ? 0.0f : t;
  const float scaled = rnd<T>(__fmul_rn(to_f(alpha), neg));
  return from_f<T>(__fadd_rn(pos, scaled));
}

template <typename T>
__global__ void bias_prelu_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const T* __restrict__ bias, const T* __restrict__ alpha,
    T* __restrict__ out, long long n, int C, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = vec ? n / V : 0;
  for (long long i = first; i < n_vec; i += step) {
    const long long base = i * V;
    uint4 xr = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint4 rr = __ldg(reinterpret_cast<const uint4*>(res) + i);
    T* xe = reinterpret_cast<T*>(&xr);
    const T* re = reinterpret_cast<const T*>(&rr);
    int c = (int)(base % C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xe[v] = tail(xe[v], re[v], bias[c], alpha[c]);
      if (++c == C) c = 0;
    }
    reinterpret_cast<uint4*>(out)[i] = xr;
  }
  for (long long e = n_vec * V + first; e < n; e += step) {
    const int c = (int)(e % C);
    out[e] = tail(x[e], res[e], bias[c], alpha[c]);
  }
}

template <typename T>
static int launch(const void* x, const void* res, const void* bias,
                  const void* alpha, void* out, long long n, int C, int vec,
                  cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long units = vec ? (n + V - 1) / V : n;
  long long blocks = (units + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  bias_prelu_residual_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(bias), static_cast<const T*>(alpha),
      static_cast<T*>(out), n, C, vec);
  return (int)cudaGetLastError();
}

// Host entry point, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16 (all five arrays alike). n = rows * C elements; vec = 1 only
// where x, res and out are 16-byte aligned. Launches on `stream` without
// synchronising and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside the contract.
extern "C" int vnet_bias_prelu_residual(const void* x, const void* res,
                                        const void* bias, const void* alpha,
                                        void* out, int dtype, long long n,
                                        int C, int vec, cudaStream_t stream) {
  if (n < 1 || C < 1 || n % C != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, res, bias, alpha, out, n, C, vec, stream);
    case 1:
      return launch<__nv_bfloat16>(x, res, bias, alpha, out, n, C, vec,
                                   stream);
    case 2:
      return launch<__half>(x, res, bias, alpha, out, n, C, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
