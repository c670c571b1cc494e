// Dropout with an in-kernel counter-based generator, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/dropout.py::pallas_dropout
// (its _apply / _dropout_kernel). Elementwise over n elements:
//
//     out[i] = (u[i] < thr) ? x[i] * scale : 0
//
// where u[i] is word (i mod 4) of Philox4x32-10 applied to the counter
// (i / 4, 0) under the key (k0, k1) = (per-step seed, per-module stream).
// The threshold and the scale carry the three dropout flavours of the JAX
// package (pallas: thr = round(keep * 2^32), scale 1/keep; bits8: the top
// byte against t = round(keep * 256), i.e. thr = t << 24, scale 256/t; xla:
// as pallas). The backward pass is the same function applied to the
// incoming gradient with the same key, so no mask is ever stored: the key
// regenerates it, as the TPU kernel's seed does.
//
// Index i is the element's position in the (B, X, Y, Z, C) order of the JAX
// layout (the storage order of a channels-last tensor); the wrapper hands the
// kernel tensors in that storage order, so the mask does not depend on the
// memory format a gradient arrives in.
//
// The generator is written out here and mirrored bit for bit by the plain
// PyTorch version in ops/dropout.py, so kernel and plain version agree
// exactly. The product x * scale is taken in float and rounded once to the
// element type, as PyTorch does for a reduced-precision multiply.
//
// Cost. The kernel is bound by memory bandwidth: it reads x once and writes
// out once (2 * n * sizeof(T) bytes); Philox's 10 rounds are about 50 integer
// instructions per 4 elements, which the card hides behind the loads. One
// thread handles 4 consecutive elements, the 4 words of one Philox call, and
// loads and stores them as one vector when the pointers are aligned.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(unsigned long long counter,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from_f(float v) {
    return __float2half_rn(v);
  }
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ T drop(T x, uint32_t u, uint32_t thr, float scale) {
  return u < thr ? Cvt<T>::from_f(Cvt<T>::to_f(x) * scale)
                 : Cvt<T>::from_f(0.0f);
}

template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                               long long n, uint32_t k0, uint32_t k1,
                               uint32_t thr, float scale, int vec) {
  const long long groups = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += stride) {
    const uint4 r = philox4x32_10((unsigned long long)gi, k0, k1);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    const long long base = gi << 2;
    if (vec && base + 4 <= n) {
      const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[gi];
      Vec4<T> o;
#pragma unroll
      for (int j = 0; j < 4; ++j) o.v[j] = drop(in.v[j], w[j], thr, scale);
      reinterpret_cast<Vec4<T>*>(out)[gi] = o;
    } else {
      for (int j = 0; j < 4 && base + j < n; ++j)
        out[base + j] = drop(x[base + j], w[j], thr, scale);
    }
  }
}

template <typename T>
static void launch(const void* x, void* out, long long n, uint32_t k0,
                   uint32_t k1, uint32_t thr, float scale, int vec,
                   cudaStream_t stream) {
  const int threads = 256;
  long long blocks = ((n + 3) / 4 + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  dropout_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, k0, k1, thr, scale,
      vec);
}

// Host entry point, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16. vec = 1 when x and out are aligned to 4 elements. Launches on
// `stream` without synchronising and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside the contract.
extern "C" int vnet_dropout(const void* x, void* out, long long n, int dtype,
                            unsigned int k0, unsigned int k1, unsigned int thr,
                            float scale, int vec, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      launch<float>(x, out, n, k0, k1, thr, scale, vec, stream);
      break;
    case 1:
      launch<__nv_bfloat16>(x, out, n, k0, k1, thr, scale, vec, stream);
      break;
    case 2:
      launch<__half>(x, out, n, k0, k1, thr, scale, vec, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
