// Dropout with an in-kernel counter-based generator, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/dropout.py::pallas_dropout
// (its _apply / _dropout_kernel). Elementwise over n elements:
//
//     out[i] = (u[i] < thr) ? (divide ? x[i] / factor : x[i] * factor) : 0
//
// where u[i] is word (j mod 4) of Philox4x32-10 applied to the counter
// (j / 4, 0), j = base + i, under the key (k0, k1) = (per-step seed,
// per-module stream). The counter base lets a data-parallel rank draw its
// rows of the global batch's mask: base is the number of elements of the
// rows before its own, any value (a base that is not a multiple of 4 starts
// inside a Philox group and takes the scalar loop below).
// The threshold, the factor and `divide` carry the three dropout flavours of
// the JAX package (pallas: thr = round(keep * 2^32), times 1/keep; bits8: the
// top byte against t = round(keep * 256), i.e. thr = t << 24, times 256/t;
// xla: the pallas threshold, divided by keep, as flax's nn.Dropout computes
// inputs / keep_prob). The backward pass is the same function applied to
// the incoming gradient with the same key, so no mask is ever stored: the
// key regenerates it, as the TPU kernel's seed does.
//
// Index i is the element's position in the (B, X, Y, Z, C) order of the JAX
// layout (the storage order of a channels-last tensor); the wrapper hands the
// kernel tensors in that storage order, so the mask does not depend on the
// memory format a gradient arrives in.
//
// The generator is written out here and mirrored bit for bit by the plain
// PyTorch version in ops/dropout.py, so kernel and plain version agree
// exactly. The factor arrives rounded to the element type; the product or
// quotient is taken in float with IEEE rounding and rounded once to the
// element type, as XLA and PyTorch compute a reduced-precision multiply or
// divide.
//
// Cost. The kernel is bound by memory bandwidth: it reads x once and writes
// out once (2 * n * sizeof(T) bytes). Philox's 10 rounds are 19 wide
// multiplies and 20 three-input XORs per 4 elements, so in bf16 or f16 the
// integer work per byte is twice float32's; it hides behind the loads only
// while enough warps are resident. The design:
//   * every access is 16 bytes: a thread moves 8 bf16 or f16 elements (two
//     Philox calls) or 4 float32 elements (one call) per load and store;
//   * the grid is the card's resident blocks, walking the tensor with a
//     grid stride, one 16-byte load a thread a pass. On the H100 that
//     measured fastest: two or four loads a thread before any bits cost
//     registers (up to 54 against 36-46), hence resident warps, and ran
//     slower at the largest shape, as did ld.nc.L1::no_allocate with st.cs
//     and a ring of bulk asynchronous copies in shared memory; PERF.md has
//     the readings. nvcc makes Philox's key schedule once per loop and keeps
//     the 18 round keys in registers; a schedule made on the host and read
//     from uniform registers freed those registers but ran slower;
//   * the xla quotient is RN(x / d) without the division's slow path: with
//     r = RN(1 / d) from the host, q0 = x * r, then two Markstein
//     corrections q' = fma(fma(-q, d, x), r, q). One correction needs q0
//     faithful (within one ulp), which RN(x * r) is not always; after one
//     correction q1 is, so the second gives the correctly rounded quotient
//     wherever nothing overflows or underflows (Markstein, 1990). A guard
//     sends what could (|x| < 2^-100 and not 0, |q| >= 2^127, infinities and
//     NaNs) to __fdiv_rn, which real activations never reach.
// A scalar loop over Philox groups takes the ragged tail and any tensor
// whose pointers are not 16-byte aligned, in the same launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  uint32_t k0, k1, thr;
  float factor;  // the multiplier, or the divisor d when dividing
  float recip;   // RN(1 / d), used only when dividing
};

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
    const unsigned long long p0 = 0xD2511F53ull * c0;  // IMAD.WIDE.U32
    const unsigned long long p1 = 0xCD9E8D57ull * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
    c0 = n0;
    c2 = n2;
  }
  return make_uint4(c0, c1, c2, c3);
}

template <bool DIV>
__device__ __forceinline__ float scale(float v, const Params& p) {
  if (!DIV) return __fmul_rn(v, p.factor);
  const float d = p.factor, r = p.recip;
  const float q0 = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, d, v), r, q0);
  float q = copysignf(__fmaf_rn(__fmaf_rn(-q1, d, v), r, q1), v);
  if (!(fabsf(q) < 0x1p127f) || (v != 0.0f && fabsf(v) < 0x1p-100f))
    q = __fdiv_rn(v, d);
  return q;
}

template <bool DIV>
__device__ __forceinline__ float drop(float v, uint32_t u, const Params& p) {
  return u < p.thr ? scale<DIV>(v, p) : 0.0f;
}

// Element types: to and from float one at a time, and two 16-bit elements
// packed in a 32-bit word (low half first) at a time.
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
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xFFFF0000u));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 o = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&o);
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
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 o = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&o);
  }
};

// Two 16-bit elements of a word through the dropout, with their two random
// words.
template <typename T, bool DIV>
__device__ __forceinline__ uint32_t drop_pair(uint32_t w, uint32_t u0,
                                              uint32_t u1, const Params& p) {
  const float2 f = Cvt<T>::unpack(w);
  return Cvt<T>::pack(drop<DIV>(f.x, u0, p), drop<DIV>(f.y, u1, p));
}

// The 16 bytes at vector index v: 4 float32 elements (Philox group g0 + v)
// or 8 16-bit elements (groups g0 + 2v and g0 + 2v + 1), g0 the group of
// element 0.
template <typename T, bool DIV>
__device__ __forceinline__ uint4 drop16(uint4 in, long long v, long long g0,
                                        const Params& p) {
  if constexpr (sizeof(T) == 4) {
    const uint4 u = philox4x32_10((unsigned long long)(g0 + v), p.k0, p.k1);
    const auto f = [&](uint32_t w, uint32_t uw) {
      return __float_as_uint(drop<DIV>(__uint_as_float(w), uw, p));
    };
    return make_uint4(f(in.x, u.x), f(in.y, u.y), f(in.z, u.z),
                      f(in.w, u.w));
  } else {
    const unsigned long long g = (unsigned long long)(g0 + 2 * v);
    const uint4 a = philox4x32_10(g, p.k0, p.k1);
    const uint4 b = philox4x32_10(g + 1ull, p.k0, p.k1);
    return make_uint4(drop_pair<T, DIV>(in.x, a.x, a.y, p),
                      drop_pair<T, DIV>(in.y, a.z, a.w, p),
                      drop_pair<T, DIV>(in.z, b.x, b.y, p),
                      drop_pair<T, DIV>(in.w, b.z, b.w, p));
  }
}

// nvec 16-byte vectors from the start of x (0 when x or out is not 16-byte
// aligned or base is not a multiple of 4), then the Philox groups from the
// first element after them to n one element at a time: group g covers
// elements 4g - base .. 4g - base + 3.
template <typename T, bool DIV>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                   long long nvec, long long base, Params p) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long g0 = base >> 2;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = first; i < nvec; i += stride)
    ov[i] = drop16<T, DIV>(__ldg(xv + i), i, g0, p);
  const long long groups = (base + n + 3) >> 2;
  for (long long g = g0 + nvec * (long long)(4 / sizeof(T)) + first;
       g < groups; g += stride) {
    const uint4 u = philox4x32_10((unsigned long long)g, p.k0, p.k1);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * g + j - base;
      if (i >= 0 && i < n)
        out[i] = Cvt<T>::from_f(drop<DIV>(Cvt<T>::to_f(x[i]), w[j], p));
    }
  }
}

template <typename T, bool DIV>
cudaError_t launch(const void* x, void* out, long long n, long long base,
                   int vec, const Params& p, cudaStream_t stream) {
  static int resident[64];  // blocks per SM that fit, per device
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident[dev], dropout_kernel<T, DIV>, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const long long nvec =
      vec && (base & 3) == 0 ? n / (16 / (long long)sizeof(T)) : 0;
  const long long work = nvec > 0 ? nvec : (n + 3) / 4;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long full = (long long)sms[dev] * resident[dev];
  if (blocks > full) blocks = full;
  dropout_kernel<T, DIV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, nvec, base, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flavour(const void* x, void* out, long long n,
                           long long base, int vec, int divide,
                           const Params& p, cudaStream_t stream) {
  return divide ? launch<T, true>(x, out, n, base, vec, p, stream)
                : launch<T, false>(x, out, n, base, vec, p, stream);
}

}  // namespace

// Host entry point, bound with ctypes. base: the counter of element 0 (>= 0).
// dtype: 0 float32, 1 bfloat16, 2 float16. factor: rounded to the element
// type by the caller; divide = 1 divides survivors by it, 0 multiplies.
// vec = 1 when x and out are both 16-byte aligned. Launches one kernel on
// `stream` without synchronising and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside the contract.
extern "C" int vnet_dropout(const void* x, void* out, long long n,
                            long long base, int dtype, unsigned int k0,
                            unsigned int k1, unsigned int thr, float factor,
                            int divide, int vec, cudaStream_t stream) {
  if (n < 1 || base < 0) return (int)cudaErrorInvalidValue;
  const Params p{k0, k1, thr, factor, 1.0f / factor};  // IEEE on the host
  switch (dtype) {
    case 0:
      return (int)launch_flavour<float>(x, out, n, base, vec, divide, p,
                                        stream);
    case 1:
      return (int)launch_flavour<__nv_bfloat16>(x, out, n, base, vec,
                                                divide, p, stream);
    case 2:
      return (int)launch_flavour<__half>(x, out, n, base, vec, divide, p,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
