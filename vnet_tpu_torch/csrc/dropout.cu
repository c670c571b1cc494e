// Dropout with an in-kernel counter-based generator, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/dropout.py::pallas_dropout
// (its _apply / _dropout_kernel). Elementwise over n elements:
//
//     out[i] = (u[i] < thr) ? (divide ? x[i] / factor : x[i] * factor) : 0
//
// where u[i] is word (j mod 4) of Philox4x32-10 applied to the counter
// (j / 4, 0), under the key (k0, k1) = (per-step seed, per-module stream),
// and j is element i's position in the tensor whose mask this is:
//
//     j = base + (i / L) * G + i % L        (row map; L = G: j = base + i)
//
// The counter base lets a data-parallel rank draw its rows of the global
// batch's mask: base is the number of elements of the rows before its own,
// any value (a base that is not a multiple of 4 starts inside a Philox
// group and takes the scalar loop below). The row map lets a rank of a
// spatial partition draw its slab of the unsharded tensor's mask: its
// tensor is n / L runs ("rows") of L elements, which lie G apart in the
// unsharded one (a slab of the first spatial axis of a (B, X, Y, Z, C)
// tensor: L = X/S * Y * Z * C, G = X * Y * Z * C), and base is the slab's
// first element there.
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
//   * the row map costs no division per element: a thread divides once, for
//     its first vector, and then carries its counter and its offset in the
//     row from vector to vector by steps the host works out (a vector of 8
//     16-bit elements may open a new row half way, L being a multiple of 4).
//     The walk is a template flag, set only for a tensor of several rows
//     that lie apart: carried through a contiguous tensor it cost the
//     dividing flavour 13-16% on the H100 (PERF.md), whose arithmetic
//     per byte leaves no room for it.
// A scalar loop, one Philox call per element, takes the ragged tail and any
// tensor whose pointers are not 16-byte aligned, in the same launch.

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

// The 16 bytes of a vector through the dropout: 4 float32 elements (Philox
// group ga) or 8 16-bit elements (groups ga, then gb).
template <typename T, bool DIV>
__device__ __forceinline__ uint4 drop16(uint4 in, long long ga, long long gb,
                                        const Params& p) {
  if constexpr (sizeof(T) == 4) {
    const uint4 u = philox4x32_10((unsigned long long)ga, p.k0, p.k1);
    const auto f = [&](uint32_t w, uint32_t uw) {
      return __float_as_uint(drop<DIV>(__uint_as_float(w), uw, p));
    };
    return make_uint4(f(in.x, u.x), f(in.y, u.y), f(in.z, u.z),
                      f(in.w, u.w));
  } else {
    const uint4 a = philox4x32_10((unsigned long long)ga, p.k0, p.k1);
    const uint4 b = philox4x32_10((unsigned long long)gb, p.k0, p.k1);
    return make_uint4(drop_pair<T, DIV>(in.x, a.x, a.y, p),
                      drop_pair<T, DIV>(in.y, a.z, a.w, p),
                      drop_pair<T, DIV>(in.z, b.x, b.y, p),
                      drop_pair<T, DIV>(in.w, b.z, b.w, p));
  }
}

// Element i counts at j = base + (i / L) * G + i % L (ROWS), or base + i.
// nvec 16-byte vectors from the start of x when x and out are 16-byte
// aligned and base (and L and G) are multiples of 4 (a vector's Philox
// groups then start at counters that are multiples of 4), else none; then
// the rest one element and one Philox call at a time. A thread divides
// once, for its first vector; the grid's stride of vectors is a fixed
// step_off elements within a row and step_j counters (both from the host),
// so it carries its offset in the row and its counter from vector to
// vector.
template <typename T, bool DIV, bool ROWS>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                   long long nvec, long long base, long long row_len,
                   long long row_stride, long long step_off,
                   long long step_j, Params p) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  constexpr long long kElems = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  if (first < nvec) {
    long long off = first * kElems;  // in its row (ROWS), else in x
    long long ja = base + off;
    if constexpr (ROWS) {
      const long long r = off / row_len;
      off -= r * row_len;
      ja = base + r * row_stride + off;
    }
    for (long long v = first; v < nvec; v += stride) {
      // the second group of 8 16-bit elements may open the next row
      const long long jb = !ROWS || off + 4 < row_len
                               ? ja + 4
                               : ja + 4 - row_len + row_stride;
      ov[v] = drop16<T, DIV>(__ldg(xv + v), ja >> 2, jb >> 2, p);
      ja += step_j;
      if constexpr (ROWS) {
        off += step_off;
        if (off >= row_len) {
          off -= row_len;
          ja += row_stride - row_len;
        }
      }
    }
  }
  for (long long i = nvec * kElems + first; i < n; i += stride) {
    long long j = base + i;
    if constexpr (ROWS) {
      const long long r = i / row_len;
      j = base + r * row_stride + (i - r * row_len);
    }
    const uint4 u = philox4x32_10((unsigned long long)(j >> 2), p.k0, p.k1);
    const int k = (int)(j & 3);
    const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
    out[i] = Cvt<T>::from_f(drop<DIV>(Cvt<T>::to_f(x[i]), w, p));
  }
}

template <typename T, bool DIV>
cudaError_t launch(const void* x, void* out, long long n, long long base,
                   long long row_len, long long row_stride, int vec,
                   const Params& p, cudaStream_t stream) {
  // the row walk only for a tensor of several rows that lie apart
  const bool rows = row_len < n && row_len != row_stride;
  const auto kernel =
      rows ? dropout_kernel<T, DIV, true> : dropout_kernel<T, DIV, false>;
  static int resident[2][64];  // blocks per SM that fit, per walk, device
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[rows][dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident[rows][dev], kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const bool aligned = vec && (base & 3) == 0 &&
                       (!rows || ((row_len & 3) == 0 && (row_stride & 3) == 0));
  const long long nvec = aligned ? n / (16 / (long long)sizeof(T)) : 0;
  const long long work = nvec > 0 ? nvec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long full = (long long)sms[dev] * resident[rows][dev];
  if (blocks > full) blocks = full;
  const long long step = blocks * kThreads * (16 / (long long)sizeof(T));
  const long long step_rows = rows ? step / row_len : 0;
  const long long step_off = rows ? step - step_rows * row_len : step;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, nvec, base, row_len,
      row_stride, step_off, step_rows * row_stride + step_off, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flavour(const void* x, void* out, long long n,
                           long long base, long long row_len,
                           long long row_stride, int vec, int divide,
                           const Params& p, cudaStream_t stream) {
  return divide ? launch<T, true>(x, out, n, base, row_len, row_stride, vec,
                                  p, stream)
                : launch<T, false>(x, out, n, base, row_len, row_stride, vec,
                                   p, stream);
}

}  // namespace

// Host entry point, bound with ctypes. base: the counter of element 0 (>= 0).
// row_len, row_stride: the row map (L, G above; 0 < L <= G, n a multiple of
// L; L = G, or L = n, counts from base contiguously). dtype: 0 float32,
// 1 bfloat16, 2 float16. factor: rounded to the element type by the
// caller; divide = 1 divides survivors by it, 0 multiplies. vec = 1 when x
// and out are both 16-byte aligned. Launches one kernel on `stream` without
// synchronising and returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments outside the contract.
extern "C" int vnet_dropout(const void* x, void* out, long long n,
                            long long base, long long row_len,
                            long long row_stride, int dtype, unsigned int k0,
                            unsigned int k1, unsigned int thr, float factor,
                            int divide, int vec, cudaStream_t stream) {
  if (n < 1 || base < 0 || row_len < 1 || row_stride < row_len ||
      n % row_len != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{k0, k1, thr, factor, 1.0f / factor};  // IEEE on the host
  switch (dtype) {
    case 0:
      return (int)launch_flavour<float>(x, out, n, base, row_len, row_stride,
                                        vec, divide, p, stream);
    case 1:
      return (int)launch_flavour<__nv_bfloat16>(x, out, n, base, row_len,
                                                row_stride, vec, divide, p,
                                                stream);
    case 2:
      return (int)launch_flavour<__half>(x, out, n, base, row_len,
                                         row_stride, vec, divide, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
