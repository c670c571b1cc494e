// BatchNorm statistics reductions over a row-major (rows, C) view, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels vnet_tpu/ops/pallas/fused.py::bn_stats and
// ::bn_grad_stats. Per channel c, in float32:
//
//     bn_stats:       (sum_r x[r, c],  sum_r x[r, c]^2)
//     bn_grad_stats:  (sum_r dy[r, c], sum_r dy[r, c] * xhat[r, c]),
//                     xhat = (x - mean[c]) * invstd[c]   (mean, invstd f32)
//
// x and dy are float32, bfloat16 or float16.
//
// Design. The TPU kernels carry both sums in VMEM scratch across a grid that
// runs in order; here blocks run in no order, so the reduction has two passes.
// Block (chunk, slab) streams one contiguous chunk of rows and one slab of at
// most 256 channel groups. A channel group is VEC channels loaded together:
// 16 bytes (8 bf16/f16, 4 f32) when C * sizeof(T) is a multiple of 16 and
// the data is 16-byte aligned, else one channel (the output norm has C = 3).
// The block's threads split into `lanes` row lanes of `gb` groups each; lane
// l reads rows l, l + lanes, ..., so one step of a block reads lanes
// consecutive rows, contiguous in memory. Each thread sums in float32
// registers; the lanes' sums are added in shared memory in lane order and
// each block writes its float32 partial (2, C) slice. A second kernel adds
// the partials of all chunks, one warp per output, lane-strided and then a
// fixed butterfly. No float atomics anywhere, so the statistics are the same
// bits from run to run.
//
// Cost. Both are bound by memory bandwidth: one read of x (and dy), a few
// float operations per element; the partials are chunks * 2C floats.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define BN_THREADS 256
#define BN_MAXVEC 8

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// VEC consecutive values as float; one 16-byte load when VEC fills 16 bytes.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(p[i]);
  }
}

// GRAD false: a = x, sums (x, x*x). GRAD true: a = dy, b = x, sums
// (dy, dy * xhat).
template <typename T, int VEC, bool GRAD>
__global__ void __launch_bounds__(BN_THREADS) bn_partial_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    float* __restrict__ partial, long long rows, int C,
    long long chunk_rows) {
  __shared__ float red[2][BN_THREADS * BN_MAXVEC];
  const int G = C / VEC;
  const int g0 = blockIdx.y * BN_THREADS;
  const int gb = min(G - g0, BN_THREADS);
  const int lanes = BN_THREADS / gb;
  const int width = gb * VEC;
  const int tid = threadIdx.x;
  const int lane = tid / gb, gl = tid % gb;
  const int c0 = (g0 + gl) * VEC;

  float s0[VEC], s1[VEC], mu[VEC], is[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s0[i] = s1[i] = mu[i] = is[i] = 0.0f;
  if (lane < lanes) {
    if constexpr (GRAD) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        mu[i] = mean[c0 + i];
        is[i] = invstd[c0 + i];
      }
    }
    const long long r_begin = (long long)blockIdx.x * chunk_rows;
    const long long r_end =
        r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
#pragma unroll 4
    for (long long r = r_begin + lane; r < r_end; r += lanes) {
      float va[VEC];
      load_vec<T, VEC>(a + r * C + c0, va);
      if constexpr (GRAD) {
        float vb[VEC];
        load_vec<T, VEC>(b + r * C + c0, vb);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xhat = (vb[i] - mu[i]) * is[i];
          s0[i] += va[i];
          s1[i] = fmaf(va[i], xhat, s1[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s0[i] += va[i];
          s1[i] = fmaf(va[i], va[i], s1[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[0][lane * width + gl * VEC + i] = s0[i];
      red[1][lane * width + gl * VEC + i] = s1[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * width; e += BN_THREADS) {
    const int k = e / width, ch = e % width;
    float s = 0.0f;
    for (int l = 0; l < lanes; ++l) s += red[k][l * width + ch];
    partial[((long long)blockIdx.x * 2 + k) * C + g0 * VEC + ch] = s;
  }
}

// out[o] = sum over chunks of partial[chunk, o], o < outputs = 2C; one warp
// per output: lane-strided sums, then a fixed butterfly.
__global__ void bn_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int chunks,
                                 int outputs) {
  const int o = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (o >= outputs) return;  // the whole warp leaves together
  float s = 0.0f;
  for (int c = lane; c < chunks; c += 32) s += partial[(long long)c * outputs + o];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[o] = s;
}

template <typename T, bool GRAD>
static int launch(const void* a, const void* b, const float* mean,
                  const float* invstd, float* partial, float* out,
                  long long rows, int C, int vec, int chunks,
                  long long chunk_rows, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int width = vec ? V : 1;
  if (vec && C % V != 0) return (int)cudaErrorInvalidValue;
  const int groups = C / width;
  const int slabs = (groups + BN_THREADS - 1) / BN_THREADS;
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)slabs);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (vec)
    bn_partial_kernel<T, V, GRAD><<<grid, BN_THREADS, 0, stream>>>(
        ta, tb, mean, invstd, partial, rows, C, chunk_rows);
  else
    bn_partial_kernel<T, 1, GRAD><<<grid, BN_THREADS, 0, stream>>>(
        ta, tb, mean, invstd, partial, rows, C, chunk_rows);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int outputs = 2 * C;
  const int blocks = (outputs * 32 + 255) / 256;
  bn_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, out, chunks, outputs);
  return (int)cudaGetLastError();
}

template <bool GRAD>
static int dispatch(const void* a, const void* b, const float* mean,
                    const float* invstd, float* partial, float* out, int dtype,
                    long long rows, int C, int vec, int chunks,
                    long long chunk_rows, cudaStream_t stream) {
  if (rows < 1 || C < 1 || chunks < 1 || chunk_rows < 1 ||
      (long long)chunks * chunk_rows < rows)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float, GRAD>(a, b, mean, invstd, partial, out, rows, C,
                                 vec, chunks, chunk_rows, stream);
    case 1:
      return launch<__nv_bfloat16, GRAD>(a, b, mean, invstd, partial, out,
                                         rows, C, vec, chunks, chunk_rows,
                                         stream);
    case 2:
      return launch<__half, GRAD>(a, b, mean, invstd, partial, out, rows, C,
                                  vec, chunks, chunk_rows, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Host entry points, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16. partial holds chunks * 2 * C floats, out 2 * C floats (the two
// sums, one after the other); chunks * chunk_rows must cover rows; vec = 1
// takes 16-byte loads (C a multiple of 16 / sizeof(T), 16-byte aligned data).
// Both launch two kernels on `stream` without synchronising and return
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside the
// contract.
extern "C" int vnet_bn_stats(const void* x, float* partial, float* out,
                             int dtype, long long rows, int C, int vec,
                             int chunks, long long chunk_rows,
                             cudaStream_t stream) {
  return dispatch<false>(x, nullptr, nullptr, nullptr, partial, out, dtype,
                         rows, C, vec, chunks, chunk_rows, stream);
}

extern "C" int vnet_bn_grad_stats(const void* dy, const void* x,
                                  const float* mean, const float* invstd,
                                  float* partial, float* out, int dtype,
                                  long long rows, int C, int vec, int chunks,
                                  long long chunk_rows, cudaStream_t stream) {
  return dispatch<true>(dy, x, mean, invstd, partial, out, dtype, rows, C,
                        vec, chunks, chunk_rows, stream);
}
