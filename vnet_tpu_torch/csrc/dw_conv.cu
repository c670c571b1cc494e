// Weight gradient of a stride-1 SAME 3D convolution on channels-last
// activations, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/dw_conv.py::dw_conv_pallas
// (the dW of conv_pallas_dw's VJP). With x of shape (B, X, Y, Z, Ci) (the
// forward input) and g of shape (B, X, Y, Z, Co) (the output gradient), both
// in channels-last storage, and lo = (k - 1) / 2 per axis:
//
//     dW[co, ci, ox, oy, oz] = sum_{b, p} x[b, p + o - lo, ci] * g[b, p, co]
//
// summed in float32, with x taken as zero outside the volume (the SAME
// padding). The result is written in the port's (Co, Ci, kx, ky, kz) layout.
//
// Design. The reduction runs over every output position p (B*X*Y*Z of them,
// 25M at batch 96 and 64^3) and is split across blocks: block (o, c, t)
// handles kernel offset o, the c-th contiguous chunk of positions and the
// t-th (ci, co) channel tile, and writes its f32 partial sum to a scratch
// array. A second kernel adds the partials of every chunk in a fixed order,
// so the result is the same from run to run (no float atomics). Offsets are
// the fastest grid index, so the blocks that run at one time read the same
// position chunk and its x and g tiles come from L2.
//
// Inside a block, 64 positions at a time are staged in shared memory as f32
// (x shifted by the offset and zero outside the volume, computed from the
// position's coordinates: no padded copy of x is made). Each thread owns a
// 4x4 (ci, co) micro-tile of the block's channel tile and walks its share of
// the staged positions: two 16-byte shared loads per 16 FMAs. A channel tile
// is 4 to 64 channels per side; when it has fewer than 64 x 64 outputs the
// block's 256 threads split the staged positions into groups and the groups'
// sums are added in shared memory at the end, in group order.
//
// Cost. At the V-Net's widths the work is 2 * B*X*Y*Z * k^3 * Ci * Co
// operations (1.6 TFLOP for the 16->16 5^3 conv at batch 96 and 64^3) on
// float32 CUDA cores, against the card's bf16 tensor-core bound; tensor cores
// (wgmma), TMA staging and the tuning of the split are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define DW_THREADS 256
#define DW_PT 64    // positions staged per step
#define DW_TMAX 64  // largest channel tile per side

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half v) {
    return __half2float(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(DW_THREADS) dw_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    float* __restrict__ partial, int X, int Y, int Z, int Ci, int Co, int ky,
    int kz, int lx, int ly, int lz, int tci, int tco, int ci_tiles,
    long long positions, long long chunk_len) {
  __shared__ __align__(16) float xs[DW_PT * DW_TMAX];
  __shared__ __align__(16) float gs[DW_PT * DW_TMAX];
  __shared__ long long xoff[DW_PT];  // x offset of channel 0, or -1
  __shared__ long long goff[DW_PT];  // g offset of channel 0, or -1

  const int K = gridDim.x;
  const int o = blockIdx.x;
  const int dz = o % kz - lz, dy = (o / kz) % ky - ly, dx = o / (kz * ky) - lx;
  const long long chunk = blockIdx.y;
  const int ci0 = (blockIdx.z % ci_tiles) * tci;
  const int co0 = (blockIdx.z / ci_tiles) * tco;
  const int tid = threadIdx.x;
  const int tpg = (tci / 4) * (tco / 4);  // threads per group
  const int groups = DW_THREADS / tpg;
  const int gid = tid / tpg, lane = tid % tpg;
  const int mi = lane / (tco / 4), mj = lane % (tco / 4);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const long long p_begin = chunk * chunk_len;
  const long long p_end =
      p_begin + chunk_len < positions ? p_begin + chunk_len : positions;
  for (long long p0 = p_begin; p0 < p_end; p0 += DW_PT) {
    if (tid < DW_PT) {
      const long long p = p0 + tid;
      long long xo = -1, go = -1;
      if (p < p_end) {
        go = p * Co;
        const int iz = (int)(p % Z);
        long long t = p / Z;
        const int iy = (int)(t % Y);
        t /= Y;
        const int ix = (int)(t % X);
        const long long b = t / X;
        const int sx = ix + dx, sy = iy + dy, sz = iz + dz;
        if ((unsigned)sx < (unsigned)X && (unsigned)sy < (unsigned)Y &&
            (unsigned)sz < (unsigned)Z)
          xo = (((b * X + sx) * Y + sy) * (long long)Z + sz) * Ci;
      }
      xoff[tid] = xo;
      goff[tid] = go;
    }
    __syncthreads();
    for (int e = tid; e < DW_PT * tci; e += DW_THREADS) {
      const int pp = e / tci, c = e % tci;
      const long long xo = xoff[pp];
      xs[e] = (xo >= 0 && ci0 + c < Ci) ? Cvt<T>::to_f(x[xo + ci0 + c]) : 0.0f;
    }
    for (int e = tid; e < DW_PT * tco; e += DW_THREADS) {
      const int pp = e / tco, c = e % tco;
      const long long go = goff[pp];
      gs[e] = (go >= 0 && co0 + c < Co) ? Cvt<T>::to_f(g[go + co0 + c]) : 0.0f;
    }
    __syncthreads();
    for (int pp = gid; pp < DW_PT; pp += groups) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[pp * tci + mi * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[pp * tco + mj * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // groups * tci * tco == DW_THREADS * 16 == DW_PT * DW_TMAX: reuse xs
  float* red = xs;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(gid * tci + mi * 4 + i) * tco + mj * 4 + j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < tci * tco; e += DW_THREADS) {
    float s = 0.0f;
    for (int q = 0; q < groups; ++q) s += red[q * tci * tco + e];
    const int ci = ci0 + e / tco, co = co0 + e % tco;
    if (ci < Ci && co < Co)
      partial[((chunk * K + o) * Ci + ci) * (long long)Co + co] = s;
  }
}

// out[co, ci, o] = sum over chunks c, in order, of partial[c, o, ci, co]
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int chunks, int K,
                                 int Ci, int Co) {
  const long long total = (long long)K * Ci * Co;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int co = (int)(e % Co);
    const long long t = e / Co;  // o * Ci + ci
    const int ci = (int)(t % Ci), o = (int)(t / Ci);
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[c * total + e];
    out[((long long)co * Ci + ci) * K + o] = s;
  }
}

static int tile(int c) {
  int t = 4;
  while (t < c && t < DW_TMAX) t *= 2;
  return t;
}

template <typename T>
static void launch(const void* x, const void* g, float* partial, int X, int Y,
                   int Z, int Ci, int Co, int kx, int ky, int kz, int chunks,
                   long long chunk_len, long long positions,
                   cudaStream_t stream) {
  const int tci = tile(Ci), tco = tile(Co);
  const int ci_tiles = (Ci + tci - 1) / tci, co_tiles = (Co + tco - 1) / tco;
  const dim3 grid(kx * ky * kz, chunks, ci_tiles * co_tiles);
  dw_partial_kernel<T><<<grid, DW_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, X, Y, Z, Ci,
      Co, ky, kz, (kx - 1) / 2, (ky - 1) / 2, (kz - 1) / 2, tci, tco, ci_tiles,
      positions, chunk_len);
}

// Host entry point, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16 (x and g alike). partial holds chunks * k^3 * Ci * Co floats,
// out k^3 * Ci * Co; chunks * chunk_len must cover B*X*Y*Z. Launches both
// kernels on `stream` without synchronising and returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments outside the contract.
extern "C" int vnet_dw_conv(const void* x, const void* g, float* partial,
                            float* out, int dtype, int B, int X, int Y, int Z,
                            int Ci, int Co, int kx, int ky, int kz, int chunks,
                            long long chunk_len, cudaStream_t stream) {
  const long long positions = (long long)B * X * Y * Z;
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || Ci < 1 || Co < 1 || kx < 1 ||
      ky < 1 || kz < 1 || kx % 2 == 0 || ky % 2 == 0 || kz % 2 == 0 ||
      chunks < 1 || chunks > 65535 || chunk_len < 1 ||
      (long long)chunks * chunk_len < positions)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      launch<float>(x, g, partial, X, Y, Z, Ci, Co, kx, ky, kz, chunks,
                    chunk_len, positions, stream);
      break;
    case 1:
      launch<__nv_bfloat16>(x, g, partial, X, Y, Z, Ci, Co, kx, ky, kz,
                            chunks, chunk_len, positions, stream);
      break;
    case 2:
      launch<__half>(x, g, partial, X, Y, Z, Ci, Co, kx, ky, kz, chunks,
                     chunk_len, positions, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)kx * ky * kz * Ci * Co;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  dw_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      partial, out, chunks, kx * ky * kz, Ci, Co);
  return (int)cudaGetLastError();
}
