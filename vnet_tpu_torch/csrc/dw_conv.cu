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
// Two kernels write per-block float32 partial sums, and dw_reduce_kernel
// adds the partials of every chunk of positions in a fixed order: no float
// atomics, and a fixed mma order inside a block, so two runs give the same
// bits.
//
// dw_mma_kernel (bf16 and f16, Ci and Co multiples of 16, kz in {1, 3, 5,
// 7}): tensor cores. The work is 2 * B*X*Y*Z * k^3 * Ci * Co operations
// (1.6 TFLOP for the V-Net's 16->16 5^3 conv at batch 96 and 64^3), bound
// by the card's bf16 tensor-core rate. A block owns one plane of kernel
// offsets (one ox, ry values of oy, all oz), a channel tile of one or two
// 16 x 16 (ci, co) slabs, and a chunk of bricks: boxes of output positions
// (up to 512, across batch elements where the volume is small). For each
// brick, thread 0 issues two TMA loads: the g brick, and the x box that
// the plane's offsets reach (the brick plus a halo of ry - 1 rows in y and
// kz - 1 in z, shifted by ox - lo in x). TMA fills everything outside the
// volume with zeros, so the SAME padding costs nothing, and keeps the next
// brick in flight while the warps compute. Each warp owns one slab and one
// oy row, i.e. kz offsets, and walks them as shifted windows of the staged
// x box:
//
//     acc[oz] (16 ci x 16 co) += x window (16 ci x 16 pos) . g (16 pos x 16co)
//
// with mma.sync.m16n8k16 (f32 accumulate). The contraction runs over
// positions, the major axis of both staged tiles, so both fragments are
// loaded with ldmatrix.trans; one row address per lane lets a window start
// at any position. A warp loads a step's g fragment once for its kz
// offsets. x is staged once per offset plane (k times) instead of once per
// offset (k^3 times), at about 1.7x its size for the halo at 64^3.
//
// dw_partial_kernel (float32, or channels that are not multiples of 16):
// exact float32 products on CUDA cores. Block (o, c, t) handles kernel
// offset o, the c-th chunk of positions and the t-th channel tile; 64
// positions at a time are staged as f32 and each thread owns a 4x4 (ci, co)
// micro-tile. It serves float32 (no TF32: the reference sums f32 products)
// and the 1^3 16->3 output convolution, which is bound by its bytes.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define DW_THREADS 256
#define DW_PT 64    // positions staged per step
#define DW_TMAX 64  // largest channel tile per side

#define MMA_SMEM_MAX (227 * 1024)

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

// ---------------------------------------------------------------------------
// Tensor-core kernel.

struct MmaArgs {
  int B, X, Y, Z, Ci, Co, kx, ky, kz;
  int tci, tco;          // block channel tile: 16 or 32 per side
  int bb, bx, by, bz;    // brick extents (batch, x, y, z)
  int ry;                // oy rows per block, one warp row each
  int nb_x, nb_y, nb_z;  // bricks per axis (the batch axis is the rest)
  int bricks, bricks_per_chunk;
  int stages;            // bricks in flight per block
  int x_box, g_box;      // bytes of one brick's x box and g brick
  int x_bytes, g_bytes;  // one staging buffer of each (128-byte multiples)
};

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `phase` has completed.
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// One TMA load of a 5-D box at signed coordinates c (elements, innermost
// first) into shared memory; out-of-bounds elements arrive as zeros. The
// barrier counts the box's bytes.
static __device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2, int c3,
                                                   int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

static __device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                                     uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

template <typename T>
static __device__ __forceinline__ void mma16816(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Staged rows of c channels are 2c + 16 bytes: the TMA box takes 8
// channels more than the tile (zeros, or the next tile's channels, never
// read). An odd number of 16-byte chunks per row puts any eight
// consecutive rows of one chunk (an ldmatrix phase) in eight distinct bank
// groups, and the rows of neighbouring offsets are a constant stride apart.
static __device__ __forceinline__ int row_bytes(int c) { return 2 * c + 16; }

// Grid: (offset plane groups, channel tiles, chunks of bricks); block:
// ry x slabs warps. Warp (slab, row) owns the 16 ci x 16 co slab `slab` of
// the block's channel tile and the KZ offsets (ox, oy0 + row, 0..KZ-1).
// Thread 0 keeps `stages` bricks in flight, each as two TMA loads (the x
// box: the brick plus ry - 1 rows of halo in y and KZ - 1 in z, shifted by
// ox - lo in x; the g brick) completing on the stage's mbarrier. Partial
// sums land in partial[chunk][o][ci][co]; every entry of a chunk is written
// by exactly one warp. The mma accumulators start from zero at every brick
// and are added into float32 sums at its end: the tensor cores round their
// own sums short of IEEE float32, which over a chunk's 100k-position sums
// left up to 2.6e-4 of max|dW| at 64^3 on an H100; over bricks, 3e-6.
template <typename T, int KZ>
__global__ void __launch_bounds__(64 * KZ)
    dw_mma_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmg,
                  float* __restrict__ partial, const MmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t xs0 = smem_u32(smem);                        // stages
  const uint32_t gs0 = xs0 + a.stages * a.x_bytes;            // stages
  int* rowtab = reinterpret_cast<int*>(smem + a.stages * (a.x_bytes +
                                                          a.g_bytes));
  const int P = a.bb * a.bx * a.by * a.bz;
  const uint32_t bar0 = smem_u32(rowtab + P);                 // stages

  const int y_groups = (a.ky + a.ry - 1) / a.ry;
  const int kxi = blockIdx.x / y_groups;
  const int oy0 = (blockIdx.x % y_groups) * a.ry;
  const int ryg = min(a.ry, a.ky - oy0);  // oy rows of this block
  const int ci_tiles = a.Ci / a.tci;
  const int ci0 = (blockIdx.y % ci_tiles) * a.tci;
  const int co0 = (blockIdx.y / ci_tiles) * a.tco;
  const int RY = a.by + a.ry - 1, RZ = a.bz + KZ - 1;
  const int xrow = row_bytes(a.tci), grow = row_bytes(a.tco);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long n_begin = (long long)blockIdx.z * a.bricks_per_chunk;
  const long long n_end = min(n_begin + a.bricks_per_chunk,
                              (long long)a.bricks);

  // thread 0 loads brick n into stage s
  const CUtensorMap* mx = &tmx;
  const CUtensorMap* mg = &tmg;
  auto issue = [&](long long n, int s) {
    const int tz = (int)(n % a.nb_z);
    long long t = n / a.nb_z;
    const int ty = (int)(t % a.nb_y);
    t /= a.nb_y;
    const int tx = (int)(t % a.nb_x);
    const int b0 = (int)(t / a.nb_x) * a.bb;
    const int x0 = tx * a.bx, y0 = ty * a.by, z0 = tz * a.bz;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect(bar, a.x_box + a.g_box);
    tma_load_5d(xs0 + s * a.x_bytes, mx, bar, ci0, z0 - (KZ - 1) / 2,
                y0 + oy0 - (a.ky - 1) / 2, x0 + kxi - (a.kx - 1) / 2, b0);
    tma_load_5d(gs0 + s * a.g_bytes, mg, bar, co0, z0, y0, x0, b0);
  };
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < a.stages && n_begin + s < n_end; ++s)
      issue(n_begin + s, s);
  }
  // byte offset in the x box of each brick position at offset (oy0, 0)
  for (int pp = tid; pp < P; pp += blockDim.x) {
    const int l = pp % a.bz;
    int t = pp / a.bz;
    const int j = t % a.by;
    t /= a.by;
    rowtab[pp] = ((t * RY + j) * RZ + l) * xrow;  // t = bbi * bx + i
  }
  __syncthreads();

  const int row = warp % a.ry, slab = warp / a.ry;
  const int ci16 = slab % (a.tci / 16), cos = slab / (a.tci / 16);
  const bool active = row < ryg;  // warp-uniform

  float acc[KZ][2][4], sum[KZ][2][4];  // [offset][co 0-7 | 8-15][fragment]
#pragma unroll
  for (int j = 0; j < KZ; ++j)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = sum[j][t][e] = 0.0f;

  // ldmatrix lane roles: matrix m, row r; byte offsets of the lane's chunk
  // in a g row and in an x row, plus the x rows from oy0 to oy0 + row
  const int m = lane >> 3, r = lane & 7;
  const int gcol = (cos * 2 + (m >> 1)) * 16;
  const int xcol = (ci16 * 2 + (m & 1)) * 16 + row * RZ * xrow;
  for (long long n = n_begin; n < n_end; ++n) {
    const int k = (int)(n - n_begin), s = k % a.stages;
    mbar_wait(bar0 + 8 * s, (k / a.stages) & 1);
    const uint32_t xb = xs0 + s * a.x_bytes, gb = gs0 + s * a.g_bytes;

    if (active) {
      // g (16 pos x 16 co): matrices (pos 0-7 | 8-15) x (co 0-7 | 8-15);
      // x (16 ci x 16 pos): matrices (ci 0-7 | 8-15) x (pos 0-7 | 8-15).
      // The next step's fragments are loaded before this step's mma.
      const uint32_t gl = gb + ((m & 1) * 8 + r) * grow + gcol;
      const uint32_t xl = xb + xcol;
      uint32_t bf[4], af[KZ][4];
      ldsm_x4_trans(gl, bf);
      {
        const uint32_t xa = xl + rowtab[(m >> 1) * 8 + r];
#pragma unroll
        for (int j = 0; j < KZ; ++j) ldsm_x4_trans(xa + j * xrow, af[j]);
      }
#pragma unroll 2
      for (int q = 0; q < P; q += 16) {
        const int qn = q + 16 < P ? q + 16 : q;
        uint32_t bn[4], an[KZ][4];
        ldsm_x4_trans(gl + qn * grow, bn);
        const uint32_t xa = xl + rowtab[qn + (m >> 1) * 8 + r];
#pragma unroll
        for (int j = 0; j < KZ; ++j) ldsm_x4_trans(xa + j * xrow, an[j]);
#pragma unroll
        for (int j = 0; j < KZ; ++j) {
          mma16816<T>(acc[j][0], af[j], bf[0], bf[1]);
          mma16816<T>(acc[j][1], af[j], bf[2], bf[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bf[e] = bn[e];
#pragma unroll
          for (int j = 0; j < KZ; ++j) af[j][e] = an[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < KZ; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[j][t][e] += acc[j][t][e];
            acc[j][t][e] = 0.0f;
          }
    }
    __syncthreads();  // stage s is read: refill it
    if (tid == 0 && n + a.stages < n_end) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(n + a.stages, s);
    }
  }

  if (!active) return;
  // accumulator e = 2h + c: ci row lane/4 + 8h, co column 2 (lane % 4) + c
  const int K = a.kx * a.ky * KZ;
#pragma unroll
  for (int j = 0; j < KZ; ++j) {
    const int o = (kxi * a.ky + oy0 + row) * KZ + j;
    float* out = partial + ((long long)blockIdx.z * K + o) * a.Ci * a.Co;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = ci0 + ci16 * 16 + (lane >> 2) + (e >> 1) * 8;
        const int co = co0 + cos * 16 + t * 8 + (lane & 3) * 2 + (e & 1);
        out[(long long)ci * a.Co + co] = sum[j][t][e];
      }
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

static int launch_reduce(const float* partial, float* out, int chunks, int K,
                         int Ci, int Co, cudaStream_t stream) {
  const long long total = (long long)K * Ci * Co;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  dw_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(partial, out, chunks,
                                                         K, Ci, Co);
  return (int)cudaGetLastError();
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

// Host entry point of the CUDA-core kernel, bound with ctypes. dtype: 0
// float32, 1 bfloat16, 2 float16 (x and g alike). partial holds chunks * k^3
// * Ci * Co floats, out k^3 * Ci * Co; chunks * chunk_len must cover
// B*X*Y*Z. Launches both kernels on `stream` without synchronising and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// the contract.
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
  return launch_reduce(partial, out, chunks, kx * ky * kz, Ci, Co, stream);
}

template <typename T, int KZ>
static int launch_mma(const CUtensorMap& tmx, const CUtensorMap& tmg,
                      float* partial, const MmaArgs& a, int chunks,
                      int threads, int smem, cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(
      dw_mma_kernel<T, KZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != 0) return err;
  const dim3 grid(a.kx * ((a.ky + a.ry - 1) / a.ry),
                  (a.Ci / a.tci) * (a.Co / a.tco), chunks);
  dw_mma_kernel<T, KZ><<<grid, threads, smem, stream>>>(tmx, tmg, partial,
                                                         a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_mma_t(const CUtensorMap& tmx, const CUtensorMap& tmg,
                        float* partial, const MmaArgs& a, int chunks,
                        int threads, int smem, cudaStream_t stream) {
  switch (a.kz) {
    case 1:
      return launch_mma<T, 1>(tmx, tmg, partial, a, chunks, threads, smem,
                              stream);
    case 3:
      return launch_mma<T, 3>(tmx, tmg, partial, a, chunks, threads, smem,
                              stream);
    case 5:
      return launch_mma<T, 5>(tmx, tmg, partial, a, chunks, threads, smem,
                              stream);
    case 7:
      return launch_mma<T, 7>(tmx, tmg, partial, a, chunks, threads, smem,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so that
// nothing links libcuda; null if the driver has none.
static PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// Tensor map of a channels-last (B, X, Y, Z, C) 16-bit tensor as 5-D
// (C, Z, Y, X, B), boxes of box[0..4] elements, zeros out of bounds.
static bool tensor_map(CUtensorMap* map, const void* base, int dtype, int B,
                       int X, int Y, int Z, int C, const cuuint32_t* box) {
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)Z, (cuuint64_t)Y,
                              (cuuint64_t)X, (cuuint64_t)B};
  const cuuint64_t strides[4] = {2ull * C, 2ull * C * Z, 2ull * C * Z * Y,
                                 2ull * C * Z * Y * X};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const auto fn = encode_tiled();
  return fn != nullptr &&
         fn(map,
            dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            5, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Host entry point of the tensor-core kernel, bound with ctypes. dtype: 1
// bfloat16, 2 float16; x and g 16-byte aligned; kz in {1, 3, 5, 7}. The
// plan (block channel tile tci x tco of at most two 16 x 16 slabs, brick bb
// x bx x by x bz, ry oy rows per block, stages bricks in flight, chunks of
// bricks_per_chunk bricks) comes from ops/dw_conv.py::plan. partial holds
// chunks * k^3 * Ci * Co floats. Encodes the two tensor maps, sets the
// kernel's dynamic shared memory, launches both kernels on `stream` without
// synchronising and returns the first CUDA error, or cudaErrorInvalidValue
// for a plan outside the contract or a tensor map the driver refuses.
extern "C" int vnet_dw_conv_mma(const void* x, const void* g, float* partial,
                                float* out, int dtype, int B, int X, int Y,
                                int Z, int Ci, int Co, int kx, int ky, int kz,
                                int tci, int tco, int bb, int bx, int by,
                                int bz, int ry, int stages, int chunks,
                                int bricks_per_chunk, cudaStream_t stream) {
  MmaArgs a;
  a.B = B, a.X = X, a.Y = Y, a.Z = Z, a.Ci = Ci, a.Co = Co;
  a.kx = kx, a.ky = ky, a.kz = kz, a.tci = tci, a.tco = tco;
  a.bb = bb, a.bx = bx, a.by = by, a.bz = bz, a.ry = ry, a.stages = stages;
  const bool tiles_ok = (tci == 16 || tci == 32) &&
                        (tco == 16 || tco == 32) && tci * tco <= 512;
  if ((dtype != 1 && dtype != 2) || B < 1 || X < 1 || Y < 1 || Z < 1 ||
      kx < 1 || ky < 1 || kz < 1 || kx % 2 == 0 || ky % 2 == 0 ||
      kz % 2 == 0 || !tiles_ok || Ci % tci != 0 || Co % tco != 0 ||
      bb < 1 || bx < 1 || by < 1 || bz < 1 || ry < 1 || ry > ky ||
      stages < 1 || stages > 4 || chunks < 1 || chunks > 65535 ||
      bricks_per_chunk < 1 || (long long)Ci / tci * (Co / tco) > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)bb * bx * by * bz;
  const int threads = 32 * ry * (tci / 16) * (tco / 16);
  const int RY = by + ry - 1, RZ = bz + kz - 1;
  if (P % 16 != 0 || P > 4096 || threads > 64 * kz || bb > 256 ||
      bx > 256 || RY > 256 || RZ > 256)
    return (int)cudaErrorInvalidValue;
  a.nb_x = (X + bx - 1) / bx, a.nb_y = (Y + by - 1) / by;
  a.nb_z = (Z + bz - 1) / bz;
  const long long bricks =
      (long long)((B + bb - 1) / bb) * a.nb_x * a.nb_y * a.nb_z;
  if (bricks > 0x7fffffff || (long long)chunks * bricks_per_chunk < bricks)
    return (int)cudaErrorInvalidValue;
  a.bricks = (int)bricks, a.bricks_per_chunk = bricks_per_chunk;
  a.x_box = (int)((long long)bb * bx * RY * RZ * (2 * tci + 16));
  a.g_box = (int)(P * (2 * tco + 16));
  a.x_bytes = (a.x_box + 127) / 128 * 128;
  a.g_bytes = (a.g_box + 127) / 128 * 128;
  const long long smem =
      (long long)stages * (a.x_bytes + a.g_bytes) + P * 4 + 8 * stages;
  if (smem > MMA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cuuint32_t xbox[5] = {(cuuint32_t)tci + 8, (cuuint32_t)RZ,
                              (cuuint32_t)RY, (cuuint32_t)bx,
                              (cuuint32_t)bb};
  const cuuint32_t gbox[5] = {(cuuint32_t)tco + 8, (cuuint32_t)bz,
                              (cuuint32_t)by, (cuuint32_t)bx,
                              (cuuint32_t)bb};
  CUtensorMap tmx, tmg;
  if (!tensor_map(&tmx, x, dtype, B, X, Y, Z, Ci, xbox) ||
      !tensor_map(&tmg, g, dtype, B, X, Y, Z, Co, gbox))
    return (int)cudaErrorInvalidValue;
  const int err =
      dtype == 1 ? launch_mma_t<__nv_bfloat16>(tmx, tmg, partial, a, chunks,
                                               threads, (int)smem, stream)
                 : launch_mma_t<__half>(tmx, tmg, partial, a, chunks,
                                        threads, (int)smem, stream);
  if (err != 0) return err;
  return launch_reduce(partial, out, chunks, kx * ky * kz, Ci, Co, stream);
}
