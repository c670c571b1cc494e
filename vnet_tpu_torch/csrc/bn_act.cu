// Batch norm and the activation after it, fused, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm -> activation to
// XLA, which fuses the chain itself. The port ran it as about ten eager
// float32 passes forward and twenty backward; these kernels do the same
// arithmetic in three passes beside bn_stats.cu's sums (ops/bn_act.py binds
// them, with their plain versions).
//
// Layout: a row-major (rows, Cp) view of channels-last storage, Cp = G * C
// packed channels, offset-major (column j is base channel j % C). x, y, dy
// and dx are float32, bfloat16 or float16; every per-channel vector is
// float32 of length C. Per base channel c, over every row and group:
//
//   stats:  (sum x, sum x^2) per packed column: bn_stats.cu, not here
//   apply:  mean = T0 / n, E[x^2] = T1 / n, T the stats of the G columns of
//           channel c added in group order (n = rows * G)
//           var  = E[x^2] - mean^2 (clipped at 0 unpacked) or the running one
//           inv  = rsqrt(var + eps), mul = inv * gamma
//           z    = T((x - mean) * mul + beta)     float32, rounded once to T
//           y    = act(z) in T: relu, leaky relu 0.01, prelu (z > 0 ? z :
//                  T(T(alpha) * z)) or none
//           saved = (mean, inv); in training the running averages
//           r = 0.99 r + 0.01 batch, both written by block (0, 0)
//   grad:   dz = dy * act'(z) (z recomputed from x as above), xhat =
//           (x - mean) * inv; sums (sum dz, sum dz * xhat, sum dy * min(z, 0))
//   dx:     dx = mul * (dz - S0 / n - xhat * S1 / n)   (S: the sums, averaged
//           over the ranks by the caller; none with running averages)
//
// Rounding. Every float32 operation of apply is the eager chain's, one
// operator at a time: __fsub_rn, __fmul_rn and __fadd_rn keep nvcc from
// contracting a multiply and an add into an FMA, so given the same sums
// the output is bitwise the chain's. The sums and dx are float32 in another
// order than autograd's chain (which rounds dz to T first).
//
// Design. Every pass is bound by memory bandwidth: apply reads x and writes
// y, grad reads x and dy, dx reads x and dy and writes dx. A block (chunk,
// slab) walks one contiguous chunk of rows and one slab of at most 256
// channel groups of VEC channels (16 bytes: 8 bf16/f16 or 4
// f32; one channel when Cp * sizeof(T) is not a multiple of 16 or the data
// is not 16-byte aligned, as the output norm's C = 3). A thread keeps the
// per-channel constants of its VEC channels in registers for the whole
// chunk, so the elementwise loop reads nothing but x (and dy). The
// gradient sums write per-block float32 partials (chunks, K, Cp), added in
// a fixed order by a second kernel that also folds the G offset groups: no
// float atomics, the same bits from run to run. apply folds the groups of
// the forward's sums (bn_stats.cu's, per packed column) for its slab's
// columns into shared memory before its loop. Forward: bn_stats' two
// launches and one apply; backward: two for the sums and one dx.
//
// Kernel names avoid the words the benchmark's trace groups read as
// convolutions, matrix products, the optimizer or copies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define BA_THREADS 256
#define BA_MAXVEC 8

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_PRELU = 3 };
// what apply's two statistics vectors hold
enum { STATS_RUNNING = 0, STATS_MOMENTS = 1, STATS_MOMENTS_CLIPPED = 2 };

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

// VEC values (each exact in T) stored as T; one 16-byte store when VEC
// fills 16 bytes.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(v[i]);
  }
}

// The activation of z (a value of T) in T, as the eager modules compute it:
// F.relu, F.leaky_relu(z, 0.01), clamp_min(z, 0) + alpha * clamp_max(z, 0).
// A NaN passes through.
template <typename T, int ACT>
__device__ __forceinline__ float act_fwd(float z, float alpha) {
  if constexpr (ACT == ACT_RELU) return z < 0.0f ? 0.0f : z;
  if constexpr (ACT == ACT_LRELU) return z > 0.0f ? z : rnd<T>(__fmul_rn(z, 0.01f));
  if constexpr (ACT == ACT_PRELU) return z > 0.0f ? z : rnd<T>(__fmul_rn(alpha, z));
  return z;
}

// dy * act'(z) in float32.
template <int ACT>
__device__ __forceinline__ float act_bwd(float z, float dy, float alpha) {
  if constexpr (ACT == ACT_RELU) return z > 0.0f ? dy : 0.0f;
  if constexpr (ACT == ACT_LRELU) return z > 0.0f ? dy : dy * 0.01f;
  if constexpr (ACT == ACT_PRELU) return z > 0.0f ? dy : dy * alpha;
  return dy;
}

// The block's place: slab of channel groups, row lanes, this thread's first
// column c0; `active` is false for the threads left over when the slab's
// group count does not divide BA_THREADS.
struct Place {
  int gb, lanes, lane, gl, c0;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Place place(int Cp) {
  Place p;
  const int G = Cp / VEC;
  const int g0 = blockIdx.y * BA_THREADS;
  p.gb = min(G - g0, BA_THREADS);
  p.lanes = BA_THREADS / p.gb;
  p.lane = threadIdx.x / p.gb;
  p.gl = threadIdx.x % p.gb;
  p.c0 = (g0 + p.gl) * VEC;
  p.active = p.lane < p.lanes;
  return p;
}

// The per-channel constants of a thread's VEC columns, from the saved (mean,
// inv) or, in apply, from the statistics.
template <typename T, int VEC, int ACT>
struct Consts {
  float mean[VEC], mul[VEC], beta[VEC], alpha[VEC];

  __device__ __forceinline__ void load(int c0, int C, const float* mean_v,
                                       const float* inv_v, const float* gamma,
                                       const float* beta_v,
                                       const float* alpha_v) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = (c0 + i) % C;
      mean[i] = mean_v[c];
      mul[i] = __fmul_rn(inv_v[c], gamma[c]);
      beta[i] = beta_v[c];
      alpha[i] = ACT == ACT_PRELU ? rnd<T>(alpha_v[c]) : 0.0f;
    }
  }

  // z = T((x - mean) * mul + beta), the eager chain's three operators
  __device__ __forceinline__ float z(int i, float x) const {
    return rnd<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, mean[i]), mul[i]), beta[i]));
  }
};

// (mean, var) of base channel c from apply's statistics: the running ones
// (C), or the sums (Cp = G * C) whose G columns of c are added in group
// order and divided by n in float64, as ops/bn_act.py's fold_moments.
__device__ __forceinline__ void mean_var(const float* first,
                                         const float* second, int kind, int G,
                                         long long n, int C, int c,
                                         float& mean, float& var) {
  if (kind == STATS_RUNNING) {
    mean = first[c];
    var = second[c];
    return;
  }
  float s0 = first[c], s1 = second[c];
  for (int g = 1; g < G; ++g) {
    s0 = __fadd_rn(s0, first[g * C + c]);
    s1 = __fadd_rn(s1, second[g * C + c]);
  }
  mean = (float)((double)s0 / (double)n);
  const float sq = (float)((double)s1 / (double)n);
  var = __fsub_rn(sq, __fmul_rn(mean, mean));
  if (kind == STATS_MOMENTS_CLIPPED) var = var < 0.0f ? 0.0f : var;
}

// --------------------------------------------------------------------------
// partial gradient sums: (dz, dz * xhat) and, for PReLU, dy * min(z, 0).
// partial is (chunks, K, Cp).
// --------------------------------------------------------------------------
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(BA_THREADS) bn_act_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ saved, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ alpha,
    float* __restrict__ partial, long long rows, int Cp, int C,
    long long chunk_rows) {
  constexpr int K = ACT == ACT_PRELU ? 3 : 2;
  __shared__ float red[K][BA_THREADS * BA_MAXVEC];
  const Place p = place<VEC>(Cp);
  const int width = p.gb * VEC;

  float s[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[k][i] = 0.0f;
  if (p.active) {
    Consts<T, VEC, ACT> k;
    k.load(p.c0, C, saved, saved + C, gamma, beta, alpha);
    float inv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) inv[i] = saved[C + (p.c0 + i) % C];
    const long long r_begin = (long long)blockIdx.x * chunk_rows;
    const long long r_end =
        r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
#pragma unroll 4
    for (long long r = r_begin + p.lane; r < r_end; r += p.lanes) {
      float vx[VEC], vg[VEC];
      load_vec<T, VEC>(x + r * Cp + p.c0, vx);
      load_vec<T, VEC>(dy + r * Cp + p.c0, vg);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float z = k.z(i, vx[i]);
        const float dz = act_bwd<ACT>(z, vg[i], k.alpha[i]);
        const float xhat = (vx[i] - k.mean[i]) * inv[i];
        s[0][i] += dz;
        s[1][i] = fmaf(dz, xhat, s[1][i]);
        if constexpr (K == 3) s[K - 1][i] += z < 0.0f ? vg[i] * z : 0.0f;
      }
    }
#pragma unroll
    for (int k2 = 0; k2 < K; ++k2)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[k2][p.lane * width + p.gl * VEC + i] = s[k2][i];
  }
  __syncthreads();
  const int g0 = blockIdx.y * BA_THREADS;
  for (int e = threadIdx.x; e < K * width; e += BA_THREADS) {
    const int k2 = e / width, ch = e % width;
    float t = 0.0f;
    for (int l = 0; l < p.lanes; ++l) t += red[k2][l * width + ch];
    partial[((long long)blockIdx.x * K + k2) * Cp + g0 * VEC + ch] = t;
  }
}

// out[k, c] = sum over chunks and groups g of partial[chunk, k, g * C + c].
// One block per output: thread-strided sums, then a fixed tree in shared
// memory.
__global__ void __launch_bounds__(BA_THREADS) bn_act_fold_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int chunks,
    int K, int Cp, int C) {
  __shared__ float red[BA_THREADS];
  const int k = blockIdx.x / C, c = blockIdx.x % C;
  const int G = Cp / C;
  const long long terms = (long long)chunks * G;
  float s = 0.0f;
  for (long long t = threadIdx.x; t < terms; t += BA_THREADS) {
    const long long chunk = t / G;
    const int g = (int)(t % G);
    s += partial[(chunk * K + k) * Cp + g * C + c];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = BA_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// --------------------------------------------------------------------------
// apply: y = act(T((x - mean) * mul + beta)); every block first puts the
// (mean, var) of its slab's columns in shared memory; the blocks of the
// first chunk write saved and update the running averages of the base
// channels among their columns (running_mean null: no update).
// --------------------------------------------------------------------------
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(BA_THREADS) bn_act_apply_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* first,
    const float* second, int kind, long long n,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ alpha, float* __restrict__ saved,
    float* running_mean, float* running_var, float momentum, float rest,
    float eps, long long rows, int Cp, int C, long long chunk_rows) {
  __shared__ float stat[2][BA_THREADS * BA_MAXVEC];  // mean, var a column
  const Place p = place<VEC>(Cp);
  const int col0 = blockIdx.y * BA_THREADS * VEC;
  for (int e = threadIdx.x; e < p.gb * VEC; e += BA_THREADS) {
    const int col = col0 + e, c = col % C;
    float mean, var;
    mean_var(first, second, kind, Cp / C, n, C, c, mean, var);
    stat[0][e] = mean;
    stat[1][e] = var;
    if (blockIdx.x == 0 && col < C) {
      saved[c] = mean;
      saved[C + c] = rsqrtf(__fadd_rn(var, eps));
      if (running_mean != nullptr) {
        running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], momentum),
                                    __fmul_rn(mean, rest));
        running_var[c] = __fadd_rn(__fmul_rn(running_var[c], momentum),
                                   __fmul_rn(var, rest));
      }
    }
  }
  __syncthreads();
  if (!p.active) return;
  Consts<T, VEC, ACT> k;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = (p.c0 + i) % C;
    k.mean[i] = stat[0][p.gl * VEC + i];
    k.mul[i] = __fmul_rn(rsqrtf(__fadd_rn(stat[1][p.gl * VEC + i], eps)),
                         gamma[c]);
    k.beta[i] = beta[c];
    k.alpha[i] = ACT == ACT_PRELU ? rnd<T>(alpha[c]) : 0.0f;
  }
  const long long r_begin = (long long)blockIdx.x * chunk_rows;
  const long long r_end =
      r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
#pragma unroll 4
  for (long long r = r_begin + p.lane; r < r_end; r += p.lanes) {
    float v[VEC];
    load_vec<T, VEC>(x + r * Cp + p.c0, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = act_fwd<T, ACT>(k.z(i, v[i]), k.alpha[i]);
    store_vec<T, VEC>(y + r * Cp + p.c0, v);
  }
}

// --------------------------------------------------------------------------
// dx = mul * (dz - S0 / n - xhat * S1 / n); sums null: dx = mul * dz.
// --------------------------------------------------------------------------
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(BA_THREADS) bn_act_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
    const float* __restrict__ saved, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ alpha,
    const float* __restrict__ sums, long long n, long long rows, int Cp,
    int C, long long chunk_rows) {
  const Place p = place<VEC>(Cp);
  if (!p.active) return;
  Consts<T, VEC, ACT> k;
  k.load(p.c0, C, saved, saved + C, gamma, beta, alpha);
  float inv[VEC], m0[VEC], m1[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = (p.c0 + i) % C;
    inv[i] = saved[C + c];
    m0[i] = sums != nullptr ? sums[c] / (float)n : 0.0f;
    m1[i] = sums != nullptr ? sums[C + c] / (float)n : 0.0f;
  }
  const long long r_begin = (long long)blockIdx.x * chunk_rows;
  const long long r_end =
      r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
#pragma unroll 4
  for (long long r = r_begin + p.lane; r < r_end; r += p.lanes) {
    float vx[VEC], vg[VEC];
    load_vec<T, VEC>(x + r * Cp + p.c0, vx);
    load_vec<T, VEC>(dy + r * Cp + p.c0, vg);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float dz = act_bwd<ACT>(k.z(i, vx[i]), vg[i], k.alpha[i]);
      const float xhat = (vx[i] - k.mean[i]) * inv[i];
      vx[i] = rnd<T>(k.mul[i] * (dz - m0[i] - xhat * m1[i]));
    }
    store_vec<T, VEC>(dx + r * Cp + p.c0, vx);
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------
struct Geometry {
  long long rows;
  int Cp, C, vec, chunks;
  long long chunk_rows;
};

template <typename T>
static int grid_of(const Geometry& g, dim3& grid) {
  constexpr int V = 16 / sizeof(T);
  if (g.rows < 1 || g.C < 1 || g.Cp < g.C || g.Cp % g.C != 0 ||
      g.chunks < 1 || g.chunk_rows < 1 ||
      (long long)g.chunks * g.chunk_rows < g.rows || (g.vec && g.Cp % V != 0))
    return (int)cudaErrorInvalidValue;
  const int groups = g.Cp / (g.vec ? V : 1);
  const int slabs = (groups + BA_THREADS - 1) / BA_THREADS;
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned)g.chunks, (unsigned)slabs);
  return 0;
}

// the kernel of (T, VEC, ACT) chosen at run time: the statement after the
// arguments, with T, V and A bound
#define BA_DISPATCH_ACT(ACT_V, ...)                                     \
  switch (ACT_V) {                                                      \
    case ACT_NONE: { constexpr int A = ACT_NONE; __VA_ARGS__; break; }   \
    case ACT_RELU: { constexpr int A = ACT_RELU; __VA_ARGS__; break; }   \
    case ACT_LRELU: { constexpr int A = ACT_LRELU; __VA_ARGS__; break; } \
    case ACT_PRELU: { constexpr int A = ACT_PRELU; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;                         \
  }

#define BA_DISPATCH_VEC(VEC_ON, WIDE, ACT_V, ...)                        \
  if (VEC_ON) {                                                         \
    constexpr int V = WIDE;                                             \
    BA_DISPATCH_ACT(ACT_V, __VA_ARGS__)                                 \
  } else {                                                              \
    constexpr int V = 1;                                                \
    BA_DISPATCH_ACT(ACT_V, __VA_ARGS__)                                 \
  }

#define BA_DISPATCH(DTYPE, VEC_ON, ACT_V, ...)                          \
  switch (DTYPE) {                                                      \
    case 0: {                                                           \
      using T = float;                                                  \
      BA_DISPATCH_VEC(VEC_ON, 4, ACT_V, __VA_ARGS__)                    \
      break;                                                            \
    }                                                                   \
    case 1: {                                                           \
      using T = __nv_bfloat16;                                          \
      BA_DISPATCH_VEC(VEC_ON, 8, ACT_V, __VA_ARGS__)                    \
      break;                                                            \
    }                                                                   \
    case 2: {                                                           \
      using T = __half;                                                 \
      BA_DISPATCH_VEC(VEC_ON, 8, ACT_V, __VA_ARGS__)                    \
      break;                                                            \
    }                                                                   \
    default:                                                            \
      return (int)cudaErrorInvalidValue;                                \
  }

static int grid_for(int dtype, const Geometry& g, dim3& grid) {
  switch (dtype) {
    case 0: return grid_of<float>(g, grid);
    case 1: return grid_of<__nv_bfloat16>(g, grid);
    case 2: return grid_of<__half>(g, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Host entry points, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16; act: 0 none, 1 relu, 2 leaky relu 0.01, 3 prelu; vec = 1 takes
// 16-byte loads (Cp a multiple of 16 / sizeof(T), 16-byte aligned data);
// chunks * chunk_rows must cover rows. Per-channel vectors are float32 of
// length C (apply's sums: Cp); saved is (2, C): mean, inv. Each launches
// on `stream` without synchronising and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside the contract.

// y = act(norm(x)); kind: 0 (first, second) = running (mean, var) of
// length C, 1 the sums (sum x, sum x^2) of length Cp over n = rows * G
// values a channel (bn_stats.cu's, averaged over the ranks by the caller),
// 2 the sums with the variance clipped at 0. running_mean / running_var
// null: no update. One kernel.
extern "C" int vnet_bn_act_apply(const void* x, void* y, const float* first,
                                 const float* second, int kind, long long n,
                                 const float* gamma, const float* beta,
                                 const float* alpha, float* saved,
                                 float* running_mean, float* running_var,
                                 float momentum, float rest, float eps,
                                 int act, int dtype, long long rows, int Cp,
                                 int C, int vec, int chunks,
                                 long long chunk_rows, cudaStream_t stream) {
  const Geometry g{rows, Cp, C, vec, chunks, chunk_rows};
  dim3 grid;
  const int err = grid_for(dtype, g, grid);
  if (err != 0) return err;
  if (kind < STATS_RUNNING || kind > STATS_MOMENTS_CLIPPED ||
      (kind != STATS_RUNNING && n < 1) ||
      (act == ACT_PRELU && alpha == nullptr) ||
      ((running_mean == nullptr) != (running_var == nullptr)))
    return (int)cudaErrorInvalidValue;
  BA_DISPATCH(dtype, vec, act,
              bn_act_apply_kernel<T, V, A><<<grid, BA_THREADS, 0, stream>>>(
                  static_cast<const T*>(x), static_cast<T*>(y), first, second,
                  kind, n, gamma, beta, alpha, saved, running_mean,
                  running_var, momentum, rest, eps, rows, Cp, C, chunk_rows));
  return (int)cudaGetLastError();
}

// sums (3, C): sum dz, sum dz * xhat, sum dy * min(z, 0) (the last only for
// prelu, else left as it is); partial holds chunks * 3 * Cp floats. Two
// kernels.
extern "C" int vnet_bn_act_grad_sums(const void* dy, const void* x,
                                     const float* saved, const float* gamma,
                                     const float* beta, const float* alpha,
                                     float* partial, float* sums, int act,
                                     int dtype, long long rows, int Cp, int C,
                                     int vec, int chunks,
                                     long long chunk_rows,
                                     cudaStream_t stream) {
  const Geometry g{rows, Cp, C, vec, chunks, chunk_rows};
  dim3 grid;
  int err = grid_for(dtype, g, grid);
  if (err != 0) return err;
  if (act == ACT_PRELU && alpha == nullptr) return (int)cudaErrorInvalidValue;
  BA_DISPATCH(dtype, vec, act,
              bn_act_partial_kernel<T, V, A><<<grid, BA_THREADS, 0, stream>>>(
                  static_cast<const T*>(x), static_cast<const T*>(dy), saved,
                  gamma, beta, alpha, partial, rows, Cp, C, chunk_rows));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int K = act == ACT_PRELU ? 3 : 2;
  bn_act_fold_kernel<<<K * C, BA_THREADS, 0, stream>>>(partial, sums, chunks,
                                                       K, Cp, C);
  return (int)cudaGetLastError();
}

// dx; sums (2, C) averaged over the ranks, or null with running averages.
// One kernel.
extern "C" int vnet_bn_act_dx(const void* dy, const void* x, void* dx,
                              const float* saved, const float* gamma,
                              const float* beta, const float* alpha,
                              const float* sums, long long n, int act,
                              int dtype, long long rows, int Cp, int C,
                              int vec, int chunks, long long chunk_rows,
                              cudaStream_t stream) {
  const Geometry g{rows, Cp, C, vec, chunks, chunk_rows};
  dim3 grid;
  const int err = grid_for(dtype, g, grid);
  if (err != 0) return err;
  if ((act == ACT_PRELU && alpha == nullptr) || n < 1)
    return (int)cudaErrorInvalidValue;
  BA_DISPATCH(dtype, vec, act,
              bn_act_dx_kernel<T, V, A><<<grid, BA_THREADS, 0, stream>>>(
                  static_cast<const T*>(x), static_cast<const T*>(dy),
                  static_cast<T*>(dx), saved, gamma, beta, alpha, sums, n,
                  rows, Cp, C, chunk_rows));
  return (int)cudaGetLastError();
}
