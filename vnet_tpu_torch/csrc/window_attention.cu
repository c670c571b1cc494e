// Shifted-window attention of a Swin block (Swin UNETR's WindowAttention,
// MONAI's monai/networks/nets/swin_unetr.py) on the card, forward and
// backward, with nothing of size (windows, heads, N, N) in device memory.
//
// Replaces no TPU kernel: the JAX package has no transformer. Added because
// the library route writes the scores (or the bias and mask broadcast over
// the windows) as a (B*nW, heads, N, N) tensor in each direction, 0.97 G
// elements a block at stage 1 of a batch of 8 96^3 patches (N = 343).
//
// Layout. `qkv` is the qkv projection of the window-partitioned tokens,
// (BW, N, 3C) bf16 row-major with C = heads * 16: q, k and v of head h are
// its columns [h*16, h*16+16), [C + h*16, ...) and [2C + h*16, ...), read
// in place (no permute copy). `out` and `dout` are (BW, N, C). `bias` is
// the relative-position bias gathered for these N tokens, (heads, N, N)
// float32 (the wrapper's gather of the (T, heads) table by the (N, N)
// index: a few MB, shared by every window). `regions`, for a shifted
// block, is (nW, N) int32: the region of compute_mask's slices each token
// of window w comes from; window row b is window b % nW, and two tokens of
// different regions get -100 added to their score.
//
//   S = scale * q k^T + bias + mask,  P = softmax(S) (float32),  O = P v
//
// Forward (swin_wattn_fwd_kernel): one block of 8 warps a (window, head);
// K and V staged in shared memory, each warp a 16-row query tile; the
// 16x16x16 bf16 tensor-core products (wmma) give S over 32 keys at a time,
// an online float32 softmax folds them in, P (rounded to bf16) times V on
// the tensor cores again. Writes O (bf16) and the row's log-sum-exp.
//
// Backward (swin_wattn_bwd_kernel): one block a (window, head) with Q, K,
// V, dO, the log-sum-exp and D = rowsum(dO * O) staged; each warp owns
// key tiles and walks every query tile: P = exp(S - lse) recomputed,
// dP = dO V^T, dS = P (dP - D); dV += P^T dO and dK += dS^T Q held in the
// warp's accumulators, dQ += dS K added into a shared float32 sum. Writes
// dq, dk, dv into one (BW, N, 3C) bf16 gradient of qkv, and D.
//
// The bias gradient sum_b dS_b (heads, N, N): swin_wattn_dbias_partial_
// kernel, one block a (head, query tile, group of windows), recomputes dS
// of its 16 rows against every key of each window of its group and keeps
// the sums in registers, with the bias rows staged once; each block writes
// its group's partial; swin_wattn_dbias_sum_kernel adds the groups in a
// fixed order. No float atomics on global memory; the wrapper index_adds
// the (heads, N, N) sum into the table.
//
// Bound: bytes at these widths (head width 16: 4*N*16 operations a query
// row and head forward against 2*4*16 bytes of q, k, v, o), so the design
// reads q, k, v once a block, keeps S and P on chip, and the bias (L2
// resident) and masks are formed in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define HD 16       // head width
#define TILE 16     // rows (and keys) a tensor-core tile
#define WARPS 8
#define THREADS (WARPS * 32)
#define MAX_N 343   // the largest window, 7^3
#define MAX_TILES ((MAX_N + TILE - 1) / TILE)
#define KEYS_PER_WARP ((MAX_TILES + WARPS - 1) / WARPS)
#define LD_S 36     // float row stride of a 16 x 32 score chunk
#define LD_P 40     // bf16 row stride of a 16 x 32 probability chunk
#define LD_T 20     // float row stride of a 16 x 16 tile
#define LD_B 24     // bf16 row stride of a 16 x 16 tile
#define MASK_VALUE (-100.0f)

namespace {

struct Geo {
  int bw, heads, n, nw, tiles, npad, c;
  long long row;  // elements between token rows of qkv (3C)
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~(size_t)127;
}

// rows [0, n) of a 16-wide head slice (row stride `stride` elements) into
// shared rows of 16, rows [n, npad) zero; the whole block
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int n,
                                           int npad) {
  for (int u = threadIdx.x; u < npad * 2; u += blockDim.x) {
    const int r = u >> 1, hf = u & 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * stride +
                                            hf * 8);
    *reinterpret_cast<uint4*>(dst + r * HD + hf * 8) = val;
  }
}

// one 16-row tile (rows r0.., row stride `stride`) into a warp's 16 x 16
// shared tile (row stride `ld`), rows past n zero: one 16-byte load a lane
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* src,
                                           long long stride, int r0, int n,
                                           int lane) {
  const int r = lane >> 1, hf = lane & 1;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (r0 + r < n)
    val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride +
                                          hf * 8);
  *reinterpret_cast<uint4*>(dst + r * ld + hf * 8) = val;
}

__device__ __forceinline__ void store8(bf16* dst, const float* v, float mul) {
  __align__(16) bf16 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(v[e] * mul);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}

// ------------------------------------------------------------------ forward
__global__ void __launch_bounds__(THREADS)
    swin_wattn_fwd_kernel(const bf16* __restrict__ qkv,
                          const float* __restrict__ bias,
                          const int* __restrict__ regions,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          Geo g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / g.heads, h = blockIdx.x % g.heads;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + g.npad * HD;
  int* rid = reinterpret_cast<int*>(Vs + g.npad * HD);
  unsigned char* wbase =
      smem + align128((size_t)g.npad * (2 * HD * sizeof(bf16) + sizeof(int)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t per_warp = align128(TILE * HD * sizeof(bf16)) +
                          align128(TILE * LD_S * sizeof(float)) +
                          align128(TILE * LD_P * sizeof(bf16)) +
                          2 * align128(TILE * LD_T * sizeof(float));
  unsigned char* w0 = wbase + warp * per_warp;
  bf16* Qs = reinterpret_cast<bf16*>(w0);
  float* Sb = reinterpret_cast<float*>(w0 + align128(TILE * HD * 2));
  bf16* Pb = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Sb) +
                                     align128(TILE * LD_S * 4));
  float* Ot = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Pb) +
                                       align128(TILE * LD_P * 2));
  float* Oa = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ot) +
                                       align128(TILE * LD_T * 4));

  const bf16* tok = qkv + (long long)b * g.n * g.row;
  stage_rows(Ks, tok + g.c + h * HD, g.row, g.n, g.npad);
  stage_rows(Vs, tok + 2 * g.c + h * HD, g.row, g.n, g.npad);
  const int* wr =
      regions ? regions + (long long)(b % g.nw) * g.n : (const int*)nullptr;
  if (wr)
    for (int j = threadIdx.x; j < g.npad; j += blockDim.x)
      rid[j] = j < g.n ? wr[j] : -1;
  __syncthreads();

  const int r = lane >> 1, hf = lane & 1;
  const float* hbias = bias + (long long)h * g.n * g.n;
  for (int t = warp; t < g.tiles; t += WARPS) {
    const int i = t * TILE + r;
    const bool row_ok = i < g.n;
    stage_tile(Qs, HD, tok + h * HD, g.row, t * TILE, g.n, lane);
    __syncwarp();
    FragA qf;
    wmma::load_matrix_sync(qf, Qs, HD);
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) Oa[r * LD_T + hf * 8 + e] = 0.f;
    const int ri = (wr && row_ok) ? rid[i] : 0;
    const float* brow = hbias + (long long)(row_ok ? i : 0) * g.n;
    for (int c0 = 0; c0 < g.tiles; c0 += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kt = c0 + u;
        if (kt < g.tiles) {
          FragBt kf;
          FragC sf;
          wmma::load_matrix_sync(kf, Ks + kt * TILE * HD, HD);
          wmma::fill_fragment(sf, 0.f);
          wmma::mma_sync(sf, qf, kf, sf);
          wmma::store_matrix_sync(Sb + u * TILE, sf, LD_S,
                                  wmma::mem_row_major);
        }
      }
      __syncwarp();
      float s[16];
      float cmax = -INFINITY;
      const float4* srow =
          reinterpret_cast<const float4*>(Sb + r * LD_S + hf * 16);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const float4 v4 = srow[q4];
        s[4 * q4] = v4.x;
        s[4 * q4 + 1] = v4.y;
        s[4 * q4 + 2] = v4.z;
        s[4 * q4 + 3] = v4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = c0 * TILE + hf * 16 + jj;
        float v = -INFINITY;
        if (j < g.n) {
          v = s[jj] * scale;
          if (row_ok) {
            v += __ldg(brow + j);
            if (wr && rid[j] != ri) v += MASK_VALUE;
          }
        }
        s[jj] = v;
        cmax = fmaxf(cmax, v);
      }
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
      const float mn = fmaxf(m, cmax);
      const float alpha = __expf(m - mn);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float p = __expf(s[jj] - mn);
        ps += p;
        Pb[r * LD_P + hf * 16 + jj] = __float2bfloat16(p);
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      l = l * alpha + ps;
      m = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) Oa[r * LD_T + hf * 8 + e] *= alpha;
      __syncwarp();
      FragC of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kt = c0 + u;
        if (kt < g.tiles) {
          FragA pf;
          FragB vf;
          wmma::load_matrix_sync(pf, Pb + u * TILE, LD_P);
          wmma::load_matrix_sync(vf, Vs + kt * TILE * HD, HD);
          wmma::mma_sync(of, pf, vf, of);
        }
      }
      wmma::store_matrix_sync(Ot, of, LD_T, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e)
        Oa[r * LD_T + hf * 8 + e] += Ot[r * LD_T + hf * 8 + e];
      __syncwarp();
    }
    if (row_ok) {
      store8(out + ((long long)b * g.n + i) * g.c + h * HD + hf * 8,
             Oa + r * LD_T + hf * 8, 1.f / l);
      if (hf == 0) lse[((long long)b * g.heads + h) * g.n + i] = m + logf(l);
    }
    __syncwarp();
  }
}

// ----------------------------------------------------------------- backward
__global__ void __launch_bounds__(THREADS)
    swin_wattn_bwd_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ out,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ bias,
                          const int* __restrict__ regions,
                          bf16* __restrict__ dqkv, float* __restrict__ dvec,
                          Geo g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / g.heads, h = blockIdx.x % g.heads;
  const size_t tile_rows = (size_t)g.npad * HD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + tile_rows;
  bf16* Vs = Ks + tile_rows;
  bf16* dOs = Vs + tile_rows;
  float* dQs = reinterpret_cast<float*>(dOs + tile_rows);
  float* Ls = dQs + tile_rows;
  float* Ds = Ls + g.npad;
  int* rid = reinterpret_cast<int*>(Ds + g.npad);
  unsigned char* wbase =
      smem + align128(tile_rows * (4 * sizeof(bf16) + sizeof(float)) +
                      (size_t)g.npad * (2 * sizeof(float) + sizeof(int)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t per_warp = 2 * align128(TILE * LD_T * sizeof(float)) +
                          2 * align128(TILE * LD_B * sizeof(bf16));
  unsigned char* w0 = wbase + warp * per_warp;
  float* Sf = reinterpret_cast<float*>(w0);
  float* dPf = reinterpret_cast<float*>(w0 + align128(TILE * LD_T * 4));
  bf16* Pb = reinterpret_cast<bf16*>(w0 + 2 * align128(TILE * LD_T * 4));
  bf16* dSb = reinterpret_cast<bf16*>(w0 + 2 * align128(TILE * LD_T * 4) +
                                      align128(TILE * LD_B * 2));

  const long long tok0 = (long long)b * g.n;
  const bf16* tok = qkv + tok0 * g.row;
  stage_rows(Qs, tok + h * HD, g.row, g.n, g.npad);
  stage_rows(Ks, tok + g.c + h * HD, g.row, g.n, g.npad);
  stage_rows(Vs, tok + 2 * g.c + h * HD, g.row, g.n, g.npad);
  stage_rows(dOs, dout + tok0 * g.c + h * HD, g.c, g.n, g.npad);
  const int* wr =
      regions ? regions + (long long)(b % g.nw) * g.n : (const int*)nullptr;
  const long long bh = ((long long)b * g.heads + h) * g.n;
  __syncthreads();
  for (int i = threadIdx.x; i < g.npad; i += blockDim.x) {
    float d = 0.f, lv = 0.f;
    if (i < g.n) {
      const bf16* orow = out + (tok0 + i) * g.c + h * HD;
#pragma unroll
      for (int e = 0; e < HD; ++e)
        d += __bfloat162float(dOs[i * HD + e]) * __bfloat162float(orow[e]);
      lv = lse[bh + i];
      dvec[bh + i] = d;
    }
    Ds[i] = d;
    Ls[i] = lv;
    if (wr) rid[i] = i < g.n ? wr[i] : -1;
  }
  for (int u = threadIdx.x; u < g.npad * HD; u += blockDim.x) dQs[u] = 0.f;
  __syncthreads();

  const int r = lane >> 1, hf = lane & 1;
  const float* hbias = bias + (long long)h * g.n * g.n;
  for (int kt = warp; kt < g.tiles; kt += WARPS) {
    FragC dKf, dVf;
    wmma::fill_fragment(dKf, 0.f);
    wmma::fill_fragment(dVf, 0.f);
    FragBt kf, vf;
    FragB kfr;
    wmma::load_matrix_sync(kf, Ks + kt * TILE * HD, HD);
    wmma::load_matrix_sync(vf, Vs + kt * TILE * HD, HD);
    wmma::load_matrix_sync(kfr, Ks + kt * TILE * HD, HD);
    const int j0 = kt * TILE + hf * 8;
    for (int t = 0; t < g.tiles; ++t) {
      {
        FragA qf, dof;
        FragC sf, dpf;
        wmma::load_matrix_sync(qf, Qs + t * TILE * HD, HD);
        wmma::load_matrix_sync(dof, dOs + t * TILE * HD, HD);
        wmma::fill_fragment(sf, 0.f);
        wmma::fill_fragment(dpf, 0.f);
        wmma::mma_sync(sf, qf, kf, sf);
        wmma::mma_sync(dpf, dof, vf, dpf);
        wmma::store_matrix_sync(Sf, sf, LD_T, wmma::mem_row_major);
        wmma::store_matrix_sync(dPf, dpf, LD_T, wmma::mem_row_major);
      }
      __syncwarp();
      const int i = t * TILE + r;
      const bool row_ok = i < g.n;
      const float li = Ls[i], di = Ds[i];
      const int ri = wr ? rid[i] : 0;
      const float* brow = hbias + (long long)(row_ok ? i : 0) * g.n;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = j0 + e;
        float p = 0.f, ds = 0.f;
        if (row_ok && j < g.n) {
          float s = Sf[r * LD_T + hf * 8 + e] * scale + __ldg(brow + j);
          if (wr && rid[j] != ri) s += MASK_VALUE;
          p = __expf(s - li);
          ds = p * (dPf[r * LD_T + hf * 8 + e] - di);
        }
        Pb[r * LD_B + hf * 8 + e] = __float2bfloat16(p);
        dSb[r * LD_B + hf * 8 + e] = __float2bfloat16(ds);
      }
      __syncwarp();
      {
        FragAt pt, dst;
        FragA dsf;
        FragB qb, dob;
        FragC dqf;
        wmma::load_matrix_sync(pt, Pb, LD_B);
        wmma::load_matrix_sync(dst, dSb, LD_B);
        wmma::load_matrix_sync(dsf, dSb, LD_B);
        wmma::load_matrix_sync(dob, dOs + t * TILE * HD, HD);
        wmma::load_matrix_sync(qb, Qs + t * TILE * HD, HD);
        wmma::mma_sync(dVf, pt, dob, dVf);
        wmma::mma_sync(dKf, dst, qb, dKf);
        wmma::fill_fragment(dqf, 0.f);
        wmma::mma_sync(dqf, dsf, kfr, dqf);
        wmma::store_matrix_sync(Sf, dqf, LD_T, wmma::mem_row_major);
      }
      __syncwarp();
      float* dq = dQs + (t * TILE + r) * HD + hf * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) atomicAdd(dq + e, Sf[r * LD_T + hf * 8 + e]);
      __syncwarp();
    }
    // dK (scaled) and dV of this key tile
    const int j = kt * TILE + r;
    wmma::store_matrix_sync(Sf, dKf, LD_T, wmma::mem_row_major);
    wmma::store_matrix_sync(dPf, dVf, LD_T, wmma::mem_row_major);
    __syncwarp();
    if (j < g.n) {
      bf16* drow = dqkv + (tok0 + j) * g.row + h * HD + hf * 8;
      store8(drow + g.c, Sf + r * LD_T + hf * 8, scale);
      store8(drow + 2 * g.c, dPf + r * LD_T + hf * 8, 1.f);
    }
    __syncwarp();
  }
  __syncthreads();
  for (int u = threadIdx.x; u < g.n * 2; u += blockDim.x) {
    const int i = u >> 1, hf = u & 1;
    store8(dqkv + (tok0 + i) * g.row + h * HD + hf * 8, dQs + i * HD + hf * 8,
           scale);
  }
}

// ----------------------------------------------------- bias gradient: partials
__global__ void __launch_bounds__(THREADS)
    swin_wattn_dbias_partial_kernel(const bf16* __restrict__ qkv,
                                    const bf16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ dvec,
                                    const float* __restrict__ bias,
                                    const int* __restrict__ regions,
                                    float* __restrict__ partial, Geo g,
                                    int per_group, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, t = blockIdx.y, grp = blockIdx.z;
  float* Bs = reinterpret_cast<float*>(smem);  // TILE x npad
  bf16* Qt = reinterpret_cast<bf16*>(
      smem + align128((size_t)TILE * g.npad * sizeof(float)));
  bf16* dOt = Qt + TILE * HD;
  float* Lt = reinterpret_cast<float*>(dOt + TILE * HD);
  float* Dt = Lt + TILE;
  int* ridq = reinterpret_cast<int*>(Dt + TILE);
  int* ridk = ridq + TILE;
  unsigned char* wbase =
      reinterpret_cast<unsigned char*>(Qt) +
      align128(2 * TILE * HD * sizeof(bf16) + 4 * TILE * sizeof(float) +
               (size_t)g.npad * sizeof(int));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t per_warp =
      2 * align128(TILE * HD * sizeof(bf16)) + 2 * align128(TILE * LD_T * 4);
  unsigned char* w0 = wbase + warp * per_warp;
  bf16* Kt = reinterpret_cast<bf16*>(w0);
  bf16* Vt = reinterpret_cast<bf16*>(w0 + align128(TILE * HD * 2));
  float* Sf = reinterpret_cast<float*>(w0 + 2 * align128(TILE * HD * 2));
  float* dPf = reinterpret_cast<float*>(w0 + 2 * align128(TILE * HD * 2) +
                                        align128(TILE * LD_T * 4));

  const float* hbias = bias + (long long)h * g.n * g.n;
  for (int u = threadIdx.x; u < TILE * g.npad; u += blockDim.x) {
    const int rr = u / g.npad, j = u % g.npad, i = t * TILE + rr;
    Bs[u] = (i < g.n && j < g.n) ? hbias[(long long)i * g.n + j] : 0.f;
  }
  const int r = lane >> 1, hf = lane & 1;
  float acc[KEYS_PER_WARP][8];
#pragma unroll
  for (int k = 0; k < KEYS_PER_WARP; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;

  const int w_end = min(g.bw, (grp + 1) * per_group);
  for (int w = grp * per_group; w < w_end; ++w) {
    __syncthreads();
    const long long tok0 = (long long)w * g.n;
    const int* wr =
        regions ? regions + (long long)(w % g.nw) * g.n : (const int*)nullptr;
    if (warp == 0)
      stage_tile(Qt, HD, qkv + tok0 * g.row + h * HD, g.row, t * TILE, g.n,
                 lane);
    else if (warp == 1)
      stage_tile(dOt, HD, dout + tok0 * g.c + h * HD, g.c, t * TILE, g.n,
                 lane);
    else if (warp == 2 && lane < TILE) {
      const int i = t * TILE + lane;
      const long long at = ((long long)w * g.heads + h) * g.n + i;
      Lt[lane] = i < g.n ? lse[at] : 0.f;
      Dt[lane] = i < g.n ? dvec[at] : 0.f;
      ridq[lane] = (wr && i < g.n) ? wr[i] : 0;
    }
    if (wr)
      for (int j = threadIdx.x; j < g.npad; j += blockDim.x)
        ridk[j] = j < g.n ? wr[j] : -1;
    __syncthreads();
    FragA qf, dof;
    wmma::load_matrix_sync(qf, Qt, HD);
    wmma::load_matrix_sync(dof, dOt, HD);
    const int i = t * TILE + r;
    const bool row_ok = i < g.n;
    const float li = Lt[r], di = Dt[r];
    const int ri = ridq[r];
#pragma unroll
    for (int k = 0; k < KEYS_PER_WARP; ++k) {
      const int kt = warp + k * WARPS;
      if (kt >= g.tiles) break;
      const bf16* ktok = qkv + tok0 * g.row + h * HD;
      stage_tile(Kt, HD, ktok + g.c, g.row, kt * TILE, g.n, lane);
      stage_tile(Vt, HD, ktok + 2 * g.c, g.row, kt * TILE, g.n, lane);
      __syncwarp();
      FragBt kf, vf;
      FragC sf, dpf;
      wmma::load_matrix_sync(kf, Kt, HD);
      wmma::load_matrix_sync(vf, Vt, HD);
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(dpf, 0.f);
      wmma::mma_sync(sf, qf, kf, sf);
      wmma::mma_sync(dpf, dof, vf, dpf);
      wmma::store_matrix_sync(Sf, sf, LD_T, wmma::mem_row_major);
      wmma::store_matrix_sync(dPf, dpf, LD_T, wmma::mem_row_major);
      __syncwarp();
      const int j0 = kt * TILE + hf * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = j0 + e;
        if (row_ok && j < g.n) {
          float s = Sf[r * LD_T + hf * 8 + e] * scale + Bs[r * g.npad + j];
          if (wr && ridk[j] != ri) s += MASK_VALUE;
          const float p = __expf(s - li);
          acc[k][e] += p * (dPf[r * LD_T + hf * 8 + e] - di);
        }
      }
      __syncwarp();
    }
  }
  const int i = t * TILE + r;
  if (i < g.n) {
    float* prow =
        partial + (((long long)grp * g.heads + h) * g.n + i) * (long long)g.n;
#pragma unroll
    for (int k = 0; k < KEYS_PER_WARP; ++k) {
      const int kt = warp + k * WARPS;
      if (kt >= g.tiles) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = kt * TILE + hf * 8 + e;
        if (j < g.n) prow[j] = acc[k][e];
      }
    }
  }
}

// ------------------------------------------------- bias gradient: the groups
__global__ void swin_wattn_dbias_sum_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dbias,
                                            long long count, int groups) {
  for (long long u = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       u < count; u += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += partial[(long long)k * count + u];
    dbias[u] = s;
  }
}

size_t fwd_smem(int npad) {
  return align128((size_t)npad * (2 * HD * sizeof(bf16) + sizeof(int))) +
         WARPS * (align128(TILE * HD * sizeof(bf16)) +
                  align128(TILE * LD_S * sizeof(float)) +
                  align128(TILE * LD_P * sizeof(bf16)) +
                  2 * align128(TILE * LD_T * sizeof(float)));
}

size_t bwd_smem(int npad) {
  const size_t rows = (size_t)npad * HD;
  return align128(rows * (4 * sizeof(bf16) + sizeof(float)) +
                  (size_t)npad * (2 * sizeof(float) + sizeof(int))) +
         WARPS * (2 * align128(TILE * LD_T * sizeof(float)) +
                  2 * align128(TILE * LD_B * sizeof(bf16)));
}

size_t dbias_smem(int npad) {
  return align128((size_t)TILE * npad * sizeof(float)) +
         align128(2 * TILE * HD * sizeof(bf16) + 4 * TILE * sizeof(float) +
                  (size_t)npad * sizeof(int)) +
         WARPS * (2 * align128(TILE * HD * sizeof(bf16)) +
                  2 * align128(TILE * LD_T * sizeof(float)));
}

int geometry(int bw, int heads, int n, int nw, Geo& g) {
  if (bw < 1 || heads < 1 || n < 1 || n > MAX_N || nw < 1 || bw % nw != 0)
    return (int)cudaErrorInvalidValue;
  g.bw = bw;
  g.heads = heads;
  g.n = n;
  g.nw = nw;
  g.tiles = (n + TILE - 1) / TILE;
  g.npad = g.tiles * TILE;
  g.c = heads * HD;
  g.row = 3LL * g.c;
  return 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int vnet_swin_wattn_fwd(const void* qkv, const float* bias,
                                   const int* regions, void* out, float* lse,
                                   int bw, int heads, int n, int nw,
                                   float scale, cudaStream_t stream) {
  Geo g;
  int err = geometry(bw, heads, n, nw, g);
  if (err != 0) return err;
  if (!aligned16(qkv) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = fwd_smem(g.npad);
  cudaFuncSetAttribute(swin_wattn_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  swin_wattn_fwd_kernel<<<(unsigned)(bw * heads), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), bias, regions, static_cast<bf16*>(out),
      lse, g, scale);
  return (int)cudaGetLastError();
}

extern "C" int vnet_swin_wattn_bwd(const void* qkv, const void* out,
                                   const void* dout, const float* lse,
                                   const float* bias, const int* regions,
                                   void* dqkv, float* dvec, int bw, int heads,
                                   int n, int nw, float scale,
                                   cudaStream_t stream) {
  Geo g;
  int err = geometry(bw, heads, n, nw, g);
  if (err != 0) return err;
  if (!aligned16(qkv) || !aligned16(out) || !aligned16(dout) ||
      !aligned16(dqkv))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = bwd_smem(g.npad);
  cudaFuncSetAttribute(swin_wattn_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  swin_wattn_bwd_kernel<<<(unsigned)(bw * heads), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, bias, regions,
      static_cast<bf16*>(dqkv), dvec, g, scale);
  return (int)cudaGetLastError();
}

extern "C" int vnet_swin_wattn_dbias(const void* qkv, const void* dout,
                                     const float* lse, const float* dvec,
                                     const float* bias, const int* regions,
                                     float* partial, float* dbias, int bw,
                                     int heads, int n, int nw, int groups,
                                     float scale, cudaStream_t stream) {
  Geo g;
  int err = geometry(bw, heads, n, nw, g);
  if (err != 0) return err;
  if (groups < 1 || groups > bw) return (int)cudaErrorInvalidValue;
  if (!aligned16(qkv) || !aligned16(dout))
    return (int)cudaErrorMisalignedAddress;
  const int per_group = (bw + groups - 1) / groups;
  if ((long long)(groups - 1) * per_group >= bw)
    return (int)cudaErrorInvalidValue;  // every group holds a window
  const size_t smem = dbias_smem(g.npad);
  cudaFuncSetAttribute(swin_wattn_dbias_partial_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((unsigned)heads, (unsigned)g.tiles, (unsigned)groups);
  swin_wattn_dbias_partial_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), lse,
      dvec, bias, regions, partial, g, per_group, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long count = (long long)heads * n * n;
  const int blocks = (int)((count + 255) / 256 < 132 * 8 ? (count + 255) / 256
                                                         : 132 * 8);
  swin_wattn_dbias_sum_kernel<<<blocks, 256, 0, stream>>>(partial, dbias,
                                                          count, groups);
  return (int)cudaGetLastError();
}
