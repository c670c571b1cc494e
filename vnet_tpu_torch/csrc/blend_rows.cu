// Row-segment blend: ordered scatter-add of windowed segment contributions
// into flat accumulators, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/fused.py::blend_accumulate_rows.
// For N segments of r rows each, contributions probs (N, r, C) f32, a window
// (r, 1) f32 and row starts s_i:
//
//     for i = 0 .. N-1 in order:
//         acc[s_i : s_i + r, :]  += probs[i] * window
//         weight[s_i : s_i + r]  += window
//
// with acc (R, C) and weight (R, 1) float32, updated in place.
//
// Order. The TPU kernel is race-free because its grid runs in sequence. Here
// the design is owner-computes over row tiles: the rows are cut into tiles of
// T rows (T a multiple of the block, T >= r, so a segment meets at most two
// tiles), and a plan lists, for each tile, the segments that meet it in
// increasing index (a CSR: tile_ptr, seg_idx; ops/blend.py::plan_row_tiles
// builds it on the device). A block takes one tile; a thread owns one row at
// a time, keeps its accumulator values and its weight in registers, walks the
// tile's list in index order, adds __fmul_rn(p, w) with __fadd_rn for every
// segment that covers its row, as the loop's `acc + probs * window` rounds,
// and writes the row once. Every element receives its adds in segment order,
// so the result is bitwise equal to the loop; no two threads write one
// address, there are no atomics and there is one launch per call, whatever
// the overlap depth.
//
// Cost. Bound by memory bandwidth: each covered row of acc and weight is read
// and written once and each contribution read once; the window and the
// tile's list (staged through shared memory, a broadcast read per segment)
// stay on chip. Threads of consecutive rows read a segment's contributions as
// one contiguous run. Rows that no segment covers are not touched. Offsets
// inside a tile are 32-bit and no element divides. More than 8 channels take
// several passes of 8 over the tile, each reading and writing its channels
// once.

#include <cuda_runtime.h>

#define VNET_ROWS_THREADS 256  // threads per block; T is a multiple
#define VNET_ROWS_GROUP 8      // channels held in registers per pass

template <int G>
__global__ void __launch_bounds__(VNET_ROWS_THREADS)
    blend_rows_kernel(float* __restrict__ acc, float* __restrict__ weight,
                      const float* __restrict__ probs,
                      const float* __restrict__ window,
                      const int* __restrict__ starts,
                      const int* __restrict__ tile_ptr,
                      const int* __restrict__ seg_idx, int tile, int r,
                      int channels) {
  __shared__ int sh_seg[VNET_ROWS_THREADS];
  __shared__ int sh_start[VNET_ROWS_THREADS];
  const int lo = tile_ptr[blockIdx.x], hi = tile_ptr[blockIdx.x + 1];
  if (lo == hi) return;
  const int tile0 = blockIdx.x * tile;
  int staged = -1;  // first list entry held in shared memory (block-uniform)
  for (int c0 = 0; c0 < channels; c0 += G) {
    for (int k = threadIdx.x; k < tile; k += VNET_ROWS_THREADS) {
      const int row = tile0 + k;
      float a[G];
      float w_sum = 0.0f;
      bool loaded = false;
      for (int base = lo; base < hi; base += VNET_ROWS_THREADS) {
        const int m = min(VNET_ROWS_THREADS, hi - base);
        if (base != staged) {
          __syncthreads();
          if ((int)threadIdx.x < m) {
            const int i = seg_idx[base + threadIdx.x];
            sh_seg[threadIdx.x] = i;
            sh_start[threadIdx.x] = starts[i];
          }
          __syncthreads();
          staged = base;
        }
        for (int e = 0; e < m; ++e) {
          const unsigned o = (unsigned)(row - sh_start[e]);
          if (o >= (unsigned)r) continue;
          if (!loaded) {
            const float* src = acc + (long long)row * channels + c0;
#pragma unroll
            for (int j = 0; j < G; ++j) {
              a[j] = c0 + j < channels ? src[j] : 0.0f;
            }
            if (c0 == 0) w_sum = weight[row];
            loaded = true;
          }
          const float w = window[o];
          const float* p =
              probs + ((long long)sh_seg[e] * r + o) * channels + c0;
#pragma unroll
          for (int j = 0; j < G; ++j) {
            if (c0 + j < channels) a[j] = __fadd_rn(a[j], __fmul_rn(p[j], w));
          }
          if (c0 == 0) w_sum = __fadd_rn(w_sum, w);
        }
      }
      if (loaded) {
        float* dst = acc + (long long)row * channels + c0;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (c0 + j < channels) dst[j] = a[j];
        }
        if (c0 == 0) weight[row] = w_sum;
      }
    }
  }
}

// Host entry point, bound with ctypes: one launch, a block per tile.
// `starts` holds all N row starts, `tile_ptr` num_tiles + 1 offsets into
// `seg_idx`, all on the device and checked by the caller (0 <= s,
// s + r <= R < 2^31; each tile's list in increasing segment index). Launches
// on `stream` without synchronising and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside the contract.
extern "C" int vnet_blend_rows(float* acc, float* weight, const float* probs,
                               const float* window, const int* starts,
                               const int* tile_ptr, const int* seg_idx,
                               int num_tiles, int tile, int r, int channels,
                               cudaStream_t stream) {
  if (num_tiles < 1 || r < 1 || channels < 1 || tile < r ||
      tile % VNET_ROWS_THREADS != 0 ||
      (long long)num_tiles * tile > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int g = channels < VNET_ROWS_GROUP ? channels : VNET_ROWS_GROUP;
  const dim3 grid(num_tiles), block(VNET_ROWS_THREADS);
#define VNET_ROWS_CASE(G)                                                   \
  case G:                                                                   \
    blend_rows_kernel<G><<<grid, block, 0, stream>>>(                       \
        acc, weight, probs, window, starts, tile_ptr, seg_idx, tile, r,     \
        channels);                                                          \
    break;
  switch (g) {
    VNET_ROWS_CASE(1)
    VNET_ROWS_CASE(2)
    VNET_ROWS_CASE(3)
    VNET_ROWS_CASE(4)
    VNET_ROWS_CASE(5)
    VNET_ROWS_CASE(6)
    VNET_ROWS_CASE(7)
    VNET_ROWS_CASE(8)
  }
#undef VNET_ROWS_CASE
  return (int)cudaGetLastError();
}
