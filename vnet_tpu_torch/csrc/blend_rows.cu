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
// the host gives every segment a level, 1 + the deepest level of the earlier
// segments that overlap it (all segments have r rows, so i and j overlap iff
// |s_i - s_j| < r), and launches this kernel once per level, in increasing
// order, over that level's segments. No two segments of one level overlap,
// so one thread per (segment, row, channel or weight) writes each address at
// most once per launch, with no atomics. Two segments that cover one row
// overlap, so their levels increase with their index: every element receives
// its adds in segment order, and __fmul_rn then __fadd_rn round each add as
// the plain loop's `acc + probs * window` does, so the result is bitwise
// equal to it. The number of launches is the deepest overlap chain, not N.
//
// Cost. Bound by memory bandwidth: per level, each covered acc and weight
// element is read and written once and each contribution read once; the
// window and the level's segment list are small and stay in cache. Threads
// with consecutive indices take consecutive channels and rows of a segment,
// so accesses of acc and probs are contiguous.

#include <cuda_runtime.h>

__global__ void blend_rows_kernel(float* __restrict__ acc,
                                  float* __restrict__ weight,
                                  const float* __restrict__ probs,
                                  const float* __restrict__ window,
                                  const int* __restrict__ seg,
                                  const int* __restrict__ starts, int count,
                                  int r, int C) {
  const long long total = (long long)count * r * (C + 1);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int k = (int)(i % (C + 1));
    const long long t = i / (C + 1);
    const int row = (int)(t % r);
    const int s = seg[t / r];
    const long long dst = (long long)starts[s] + row;
    const float w = window[row];
    if (k < C) {
      const float p = probs[((long long)s * r + row) * C + k];
      acc[dst * C + k] = __fadd_rn(acc[dst * C + k], __fmul_rn(p, w));
    } else {
      weight[dst] = __fadd_rn(weight[dst], w);
    }
  }
}

// Host entry point, bound with ctypes: one level. `seg` holds the level's
// `count` segment indices and `starts` all N row starts, both on the device
// and checked by the caller (0 <= s, s + r <= R; no two segments of `seg`
// overlap). Launches on `stream` without synchronising and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside the
// contract.
extern "C" int vnet_blend_rows(float* acc, float* weight, const float* probs,
                               const float* window, const int* seg,
                               const int* starts, int count, int r, int C,
                               cudaStream_t stream) {
  if (count < 1 || r < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)count * r * (C + 1);
  long long blocks = (total + 255) / 256;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  blend_rows_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      acc, weight, probs, window, seg, starts, count, r, C);
  return (int)cudaGetLastError();
}
