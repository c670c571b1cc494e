// Sliding-window blend: ordered scatter-add of patch contributions into a
// channels-last volume accumulator, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vnet_tpu/ops/pallas/fused.py::blend_accumulate_patches.
// For a batch of B contributions contrib[b] of shape (PX, PY, PZ, C) f32 and
// start corners starts[b] = (sx, sy, sz):
//
//     acc[sx:sx+PX, sy:sy+PY, sz:sz+PZ, :] += contrib[b]     for b = 0 .. B-1
//
// with acc of shape (VX, VY, VZ, C) f32, updated in place. Starts may take any
// value with 0 <= s and s + P <= V (clamped last starts included).
//
// Order. The TPU kernel is race-free only because Pallas grid steps run in
// sequence. Here the design is owner-computes: one thread owns an element of
// the batch's bounding box, reads it once, adds the contributions of the
// patches that cover it in order b = 0 .. B-1 and writes it once. Each element
// therefore receives its adds in exactly the sequential order of the
// per-patch loop, so the result is bitwise equal to it; no two threads write
// one address and there are no atomics.
//
// Cost. The kernel is bound by memory bandwidth: each covered accumulator
// element is read and written once and each contribution read once, with one
// add per contribution. What held the first version back was instructions,
// not bytes: one thread per 4-byte element, five 64-bit divisions to find its
// coordinates and a test of every patch. Here:
//  - A block owns a group of (x, y) lines of the bounding box, x and the
//    first y from blockIdx: no element divides. Inside a line the (z, c) run
//    of the accumulator and of each patch's contribution is contiguous, so an
//    element is a flat offset q in the line, tested against the patch's run
//    [sz*C, (sz+PZ)*C) without splitting it into z and c. Offsets inside a
//    line and a patch are 32-bit; only the bases are 64-bit.
//  - The block first lists, in patch order, the patches that meet its x and
//    its lines (warp 0, by ballot), in shared memory with their bases
//    precomputed; an element tests only its y and q against that short list.
//  - Where VZ*C, PZ*C and every sz*C are multiples of 4 floats and both bases
//    are 16-byte aligned, an element is a float4 (no run boundary splits one):
//    16-byte loads and stores. Otherwise the same kernel runs on floats.
//  - Contributions are read once, with the streaming hint (ld.global.cs).
// Elements of the bounding box that no patch covers are neither read nor
// written. The starts travel as a __grid_constant__ kernel parameter (the
// counterpart of the TPU kernel's scalar prefetch): the launch needs no
// device allocation and no copy.

#include <cuda_runtime.h>

#define VNET_BLEND_MAX_PATCHES 256
#define VNET_BLEND_THREADS 256
#define VNET_BLEND_LINE_PASSES 4  // lines per block = blockDim.y * this

struct PatchStarts {
  int v[VNET_BLEND_MAX_PATCHES][3];
};

// A patch of a block's list. Element (y, q) of the block's x lies in the
// patch iff 0 <= y - sy < PY and 0 <= q - sq < PZ*C/V; its contribution is
// contrib[base + (y - sy) * (PZ*C/V) + q] (vectors of V floats).
struct Entry {
  long long base;  // vector offset of (b, x - sx, 0, 0, 0), minus sq
  int sy;
  int sq;          // sz * C / V
};

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// V = float (scalar path) or float4 (vector path); W = floats per V.
template <typename V, int W>
__global__ void __launch_bounds__(VNET_BLEND_THREADS)
    blend_accumulate_kernel(V* __restrict__ acc, const V* __restrict__ contrib,
                            const __grid_constant__ PatchStarts starts,
                            int num_patches, int vy, int vzq, int channels,
                            int px, int py, int pzq, int x0, int y0, int ye,
                            int q0, int qe, int lines) {
  __shared__ Entry list[VNET_BLEND_MAX_PATCHES];
  __shared__ int count;
  const int x = x0 + blockIdx.x;
  const int ya = y0 + blockIdx.y * lines;
  const int yb = min(ya + lines, ye);
  if (threadIdx.y == 0 && threadIdx.x < 32) {  // warp 0: blockDim.x % 32 == 0
    const int lane = threadIdx.x;
    int n = 0;
    for (int b0 = 0; b0 < num_patches; b0 += 32) {
      const int b = b0 + lane;
      bool hit = false;
      int sx = 0, sy = 0, sz = 0;
      if (b < num_patches) {
        sx = starts.v[b][0];
        sy = starts.v[b][1];
        sz = starts.v[b][2];
        hit = (unsigned)(x - sx) < (unsigned)px && sy < yb && sy + py > ya;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int k = n + __popc(mask & ((1u << lane) - 1u));
        const int sq = sz * channels / W;
        list[k].base = ((long long)b * px + (x - sx)) * py * pzq - sq;
        list[k].sy = sy;
        list[k].sq = sq;
      }
      n += __popc(mask);
    }
    if (lane == 0) count = n;
  }
  __syncthreads();
  const int n = count;
  if (n == 0) return;
  for (int y = ya + threadIdx.y; y < yb; y += blockDim.y) {
    V* line = acc + ((long long)x * vy + y) * vzq;
    for (int q = q0 + threadIdx.x; q < qe; q += blockDim.x) {
      V v{};
      bool touched = false;
      for (int e = 0; e < n; ++e) {
        const unsigned ly = (unsigned)(y - list[e].sy);
        if (ly < (unsigned)py &&
            (unsigned)(q - list[e].sq) < (unsigned)pzq) {
          const V c = __ldcs(contrib + list[e].base + (long long)(ly * pzq) +
                             q);
          if (!touched) {
            v = line[q];
            touched = true;
          }
          v = vadd(v, c);
        }
      }
      if (touched) line[q] = v;
    }
  }
}

template <typename V, int W>
static int launch(float* acc, const float* contrib, const PatchStarts& s,
                  int num_patches, int vy, int vz, int channels, int px,
                  int py, int pz, const int lo[3], const int hi[3],
                  cudaStream_t stream) {
  const int q0 = lo[2] * channels / W, qe = hi[2] * channels / W;
  const int eq = qe - q0;
  int bx = (eq + 31) / 32 * 32;
  if (bx > VNET_BLEND_THREADS) bx = VNET_BLEND_THREADS;
  const int by = VNET_BLEND_THREADS / bx;
  const int lines = by * VNET_BLEND_LINE_PASSES;
  const long long gy = (hi[1] - lo[1] + lines - 1) / lines;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  blend_accumulate_kernel<V, W><<<dim3(hi[0] - lo[0], (unsigned)gy),
                                  dim3(bx, by), 0, stream>>>(
      reinterpret_cast<V*>(acc), reinterpret_cast<const V*>(contrib), s,
      num_patches, vy, vz * channels / W, channels, px, py, pz * channels / W,
      lo[0], lo[1], hi[1], q0, qe, lines);
  return (int)cudaGetLastError();
}

// Host entry point, bound with ctypes. `starts` is a host array of
// num_patches * 3 ints. Launches on `stream` without synchronising, writes
// the floats per element of the path it took to *width (4: float4, 1:
// float) and returns cudaGetLastError() (non-zero when the launch was
// refused), or cudaErrorInvalidValue for arguments outside the contract.
extern "C" int vnet_blend_accumulate(float* acc, const float* contrib,
                                     const int* starts, int num_patches,
                                     int vx, int vy, int vz, int channels,
                                     int px, int py, int pz, int* width,
                                     cudaStream_t stream) {
  if (num_patches < 1 || num_patches > VNET_BLEND_MAX_PATCHES ||
      channels < 1 || px < 1 || py < 1 || pz < 1 || px > vx || py > vy ||
      pz > vz || (long long)vz * channels > 0x7fffffffLL ||
      (long long)py * pz * channels > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  PatchStarts s;
  int lo[3] = {vx, vy, vz};
  int hi[3] = {0, 0, 0};
  const int vol[3] = {vx, vy, vz};
  const int patch[3] = {px, py, pz};
  bool vec = (vz * channels) % 4 == 0 && (pz * channels) % 4 == 0 &&
             (size_t)acc % 16 == 0 && (size_t)contrib % 16 == 0;
  for (int b = 0; b < num_patches; ++b) {
    for (int d = 0; d < 3; ++d) {
      const int st = starts[b * 3 + d];
      if (st < 0 || st + patch[d] > vol[d]) return (int)cudaErrorInvalidValue;
      s.v[b][d] = st;
      lo[d] = st < lo[d] ? st : lo[d];
      hi[d] = st + patch[d] > hi[d] ? st + patch[d] : hi[d];
    }
    vec = vec && (s.v[b][2] * channels) % 4 == 0;
  }
  *width = vec ? 4 : 1;
  return vec ? launch<float4, 4>(acc, contrib, s, num_patches, vy, vz,
                                 channels, px, py, pz, lo, hi, stream)
             : launch<float, 1>(acc, contrib, s, num_patches, vy, vz,
                                channels, px, py, pz, lo, hi, stream);
}
