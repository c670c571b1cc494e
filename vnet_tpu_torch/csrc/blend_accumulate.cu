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
// value with 0 <= s and s + P <= V (clamped last starts included); nothing is
// assumed about alignment.
//
// Order. The TPU kernel is race-free only because Pallas grid steps run in
// sequence. Here the design is owner-computes: one thread owns one
// accumulator element of the batch's bounding box and loops over the patches
// in order b = 0 .. B-1, adding contrib[b] where the element lies inside
// patch b. Each element therefore receives its contributions in exactly the
// sequential order of the per-patch loop, so the result is bitwise equal to
// it; no two threads write one address and there are no atomics, so runs are
// reproducible and argmax ties cannot flip between runs.
//
// Cost. The kernel is bound by memory bandwidth: per launch it reads and
// writes each touched accumulator element once and reads each contribution
// once; the arithmetic is one add per contribution. Owner-computes makes the
// accumulator traffic independent of the overlap (a per-patch loop would
// re-read and re-write an overlapped element once per patch covering it).
// Consecutive threads own consecutive channels and z positions, so loads and
// stores of both the accumulator and each contribution are coalesced. The
// starts travel as a __grid_constant__ kernel parameter (the counterpart of
// the TPU kernel's scalar prefetch): read in place through the constant
// cache, the same address for a whole warp, and the launch needs no device
// allocation and no copy. Elements of the bounding box that no patch covers
// are neither read nor written.

#include <cuda_runtime.h>

#define VNET_BLEND_MAX_PATCHES 256

struct PatchStarts {
  int v[VNET_BLEND_MAX_PATCHES][3];
};

__global__ void blend_accumulate_kernel(
    float* __restrict__ acc, const float* __restrict__ contrib,
    const __grid_constant__ PatchStarts starts, int num_patches, int vy,
    int vz, int channels, int px, int py, int pz, int x0, int y0, int z0,
    int ey, int ez, long long total) {
  const long long patch_elems = (long long)px * py * pz * channels;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int c = (int)(i % channels);
    long long t = i / channels;
    const int z = z0 + (int)(t % ez);
    t /= ez;
    const int y = y0 + (int)(t % ey);
    const int x = x0 + (int)(t / ey);
    const long long a = (((long long)x * vy + y) * vz + z) * channels + c;

    float v = 0.0f;
    bool touched = false;
    for (int b = 0; b < num_patches; ++b) {
      const unsigned lx = (unsigned)(x - starts.v[b][0]);
      const unsigned ly = (unsigned)(y - starts.v[b][1]);
      const unsigned lz = (unsigned)(z - starts.v[b][2]);
      if (lx < (unsigned)px && ly < (unsigned)py && lz < (unsigned)pz) {
        if (!touched) {
          v = acc[a];
          touched = true;
        }
        v += contrib[b * patch_elems +
                     (((long long)lx * py + ly) * pz + lz) * channels + c];
      }
    }
    if (touched) acc[a] = v;
  }
}

// Host entry point, bound with ctypes. `starts` is a host array of
// num_patches * 3 ints. Launches on `stream` without synchronising and
// returns cudaGetLastError() (non-zero when the launch was refused), or
// cudaErrorInvalidValue for arguments outside the contract.
extern "C" int vnet_blend_accumulate(float* acc, const float* contrib,
                                     const int* starts, int num_patches,
                                     int vx, int vy, int vz, int channels,
                                     int px, int py, int pz,
                                     cudaStream_t stream) {
  if (num_patches < 1 || num_patches > VNET_BLEND_MAX_PATCHES ||
      channels < 1 || px < 1 || py < 1 || pz < 1 || px > vx || py > vy ||
      pz > vz) {
    return (int)cudaErrorInvalidValue;
  }
  PatchStarts s;
  int lo[3] = {vx, vy, vz};
  int hi[3] = {0, 0, 0};
  const int vol[3] = {vx, vy, vz};
  const int patch[3] = {px, py, pz};
  for (int b = 0; b < num_patches; ++b) {
    for (int d = 0; d < 3; ++d) {
      const int st = starts[b * 3 + d];
      if (st < 0 || st + patch[d] > vol[d]) return (int)cudaErrorInvalidValue;
      s.v[b][d] = st;
      lo[d] = st < lo[d] ? st : lo[d];
      hi[d] = st + patch[d] > hi[d] ? st + patch[d] : hi[d];
    }
  }
  const int ex = hi[0] - lo[0], ey = hi[1] - lo[1], ez = hi[2] - lo[2];
  const long long total = (long long)ex * ey * ez * channels;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  blend_accumulate_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      acc, contrib, s, num_patches, vy, vz, channels, px, py, pz, lo[0],
      lo[1], lo[2], ey, ez, total);
  return (int)cudaGetLastError();
}
