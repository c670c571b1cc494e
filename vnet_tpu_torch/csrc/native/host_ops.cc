// Native host-side data ops exposed through a C ABI (consumed from Python
// via ctypes — vnet_tpu/native.py). These are the CPU-hot pieces of the
// data/inference path that the reference did in SimpleITK / numpy:
//
//   * trilinear / nearest resampling onto an affine-mapped output grid
//     (sitk.ResampleImageFilter semantics, NiftiDataset3D.py:380-396)
//   * intensity windowing (IntensityWindowingImageFilter)
//   * sliding-window patch extraction with clamped strides
//     (model.py:866-908) — multithreaded via ThreadPool
//   * softmax blend accumulation (model.py:919-929) for host-side fallback
//
// Layout contract: volumes are C-contiguous float32 arrays indexed
// [x, y, z(, c)] matching vnet_tpu.io.MedicalImage.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "thread_pool.h"

namespace {

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// y = clip((x - lo) * scale + out_min, out_min, out_max)
void vnet_window_normalize(const float* in, float* out, int64_t n, float lo,
                           float hi, float out_min, float out_max) {
  const float scale = (out_max - out_min) / std::max(hi - lo, 1e-12f);
  for (int64_t i = 0; i < n; ++i) {
    float v = (in[i] - lo) * scale + out_min;
    out[i] = std::min(std::max(v, out_min), out_max);
  }
}

// Resample input[in_shape] onto out[out_shape] with continuous index
// mapping c = M @ o + offset (row-major 3x3 M). interp: 0 nearest, 1
// trilinear. Threaded over output x-slabs.
void vnet_resample3d(const float* in, const int64_t* in_shape, float* out,
                     const int64_t* out_shape, const double* M,
                     const double* offset, int interp, float default_value,
                     int num_threads) {
  const int64_t ix = in_shape[0], iy = in_shape[1], iz = in_shape[2];
  const int64_t ox = out_shape[0], oy = out_shape[1], oz = out_shape[2];
  const int64_t in_sx = iy * iz, in_sy = iz;

  auto worker = [&](int64_t x0, int64_t x1) {
    for (int64_t x = x0; x < x1; ++x) {
      for (int64_t y = 0; y < oy; ++y) {
        for (int64_t z = 0; z < oz; ++z) {
          const double cx = M[0] * x + M[1] * y + M[2] * z + offset[0];
          const double cy = M[3] * x + M[4] * y + M[5] * z + offset[1];
          const double cz = M[6] * x + M[7] * y + M[8] * z + offset[2];
          float value = default_value;
          if (interp == 0) {
            if (cx >= 0 && cx <= ix - 1 && cy >= 0 && cy <= iy - 1 &&
                cz >= 0 && cz <= iz - 1) {
              const int64_t nx = clampi((int64_t)std::llround(cx), 0, ix - 1);
              const int64_t ny = clampi((int64_t)std::llround(cy), 0, iy - 1);
              const int64_t nz = clampi((int64_t)std::llround(cz), 0, iz - 1);
              value = in[nx * in_sx + ny * in_sy + nz];
            }
          } else {
            // SimpleITK/scipy 'constant' semantics: a point outside the
            // index domain [0, n-1] takes the default value outright.
            if (cx < 0 || cx > ix - 1 || cy < 0 || cy > iy - 1 || cz < 0 ||
                cz > iz - 1) {
              value = default_value;
            } else {
              const double fx = std::floor(cx), fy = std::floor(cy),
                           fz = std::floor(cz);
              const double tx = cx - fx, ty = cy - fy, tz = cz - fz;
              double acc = 0.0;
              for (int dx = 0; dx < 2; ++dx) {
                for (int dy = 0; dy < 2; ++dy) {
                  for (int dz = 0; dz < 2; ++dz) {
                    const double w = (dx ? tx : 1 - tx) * (dy ? ty : 1 - ty) *
                                     (dz ? tz : 1 - tz);
                    if (w == 0.0) continue;
                    const int64_t px = clampi((int64_t)fx + dx, 0, ix - 1);
                    const int64_t py = clampi((int64_t)fy + dy, 0, iy - 1);
                    const int64_t pz = clampi((int64_t)fz + dz, 0, iz - 1);
                    acc += w * in[px * in_sx + py * in_sy + pz];
                  }
                }
              }
              value = (float)acc;
            }
          }
          out[x * oy * oz + y * oz + z] = value;
        }
      }
    }
  };

  if (num_threads <= 1 || ox < 2) {
    worker(0, ox);
    return;
  }
  vnet::ThreadPool pool((size_t)std::min<int64_t>(num_threads, ox));
  std::vector<std::future<void>> futs;
  const int64_t chunk = (ox + num_threads - 1) / num_threads;
  for (int64_t s = 0; s < ox; s += chunk) {
    futs.push_back(pool.Submit(worker, s, std::min(s + chunk, ox)));
  }
  for (auto& f : futs) f.get();
}

// Patch grid starts with last-patch clamping (model.py:866-893).
// starts_out must hold 3*capacity entries; returns count of patches (or
// required capacity if capacity too small).
int64_t vnet_patch_grid(const int64_t* vol_shape, const int64_t* patch,
                        const int64_t* stride, int64_t* starts_out,
                        int64_t capacity) {
  int64_t counts[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t d = vol_shape[i] - patch[i];
    counts[i] = d <= 0 ? 1 : (d + stride[i] - 1) / stride[i] + 1;
  }
  const int64_t total = counts[0] * counts[1] * counts[2];
  if (total > capacity) return total;
  int64_t n = 0;
  for (int64_t i = 0; i < counts[0]; ++i) {
    for (int64_t j = 0; j < counts[1]; ++j) {
      for (int64_t k = 0; k < counts[2]; ++k) {
        const int64_t idx[3] = {i, j, k};
        for (int a = 0; a < 3; ++a) {
          int64_t s = idx[a] * stride[a];
          if (s + patch[a] > vol_shape[a]) s = vol_shape[a] - patch[a];
          starts_out[n * 3 + a] = clampi(s, 0, vol_shape[a]);
        }
        ++n;
      }
    }
  }
  return n;
}

// Extract N patches [patch0,patch1,patch2,C] from volume [X,Y,Z,C] into
// out (N*prod(patch)*C floats), threaded.
void vnet_extract_patches(const float* vol, const int64_t* vol_shape,
                          int64_t channels, const int64_t* patch,
                          const int64_t* starts, int64_t n_patches,
                          float* out, int num_threads) {
  const int64_t Y = vol_shape[1], Z = vol_shape[2], C = channels;
  const int64_t p0 = patch[0], p1 = patch[1], p2 = patch[2];
  const int64_t patch_elems = p0 * p1 * p2 * C;
  const int64_t row = p2 * C;

  auto copy_patch = [&](int64_t p) {
    const int64_t sx = starts[p * 3], sy = starts[p * 3 + 1],
                  sz = starts[p * 3 + 2];
    float* dst = out + p * patch_elems;
    for (int64_t x = 0; x < p0; ++x) {
      for (int64_t y = 0; y < p1; ++y) {
        const float* src =
            vol + (((sx + x) * Y + (sy + y)) * Z + sz) * C;
        std::memcpy(dst, src, (size_t)row * sizeof(float));
        dst += row;
      }
    }
  };

  if (num_threads <= 1) {
    for (int64_t p = 0; p < n_patches; ++p) copy_patch(p);
    return;
  }
  vnet::ThreadPool pool((size_t)num_threads);
  std::vector<std::future<void>> futs;
  futs.reserve((size_t)n_patches);
  for (int64_t p = 0; p < n_patches; ++p) {
    futs.push_back(pool.Submit(copy_patch, p));
  }
  for (auto& f : futs) f.get();
}

// acc[X,Y,Z,C] += probs[N,p0,p1,p2,C] * window[p0,p1,p2];
// weight[X,Y,Z] += window. Sequential (overlapping patches).
void vnet_blend_accumulate(float* acc, float* weight, const int64_t* vol_shape,
                           int64_t channels, const float* probs,
                           const float* window, const int64_t* patch,
                           const int64_t* starts, int64_t n_patches) {
  const int64_t Y = vol_shape[1], Z = vol_shape[2], C = channels;
  const int64_t p0 = patch[0], p1 = patch[1], p2 = patch[2];
  for (int64_t p = 0; p < n_patches; ++p) {
    const int64_t sx = starts[p * 3], sy = starts[p * 3 + 1],
                  sz = starts[p * 3 + 2];
    const float* pr = probs + p * p0 * p1 * p2 * C;
    for (int64_t x = 0; x < p0; ++x) {
      for (int64_t y = 0; y < p1; ++y) {
        for (int64_t z = 0; z < p2; ++z) {
          const float w = window[(x * p1 + y) * p2 + z];
          const int64_t vi = ((sx + x) * Y + (sy + y)) * Z + (sz + z);
          float* a = acc + vi * C;
          const float* s = pr + ((x * p1 + y) * p2 + z) * C;
          for (int64_t c = 0; c < C; ++c) a[c] += s[c] * w;
          weight[vi] += w;
        }
      }
    }
  }
}

int vnet_host_ops_version() { return 1; }

}  // extern "C"
