#include "inference_client.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <future>
#include <optional>
#include <stdexcept>

#include "safe_queue.h"
#include "thread_pool.h"

extern "C" {
void vnet_window_normalize(const float*, float*, int64_t, float, float, float,
                           float);
void vnet_resample3d(const float*, const int64_t*, float*, const int64_t*,
                     const double*, const double*, int, float, int);
int64_t vnet_patch_grid(const int64_t*, const int64_t*, const int64_t*,
                        int64_t*, int64_t);
void vnet_extract_patches(const float*, const int64_t*, int64_t,
                          const int64_t*, const int64_t*, int64_t, float*,
                          int);
void vnet_blend_accumulate(float*, float*, const int64_t*, int64_t,
                           const float*, const float*, const int64_t*,
                           const int64_t*, int64_t);
}

namespace vnet {
namespace {

// Continuous-index map out -> in for identity world transform:
// c = A_in^{-1} A_out o. With shared direction and origin this reduces to
// per-axis spacing ratios; we implement the general affine like the Python
// side (vnet_tpu/io/resample.py) using direction matrices.
struct AffineMap {
  double M[9];
  double offset[3];
};

void Invert3x3(const double* a, double* inv) {
  const double det =
      a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
      a[2] * (a[3] * a[7] - a[4] * a[6]);
  if (std::fabs(det) < 1e-300) throw std::runtime_error("singular direction");
  const double d = 1.0 / det;
  inv[0] = (a[4] * a[8] - a[5] * a[7]) * d;
  inv[1] = (a[2] * a[7] - a[1] * a[8]) * d;
  inv[2] = (a[1] * a[5] - a[2] * a[4]) * d;
  inv[3] = (a[5] * a[6] - a[3] * a[8]) * d;
  inv[4] = (a[0] * a[8] - a[2] * a[6]) * d;
  inv[5] = (a[2] * a[3] - a[0] * a[5]) * d;
  inv[6] = (a[3] * a[7] - a[4] * a[6]) * d;
  inv[7] = (a[1] * a[6] - a[0] * a[7]) * d;
  inv[8] = (a[0] * a[4] - a[1] * a[3]) * d;
}

AffineMap MakeMap(const NiftiImage& in, const NiftiImage& out) {
  // A = D * diag(spacing); world = A * index + origin
  double a_in[9], a_out[9], a_in_inv[9];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      a_in[r * 3 + c] = in.direction[r * 3 + c] * in.spacing[c];
      a_out[r * 3 + c] = out.direction[r * 3 + c] * out.spacing[c];
    }
  }
  Invert3x3(a_in, a_in_inv);
  AffineMap map{};
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += a_in_inv[r * 3 + k] * a_out[k * 3 + c];
      map.M[r * 3 + c] = s;
    }
    double o = 0;
    for (int k = 0; k < 3; ++k) {
      o += a_in_inv[r * 3 + k] * (out.origin[k] - in.origin[k]);
    }
    map.offset[r] = o;
  }
  return map;
}

}  // namespace

NiftiImage InferenceClient::ResampleToGrid(const NiftiImage& input,
                                           const NiftiImage& ref,
                                           bool nearest) const {
  NiftiImage out;
  out.shape = ref.shape;
  out.spacing = ref.spacing;
  out.origin = ref.origin;
  out.direction = ref.direction;
  out.data.resize((size_t)out.size());
  const AffineMap map = MakeMap(input, out);
  vnet_resample3d(input.data.data(), input.shape.data(), out.data.data(),
                  out.shape.data(), map.M, map.offset, nearest ? 0 : 1, 0.0f,
                  options_.num_threads);
  return out;
}

NiftiImage InferenceClient::Preprocess(const NiftiImage& input) const {
  // 1) intensity window -> [0, 255]  (tf_inference.cpp:153-170 semantics)
  NiftiImage windowed = input;
  vnet_window_normalize(input.data.data(), windowed.data.data(), input.size(),
                        (float)options_.window_min, (float)options_.window_max,
                        0.0f, 255.0f);

  // 2) resample to target spacing, size = ceil(old_extent / new_spacing),
  //    padded up to the patch shape (tf_inference.cpp:171-209)
  NiftiImage target;
  target.spacing = options_.spacing;
  target.origin = windowed.origin;
  target.direction = windowed.direction;
  for (int i = 0; i < 3; ++i) {
    int64_t dim = (int64_t)std::ceil(windowed.spacing[i] * windowed.shape[i] /
                                     options_.spacing[i]);
    target.shape[i] = std::max(dim, options_.patch_shape[i]);
  }
  target.data.assign((size_t)target.size(), 0.0f);
  return ResampleToGrid(windowed, target, /*nearest=*/false);
}

NiftiImage InferenceClient::Run(const NiftiImage& input) const {
  const auto& patch = options_.patch_shape;
  const int64_t C = options_.num_classes;
  const int64_t patch_elems = patch[0] * patch[1] * patch[2];

  NiftiImage volume = Preprocess(input);

  // patch grid
  std::vector<int64_t> starts(3 * 1);
  int64_t n = vnet_patch_grid(volume.shape.data(), patch.data(),
                              options_.stride.data(), starts.data(), 0);
  starts.resize((size_t)(3 * n));
  vnet_patch_grid(volume.shape.data(), patch.data(), options_.stride.data(),
                  starts.data(), n);

  // accumulators
  std::vector<float> acc((size_t)(volume.size() * C), 0.0f);
  std::vector<float> weight((size_t)volume.size(), 0.0f);
  std::vector<float> window((size_t)patch_elems, 1.0f);

  // producer/consumer: crop batches ahead of the executor
  // (bounded lookahead like the reference's bufferQueue,
  // tf_inference.cpp:367-395 — but without its global crop mutex).
  struct Batch {
    std::vector<float> patches;
    int64_t first;
    int64_t count;
  };
  SafeQueue<Batch> queue((size_t)options_.buffer_pool_size);
  const int64_t B = options_.batch_size;

  std::thread producer([&] {
    ThreadPool pool((size_t)std::max(options_.num_threads, 1));
    for (int64_t b = 0; b * B < n; ++b) {
      const int64_t first = b * B;
      const int64_t count = std::min(B, n - first);
      Batch batch;
      batch.first = first;
      batch.count = count;
      batch.patches.resize((size_t)(count * patch_elems));
      vnet_extract_patches(volume.data.data(), volume.shape.data(),
                           /*channels=*/1, patch.data(),
                           starts.data() + first * 3, count,
                           batch.patches.data(), options_.num_threads);
      queue.Push(std::move(batch));
    }
    queue.Close();
  });

  // two-stage pipeline: while the executor runs batch i on the device,
  // the main thread blends batch i-1's probabilities on the host
  // (executor calls themselves stay strictly serialized).
  std::optional<Batch> prev;
  std::future<std::vector<float>> inflight;
  auto blend_prev = [&] {
    std::vector<float> probs = inflight.get();
    if ((int64_t)probs.size() != prev->count * patch_elems * C) {
      throw std::runtime_error("executor returned wrong size");
    }
    vnet_blend_accumulate(acc.data(), weight.data(), volume.shape.data(), C,
                          probs.data(), window.data(), patch.data(),
                          starts.data() + prev->first * 3, prev->count);
  };
  try {
    while (auto batch = queue.Pop()) {
      if (prev) blend_prev();
      prev = std::move(*batch);
      inflight = std::async(std::launch::async, [this, &patch, C, &prev] {
        return executor_(prev->patches, prev->count, patch, C);
      });
    }
    if (prev) blend_prev();
  } catch (...) {
    if (inflight.valid()) {
      try { inflight.wait(); } catch (...) {}
    }
    while (queue.Pop()) {}  // drain so the producer can finish
    producer.join();
    throw;
  }
  producer.join();

  // argmax -> label on the transformed grid
  NiftiImage label = volume;
  for (int64_t v = 0; v < volume.size(); ++v) {
    int64_t best = 0;
    float best_val = acc[(size_t)(v * C)];
    for (int64_t c = 1; c < C; ++c) {
      const float val = acc[(size_t)(v * C + c)];
      if (val > best_val) {
        best_val = val;
        best = c;
      }
    }
    label.data[(size_t)v] = (float)best;
  }

  // restore to original grid (nearest)
  return ResampleToGrid(label, input, /*nearest=*/true);
}

}  // namespace vnet
