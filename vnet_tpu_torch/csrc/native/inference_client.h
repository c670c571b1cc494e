// Native sliding-window inference client — counterpart of the reference's
// cxx/tf_inference.{h,cpp} (TF_Inference class), re-designed around a
// pluggable executor:
//
//   preprocess (window -> resample -> pad)  [this file, threaded]
//   patch grid (clamped strides)            [host_ops.cc]
//   producer/consumer pipeline              [thread_pool.h + safe_queue.h]
//   executor: patches -> class probabilities (plug-in point; the TPU
//     implementation goes through the PJRT C API — see csrc/README.md)
//   blend + argmax + resample-back          [host_ops.cc + this file]
#pragma once

#include <array>
#include <cstdint>
#include <functional>
#include <string>
#include <vector>

#include "nifti_io.h"

namespace vnet {

// patches: n * prod(patch) floats (single channel), row-major [x][y][z].
// Returns n * prod(patch) * num_classes probabilities.
using Executor = std::function<std::vector<float>(
    const std::vector<float>& patches, int64_t n,
    const std::array<int64_t, 3>& patch, int64_t num_classes)>;

struct InferenceOptions {
  std::array<int64_t, 3> patch_shape{64, 64, 64};
  std::array<int64_t, 3> stride{32, 32, 32};
  int64_t batch_size = 8;
  int64_t num_classes = 2;
  double window_min = 0.0;
  double window_max = 600.0;
  std::array<double, 3> spacing{1.0, 1.0, 1.0};  // resample target
  int num_threads = 4;
  int buffer_pool_size = 6;  // producer lookahead (tf_inference.h:63)
};

class InferenceClient {
 public:
  InferenceClient(InferenceOptions options, Executor executor)
      : options_(std::move(options)), executor_(std::move(executor)) {}

  // Full pipeline: returns the label image on the ORIGINAL input grid.
  NiftiImage Run(const NiftiImage& input) const;

 private:
  NiftiImage Preprocess(const NiftiImage& input) const;
  NiftiImage ResampleToGrid(const NiftiImage& input, const NiftiImage& ref,
                            bool nearest) const;

  InferenceOptions options_;
  Executor executor_;
};

}  // namespace vnet
