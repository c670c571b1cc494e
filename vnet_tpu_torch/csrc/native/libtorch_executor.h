// libtorch executor: runs the exported eval forward (an AOTInductor
// package written by vnet_tpu_torch/export.py::export_package) on the
// package's device, CUDA or the CPU. It takes the place of the JAX
// package's PJRT executor (csrc/pjrt_executor.h) as the device backend of
// the native inference client (inference_client.h).
//
// This header includes no PyTorch header (the state sits behind a pointer
// to an implementation), so only libtorch_executor.cc compiles against
// libtorch's headers; callers link libtorch.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "inference_client.h"

namespace vnet {

class LibtorchExecutor {
 public:
  // package_path: a .pt2 AOTInductor package. Its device ("cpu" or "cuda")
  // is the one it was compiled for. Throws std::runtime_error when the
  // package cannot be loaded or lacks the vnet.input_shape metadata that
  // export_package writes.
  explicit LibtorchExecutor(const std::string& package_path);
  ~LibtorchExecutor();

  LibtorchExecutor(const LibtorchExecutor&) = delete;
  LibtorchExecutor& operator=(const LibtorchExecutor&) = delete;

  // "cpu" or "cuda:<index>".
  std::string device() const;

  // The fixed input shape the forward was exported with: (B, X, Y, Z, C).
  const std::vector<int64_t>& input_shape() const;

  // Run the forward on one f32 host input of shape `dims` (which must be
  // input_shape()); returns the flattened f32 probabilities on the host,
  // (B, X, Y, Z, num_classes). Throws std::invalid_argument on a shape
  // mismatch.
  std::vector<float> Run(const std::vector<float>& input,
                         const std::vector<int64_t>& dims,
                         std::vector<int64_t>* out_dims = nullptr);

  // Adapt to the InferenceClient Executor interface: patches
  // (n, *patch, 1) -> probabilities (n, *patch, num_classes).
  // `compiled_batch`: the package's fixed batch. Incoming batches are cut
  // into chunks of it, the last chunk padded by repeating its last patch
  // and the padded rows dropped from the result. Chunk i+1 is staged while
  // chunk i runs: on CUDA it is copied from a pinned host buffer to the
  // device on a copy stream, and the forward waits for the copy's event; on
  // the CPU staging is a plain copy. 0 = pass n through unchanged (the
  // package must have been exported for it).
  Executor AsExecutor(int64_t compiled_batch = 0);

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
};

}  // namespace vnet
