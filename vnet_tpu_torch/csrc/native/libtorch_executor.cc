// The libtorch executor (libtorch_executor.h). Built with g++ against the
// installed PyTorch's headers and libraries (vnet_tpu_torch/native.py).
//
// Only device-generic c10 interfaces are used for the CUDA staging (streams
// and events through the registered device guard), so this file compiles
// without the CUDA toolkit's headers; a CUDA build links libtorch_cuda,
// which registers the CUDA guard and the AOTInductor CUDA runner.

#include "libtorch_executor.h"

#include <algorithm>
#include <cstring>
#include <optional>
#include <sstream>
#include <stdexcept>

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/Event.h>
#include <c10/core/InferenceMode.h>
#include <c10/core/Stream.h>
#include <c10/core/StreamGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

namespace vnet {
namespace {

// The metadata key export_package writes: "B,X,Y,Z,C".
constexpr const char* kInputShapeKey = "vnet.input_shape";

std::vector<int64_t> ParseShape(const std::string& text) {
  std::vector<int64_t> dims;
  std::stringstream ss(text);
  std::string item;
  while (std::getline(ss, item, ',')) dims.push_back(std::stoll(item));
  return dims;
}

std::string ShapeText(const std::vector<int64_t>& dims) {
  std::string s = "(";
  for (size_t i = 0; i < dims.size(); ++i) {
    s += (i ? ", " : "") + std::to_string(dims[i]);
  }
  return s + ")";
}

int64_t Numel(const std::vector<int64_t>& dims) {
  int64_t n = 1;
  for (int64_t d : dims) n *= d;
  return n;
}

}  // namespace

struct LibtorchExecutor::Impl {
  // An input on the device, and on CUDA the event of its host-to-device
  // copy on the copy stream.
  struct Staged {
    at::Tensor input;
    std::optional<c10::Event> ready;
  };

  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  c10::Device device{c10::kCPU};
  std::vector<int64_t> input_shape;
  std::optional<c10::Stream> copy_stream;  // CUDA only
  at::Tensor host[2];  // staging slots, pinned on CUDA

  void CheckDims(const std::vector<int64_t>& dims) const {
    if (dims != input_shape) {
      throw std::invalid_argument("LibtorchExecutor: input " +
                                  ShapeText(dims) + ", the package takes " +
                                  ShapeText(input_shape));
    }
  }

  at::Tensor& Slot(int slot) {
    if (!host[slot].defined()) {
      host[slot] = at::empty(input_shape, at::TensorOptions()
                                              .dtype(at::kFloat)
                                              .pinned_memory(device.is_cuda()));
    }
    return host[slot];
  }

  Staged Stage(int slot) {
    Staged staged;
    if (!device.is_cuda()) {
      staged.input = host[slot].clone();
      return staged;
    }
    // allocated on the stream that reads it (the current one); only the
    // copy runs on the copy stream, and the forward waits for its event
    staged.input = at::empty(
        input_shape, at::TensorOptions().dtype(at::kFloat).device(device));
    c10::StreamGuard guard(*copy_stream);
    staged.input.copy_(host[slot], /*non_blocking=*/true);
    staged.ready.emplace(device.type());
    staged.ready->record(*copy_stream);
    return staged;
  }

  std::vector<float> Execute(Staged staged, std::vector<int64_t>* out_dims) {
    c10::InferenceMode inference;
    c10::DeviceGuard device_guard(device);
    if (staged.ready) {
      c10::impl::VirtualGuardImpl impl(device.type());
      staged.ready->block(impl.getStream(device));
    }
    std::vector<at::Tensor> outputs = loader->run({staged.input});
    if (outputs.size() != 1) {
      throw std::runtime_error("LibtorchExecutor: the package returned " +
                               std::to_string(outputs.size()) +
                               " outputs, expected 1");
    }
    const at::Tensor out =
        outputs[0].to(at::kCPU, at::kFloat).contiguous();  // synchronises
    const std::vector<int64_t> dims(out.sizes().begin(), out.sizes().end());
    if (dims.size() != input_shape.size() ||
        !std::equal(dims.begin(), dims.end() - 1, input_shape.begin())) {
      throw std::runtime_error("LibtorchExecutor: output " + ShapeText(dims) +
                               " for input " + ShapeText(input_shape));
    }
    if (out_dims != nullptr) *out_dims = dims;
    const float* p = out.data_ptr<float>();
    return std::vector<float>(p, p + out.numel());
  }
};

LibtorchExecutor::LibtorchExecutor(const std::string& package_path)
    : impl_(std::make_unique<Impl>()) {
  impl_->loader =
      std::make_unique<torch::inductor::AOTIModelPackageLoader>(package_path);
  const auto metadata = impl_->loader->get_metadata();
  const auto shape = metadata.find(kInputShapeKey);
  if (shape == metadata.end()) {
    throw std::runtime_error(
        "LibtorchExecutor: " + package_path + " has no " + kInputShapeKey +
        " metadata; write the package with vnet_tpu_torch.export");
  }
  impl_->input_shape = ParseShape(shape->second);
  const auto key = metadata.find("AOTI_DEVICE_KEY");
  if (key != metadata.end() && key->second == "cuda") {
    c10::impl::VirtualGuardImpl impl(c10::kCUDA);
    impl_->device = impl.getDevice();
    impl_->copy_stream = impl.getStreamFromGlobalPool(impl_->device);
  } else if (key == metadata.end() || key->second != "cpu") {
    throw std::runtime_error("LibtorchExecutor: " + package_path +
                             " is for an unsupported device");
  }
}

LibtorchExecutor::~LibtorchExecutor() = default;

std::string LibtorchExecutor::device() const { return impl_->device.str(); }

const std::vector<int64_t>& LibtorchExecutor::input_shape() const {
  return impl_->input_shape;
}

std::vector<float> LibtorchExecutor::Run(const std::vector<float>& input,
                                         const std::vector<int64_t>& dims,
                                         std::vector<int64_t>* out_dims) {
  impl_->CheckDims(dims);
  if ((int64_t)input.size() != Numel(dims)) {
    throw std::invalid_argument("LibtorchExecutor: " +
                                std::to_string(input.size()) +
                                " values for the shape " + ShapeText(dims));
  }
  at::Tensor& slot = impl_->Slot(0);
  std::memcpy(slot.data_ptr<float>(), input.data(),
              input.size() * sizeof(float));
  return impl_->Execute(impl_->Stage(0), out_dims);
}

Executor LibtorchExecutor::AsExecutor(int64_t compiled_batch) {
  return [this, compiled_batch](const std::vector<float>& patches, int64_t n,
                                const std::array<int64_t, 3>& patch,
                                int64_t num_classes) {
    const int64_t voxels = patch[0] * patch[1] * patch[2];
    if ((int64_t)patches.size() != n * voxels) {
      throw std::invalid_argument("LibtorchExecutor: patches hold " +
                                  std::to_string(patches.size()) +
                                  " values, expected " +
                                  std::to_string(n * voxels));
    }
    if (compiled_batch <= 0 || n == compiled_batch) {
      return Run(patches, {n, patch[0], patch[1], patch[2], 1});
    }
    Impl& impl = *impl_;
    impl.CheckDims({compiled_batch, patch[0], patch[1], patch[2], 1});
    const int64_t out_row = voxels * num_classes;
    std::vector<float> out;
    out.reserve(static_cast<size_t>(n * out_row));

    // chunk to the package's fixed batch; the tail repeats the last patch
    // (the padded rows are dropped, as PjrtExecutor::AsExecutor does)
    auto fill = [&](int slot, int64_t start) {
      float* dst = impl.Slot(slot).data_ptr<float>();
      const int64_t m = std::min(compiled_batch, n - start);
      std::memcpy(dst, patches.data() + start * voxels,
                  static_cast<size_t>(m * voxels) * sizeof(float));
      for (int64_t pad = m; pad < compiled_batch; ++pad) {
        std::memcpy(dst + pad * voxels, dst + (m - 1) * voxels,
                    static_cast<size_t>(voxels) * sizeof(float));
      }
      return m;
    };
    // a slot is refilled only after the forward that read it returned,
    // which waited for its copy
    int cur = 0;
    int64_t m_cur = fill(cur, 0);
    Impl::Staged staged = impl.Stage(cur);
    for (int64_t start = 0; start < n; start += compiled_batch) {
      const int64_t next = start + compiled_batch;
      int64_t m_next = 0;
      Impl::Staged staged_next;
      if (next < n) {
        m_next = fill(1 - cur, next);
        staged_next = impl.Stage(1 - cur);
      }
      const std::vector<float> probs = impl.Execute(std::move(staged), nullptr);
      if ((int64_t)probs.size() != compiled_batch * out_row) {
        throw std::runtime_error(
            "LibtorchExecutor: the package returned " +
            std::to_string(probs.size()) + " probabilities, expected " +
            std::to_string(compiled_batch * out_row) + " for " +
            std::to_string(num_classes) + " classes");
      }
      out.insert(out.end(), probs.begin(), probs.begin() + m_cur * out_row);
      cur = 1 - cur;
      m_cur = m_next;
      staged = std::move(staged_next);
    }
    return out;
  };
}

}  // namespace vnet
