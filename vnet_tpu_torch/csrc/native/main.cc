// vnet_infer_torch: the native inference CLI of the PyTorch port, adapted
// from the JAX package's csrc/main.cc with the libtorch executor in place
// of the PJRT one.
//
//   vnet_infer_torch <input.nii[.gz]> <output.nii[.gz]> [threshold=128]
//       [patch=64] [stride=32] [threads=4] [model.pt2 num_classes]
//       [window_min=0 window_max=600 spacing=1]
//
// patch, stride and spacing take one value for every axis or three joined
// by 'x' (256x256x32). Without a model, the built-in threshold executor
// segments by intensity, so the whole native pipeline (read -> preprocess
// -> tiled inference -> blend -> restore -> write) runs with no device.
// With a model (an AOTInductor package from vnet_tpu_torch.export), the
// forward runs on the package's device, which is printed; its batch is the
// package's, and its patch must equal the patch argument.

#include <algorithm>
#include <array>
#include <chrono>
#include <cstdlib>
#include <iostream>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "inference_client.h"
#include "libtorch_executor.h"

namespace {

vnet::Executor MakeThresholdExecutor(float threshold) {
  return [threshold](const std::vector<float>& patches, int64_t n,
                     const std::array<int64_t, 3>& patch,
                     int64_t num_classes) {
    const int64_t elems = patch[0] * patch[1] * patch[2];
    std::vector<float> probs((size_t)(n * elems * num_classes), 0.0f);
    for (int64_t i = 0; i < n * elems; ++i) {
      const bool fg = patches[(size_t)i] > threshold;
      probs[(size_t)(i * num_classes)] = fg ? 0.0f : 1.0f;
      if (num_classes > 1) {
        probs[(size_t)(i * num_classes + 1)] = fg ? 1.0f : 0.0f;
      }
    }
    return probs;
  };
}

// "N" or "AxBxC".
template <typename T>
std::array<T, 3> ParseTriple(const std::string& text) {
  std::vector<T> values;
  std::stringstream ss(text);
  std::string item;
  while (std::getline(ss, item, 'x')) {
    std::stringstream is(item);
    T v;
    if (!(is >> v)) throw std::invalid_argument("bad value " + text);
    values.push_back(v);
  }
  if (values.size() == 1) return {values[0], values[0], values[0]};
  if (values.size() != 3) throw std::invalid_argument("bad value " + text);
  return {values[0], values[1], values[2]};
}

int Main(int argc, char** argv) {
  using Clock = std::chrono::steady_clock;
  auto seconds = [](Clock::time_point a, Clock::time_point b) {
    return std::chrono::duration<double>(b - a).count();
  };
  if (argc < 3) {
    std::cerr << "usage: vnet_infer_torch <input.nii[.gz]> "
                 "<output.nii[.gz]> [threshold=128] [patch=64] [stride=32] "
                 "[threads=4] [model.pt2 num_classes] [window_min=0 "
                 "window_max=600 spacing=1]\n";
    return 2;
  }
  const std::string input_path = argv[1];
  const std::string output_path = argv[2];
  const float threshold = argc > 3 ? std::stof(argv[3]) : 128.0f;

  vnet::InferenceOptions opts;
  if (argc > 4) opts.patch_shape = ParseTriple<int64_t>(argv[4]);
  if (argc > 5) opts.stride = ParseTriple<int64_t>(argv[5]);
  if (argc > 6) opts.num_threads = std::stoi(argv[6]);
  if (argc > 9) opts.window_min = std::stod(argv[9]);
  if (argc > 10) opts.window_max = std::stod(argv[10]);
  if (argc > 11) opts.spacing = ParseTriple<double>(argv[11]);

  vnet::Executor executor = MakeThresholdExecutor(threshold);
  std::unique_ptr<vnet::LibtorchExecutor> model;
  if (argc > 7) {
    const auto t_load = Clock::now();
    model = std::make_unique<vnet::LibtorchExecutor>(argv[7]);
    const std::vector<int64_t>& shape = model->input_shape();
    if (shape.size() != 5 || shape[4] != 1 ||
        !std::equal(shape.begin() + 1, shape.begin() + 4,
                    opts.patch_shape.begin())) {
      std::cerr << "the package takes the input shape (";
      for (size_t i = 0; i < shape.size(); ++i) {
        std::cerr << (i ? ", " : "") << shape[i];
      }
      std::cerr << "); pass its patch; it must take one channel\n";
      return 2;
    }
    opts.batch_size = shape[0];
    if (argc > 8) opts.num_classes = std::stol(argv[8]);
    executor = model->AsExecutor(opts.batch_size);
    std::cout << "device: " << model->device() << "\n";
    std::cout << "package load: " << seconds(t_load, Clock::now())
              << " s\n";
  } else {
    std::cout << "device: none (threshold executor)\n";
  }

  const auto t0 = Clock::now();
  vnet::NiftiImage input = vnet::ReadNifti(input_path);
  const auto t1 = Clock::now();
  vnet::InferenceClient client(opts, executor);
  vnet::NiftiImage label = client.Run(input);
  const auto t2 = Clock::now();
  vnet::WriteNifti(label, output_path, /*as_uint8=*/true);
  const auto t3 = Clock::now();
  std::cout << "read " << seconds(t0, t1) << " s, run " << seconds(t1, t2)
            << " s, write " << seconds(t2, t3) << " s\n";
  std::cout << "inference time: " << seconds(t0, t3) << " s\n";
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Main(argc, argv);
  } catch (const std::exception& e) {
    std::cerr << "vnet_infer_torch: " << e.what() << "\n";
    return 1;
  }
}
