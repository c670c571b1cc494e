// C++ tests of the PyTorch port's native runtime (no external test
// framework: CHECK-based; tests/test_torch_native.py runs the binary).
//
//   vnet_native_test_torch <tmpdir> [<package.pt2> <input.f32> <expected.f32>]
//
// The cases of the JAX package's csrc/native_test.cc that need no PJRT
// (thread pool, queue, host ops, NIfTI round trip under <tmpdir>, the
// inference client with a host executor), then, given a package, the
// libtorch executor: its forward against expected probabilities (raw f32
// files, the input of the package's shape), and AsExecutor on 2B + 1
// patches (three chunks, the last padded) against one run a patch.

#include <algorithm>
#include <array>
#include <cassert>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iterator>
#include <numeric>
#include <stdexcept>
#include <string>
#include <vector>

#include "inference_client.h"
#include "libtorch_executor.h"
#include "safe_queue.h"
#include "thread_pool.h"

extern "C" {
void vnet_window_normalize(const float*, float*, int64_t, float, float, float,
                           float);
int64_t vnet_patch_grid(const int64_t*, const int64_t*, const int64_t*,
                        int64_t*, int64_t);
void vnet_extract_patches(const float*, const int64_t*, int64_t,
                          const int64_t*, const int64_t*, int64_t, float*,
                          int);
void vnet_blend_accumulate(float*, float*, const int64_t*, int64_t,
                           const float*, const float*, const int64_t*,
                           const int64_t*, int64_t);
}

#define CHECK(cond)                                             \
  do {                                                          \
    if (!(cond)) {                                              \
      std::fprintf(stderr, "FAILED: %s at %s:%d\n", #cond,      \
                   __FILE__, __LINE__);                         \
      return 1;                                                 \
    }                                                           \
  } while (0)

static int TestThreadPool() {
  vnet::ThreadPool pool(4);
  std::vector<std::future<int>> futs;
  for (int i = 0; i < 100; ++i) {
    futs.push_back(pool.Submit([i] { return i * i; }));
  }
  long sum = 0;
  for (auto& f : futs) sum += f.get();
  CHECK(sum == 328350);
  return 0;
}

static int TestSafeQueue() {
  vnet::SafeQueue<int> q(4);
  std::thread producer([&] {
    for (int i = 0; i < 50; ++i) q.Push(i);
    q.Close();
  });
  long sum = 0;
  int count = 0;
  while (auto v = q.Pop()) {
    sum += *v;
    ++count;
  }
  producer.join();
  CHECK(count == 50);
  CHECK(sum == 1225);
  return 0;
}

static int TestWindowNormalize() {
  float in[4] = {-100.f, 0.f, 300.f, 900.f};
  float out[4];
  vnet_window_normalize(in, out, 4, 0.f, 600.f, 0.f, 255.f);
  CHECK(out[0] == 0.f);
  CHECK(out[1] == 0.f);
  CHECK(std::fabs(out[2] - 127.5f) < 1e-3);
  CHECK(out[3] == 255.f);
  return 0;
}

static int TestPatchGrid() {
  // matches vnet_tpu.infer.patch_starts_1d: dim 10, patch 4, stride 4 ->
  // starts 0,4,6 per axis
  int64_t shape[3] = {10, 4, 4};
  int64_t patch[3] = {4, 4, 4};
  int64_t stride[3] = {4, 4, 4};
  int64_t n = vnet_patch_grid(shape, patch, stride, nullptr, 0);
  CHECK(n == 3);
  std::vector<int64_t> starts(3 * n);
  vnet_patch_grid(shape, patch, stride, starts.data(), n);
  CHECK(starts[0] == 0 && starts[3] == 4 && starts[6] == 6);
  return 0;
}

static int TestExtractAndBlend() {
  int64_t shape[3] = {6, 6, 6};
  std::vector<float> vol(216);
  std::iota(vol.begin(), vol.end(), 0.0f);
  int64_t patch[3] = {4, 4, 4};
  int64_t starts[6] = {0, 0, 0, 2, 2, 2};

  std::vector<float> patches(2 * 64);
  vnet_extract_patches(vol.data(), shape, 1, patch, starts, 2,
                       patches.data(), 2);
  // patch 0 element (1,2,3) = vol[1*36+2*6+3] = 51
  CHECK(patches[(1 * 4 + 2) * 4 + 3] == 51.0f);
  // patch 1 element (0,0,0) = vol[2*36+2*6+2] = 86
  CHECK(patches[64] == 86.0f);

  // blend: probs all ones, C=2
  std::vector<float> acc(216 * 2, 0.f), weight(216, 0.f);
  std::vector<float> probs(2 * 64 * 2, 1.0f), window(64, 1.0f);
  vnet_blend_accumulate(acc.data(), weight.data(), shape, 2, probs.data(),
                        window.data(), patch, starts, 2);
  // voxel (3,3,3) covered by both patches
  CHECK(weight[3 * 36 + 3 * 6 + 3] == 2.0f);
  CHECK(weight[0] == 1.0f);
  CHECK(weight[5 * 36 + 5 * 6 + 5] == 1.0f);
  CHECK(acc[(3 * 36 + 3 * 6 + 3) * 2 + 1] == 2.0f);
  return 0;
}

static int TestNiftiRoundtrip(const std::string& tmpdir) {
  vnet::NiftiImage img;
  img.shape = {5, 4, 3};
  img.spacing = {1.5, 2.0, 2.5};
  img.origin = {-10, 4, 7.5};
  img.data.resize(60);
  std::iota(img.data.begin(), img.data.end(), 0.0f);

  const std::string path = tmpdir + "/vnet_native_test.nii.gz";
  vnet::WriteNifti(img, path);
  vnet::NiftiImage back = vnet::ReadNifti(path);
  CHECK(back.shape == img.shape);
  for (int i = 0; i < 3; ++i) {
    CHECK(std::fabs(back.spacing[i] - img.spacing[i]) < 1e-4);
    CHECK(std::fabs(back.origin[i] - img.origin[i]) < 1e-3);
  }
  for (size_t i = 0; i < img.data.size(); ++i) {
    CHECK(back.data[i] == img.data[i]);
  }
  return 0;
}

static int TestInferenceClientEndToEnd() {
  // bright cube in a dark volume; threshold executor must recover it
  vnet::NiftiImage input;
  input.shape = {24, 24, 24};
  input.spacing = {1, 1, 1};
  input.data.assign(24 * 24 * 24, 10.0f);
  for (int64_t x = 8; x < 16; ++x)
    for (int64_t y = 8; y < 16; ++y)
      for (int64_t z = 8; z < 16; ++z)
        input.data[(x * 24 + y) * 24 + z] = 400.0f;

  vnet::InferenceOptions opts;
  opts.patch_shape = {16, 16, 16};
  opts.stride = {8, 8, 8};
  opts.batch_size = 2;
  opts.num_classes = 2;
  opts.window_min = 0;
  opts.window_max = 600;
  opts.spacing = {1, 1, 1};
  opts.num_threads = 3;

  auto executor = [](const std::vector<float>& patches, int64_t n,
                     const std::array<int64_t, 3>& patch, int64_t classes) {
    const int64_t elems = patch[0] * patch[1] * patch[2];
    std::vector<float> probs((size_t)(n * elems * classes), 0.f);
    for (int64_t i = 0; i < n * elems; ++i) {
      const bool fg = patches[(size_t)i] > 100.0f;
      probs[(size_t)(i * classes)] = fg ? 0.f : 1.f;
      probs[(size_t)(i * classes + 1)] = fg ? 1.f : 0.f;
    }
    return probs;
  };

  vnet::InferenceClient client(opts, executor);
  vnet::NiftiImage label = client.Run(input);
  CHECK(label.shape == input.shape);
  CHECK(label.data[(12 * 24 + 12) * 24 + 12] == 1.0f);
  CHECK(label.data[(2 * 24 + 2) * 24 + 2] == 0.0f);
  return 0;
}

static int TestInferenceClientExecutorFailure() {
  // an executor that throws mid-run must surface the error (not hang the
  // producer/pipeline) and leave the client reusable
  vnet::NiftiImage input;
  input.shape = {16, 16, 16};
  input.spacing = {1, 1, 1};
  input.data.assign(16 * 16 * 16, 10.0f);

  vnet::InferenceOptions opts;
  opts.patch_shape = {8, 8, 8};
  opts.stride = {8, 8, 8};
  opts.batch_size = 2;
  opts.num_classes = 2;
  opts.window_min = 0;
  opts.window_max = 600;
  opts.num_threads = 2;

  int calls = 0;
  auto executor = [&calls](const std::vector<float>& patches, int64_t n,
                           const std::array<int64_t, 3>& patch,
                           int64_t classes) -> std::vector<float> {
    if (++calls == 2) throw std::runtime_error("boom");
    const int64_t elems = patch[0] * patch[1] * patch[2];
    return std::vector<float>((size_t)(n * elems * classes), 0.5f);
  };
  vnet::InferenceClient client(opts, executor);
  bool threw = false;
  try {
    client.Run(input);
  } catch (const std::exception& e) {
    threw = std::string(e.what()) == "boom";
  }
  CHECK(threw);
  return 0;
}

static std::vector<float> ReadF32(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::vector<char> bytes((std::istreambuf_iterator<char>(f)),
                          std::istreambuf_iterator<char>());
  std::vector<float> values(bytes.size() / sizeof(float));
  std::memcpy(values.data(), bytes.data(), values.size() * sizeof(float));
  return values;
}

// The package's forward on `input` against `expected` (probabilities that
// the caller computed with another implementation), within 1e-5; a wrong
// input shape is refused before the forward runs.
static int TestLibtorchExecutorForward(const std::string& package,
                                       const std::vector<float>& input,
                                       const std::vector<float>& expected) {
  vnet::LibtorchExecutor exec(package);
  const std::vector<int64_t> dims = exec.input_shape();
  CHECK(dims.size() == 5);
  std::vector<int64_t> out_dims;
  const std::vector<float> probs = exec.Run(input, dims, &out_dims);
  CHECK(out_dims.size() == 5);
  for (int i = 0; i < 4; ++i) CHECK(out_dims[i] == dims[i]);
  CHECK(probs.size() == expected.size());
  float worst = 0.f;
  for (size_t i = 0; i < probs.size(); ++i) {
    worst = std::max(worst, std::fabs(probs[i] - expected[i]));
  }
  std::printf("forward on %s: max |diff| %.3g\n", exec.device().c_str(),
              worst);
  CHECK(worst <= 1e-5f);

  std::vector<int64_t> wrong = dims;
  wrong[0] += 1;
  bool refused = false;
  try {
    exec.Run(std::vector<float>(input.size() / dims[0] * wrong[0]), wrong);
  } catch (const std::invalid_argument&) {
    refused = true;
  }
  CHECK(refused);
  return 0;
}

// AsExecutor(B) on n = 2B + 1 patches (chunks B, B and a tail of 1 padded
// to B) against n single runs, each a batch of B copies of one patch.
// Rows of one batch are computed independently; the bound leaves room for
// a vectorised loop that splits the batch another way.
static int TestLibtorchExecutorChunks(const std::string& package,
                                      const std::vector<float>& input) {
  vnet::LibtorchExecutor exec(package);
  const std::vector<int64_t> dims = exec.input_shape();
  const int64_t batch = dims[0];
  const std::array<int64_t, 3> patch = {dims[1], dims[2], dims[3]};
  const int64_t voxels = patch[0] * patch[1] * patch[2];
  const int64_t n = 2 * batch + 1;
  std::vector<float> patches((size_t)(n * voxels));
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t v = 0; v < voxels; ++v) {
      patches[(size_t)(i * voxels + v)] =
          input[(size_t)((i % batch) * voxels + v)] * (1.0f + 0.25f * i);
    }
  }
  std::vector<int64_t> out_dims;
  const std::vector<float> first(patches.begin(),
                                 patches.begin() + batch * voxels);
  exec.Run(first, dims, &out_dims);
  const int64_t classes = out_dims.back();
  const std::vector<float> chunked =
      exec.AsExecutor(batch)(patches, n, patch, classes);
  CHECK((int64_t)chunked.size() == n * voxels * classes);
  float worst = 0.f;
  for (int64_t i = 0; i < n; ++i) {
    std::vector<float> single((size_t)(batch * voxels));
    for (int64_t b = 0; b < batch; ++b) {
      std::memcpy(single.data() + b * voxels, patches.data() + i * voxels,
                  (size_t)voxels * sizeof(float));
    }
    const std::vector<float> probs = exec.Run(single, dims);
    for (int64_t k = 0; k < voxels * classes; ++k) {
      const float got = chunked[(size_t)(i * voxels * classes + k)];
      worst = std::max(worst, std::fabs(got - probs[(size_t)k]));
    }
  }
  std::printf("AsExecutor(%lld) on %lld patches: max |diff| %.3g\n",
              (long long)batch, (long long)n, worst);
  CHECK(worst <= 1e-6f);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2 && argc != 5) {
    std::fprintf(stderr,
                 "usage: vnet_native_test_torch <tmpdir> [<package.pt2> "
                 "<input.f32> <expected.f32>]\n");
    return 2;
  }
  int failures = 0;
  failures += TestThreadPool();
  failures += TestSafeQueue();
  failures += TestWindowNormalize();
  failures += TestPatchGrid();
  failures += TestExtractAndBlend();
  failures += TestNiftiRoundtrip(argv[1]);
  failures += TestInferenceClientEndToEnd();
  failures += TestInferenceClientExecutorFailure();
  if (argc == 5) {
    const std::vector<float> input = ReadF32(argv[3]);
    failures += TestLibtorchExecutorForward(argv[2], input, ReadF32(argv[4]));
    failures += TestLibtorchExecutorChunks(argv[2], input);
  }
  if (failures) {
    std::fprintf(stderr, "%d test(s) failed\n", failures);
    return 1;
  }
  std::printf("all native tests passed\n");
  return 0;
}
