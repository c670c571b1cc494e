// Minimal NIfTI-1 reader/writer for the native inference client —
// counterpart of the ITK I/O the reference's cxx app used
// (tf_inference.cpp:153-209). Supports .nii and .nii.gz (zlib), float32
// conversion on read, sform-based LPS geometry like vnet_tpu.io.nifti.
#pragma once

#include <array>
#include <cstdint>
#include <string>
#include <vector>

namespace vnet {

struct NiftiImage {
  std::array<int64_t, 3> shape{1, 1, 1};   // (x, y, z)
  std::array<double, 3> spacing{1, 1, 1};
  std::array<double, 3> origin{0, 0, 0};
  std::array<double, 9> direction{1, 0, 0, 0, 1, 0, 0, 0, 1};  // row-major
  std::vector<float> data;  // C-contiguous [x][y][z]

  int64_t size() const { return shape[0] * shape[1] * shape[2]; }
};

// Throws std::runtime_error on parse failure.
NiftiImage ReadNifti(const std::string& path);

// Writes float32 (or uint8 if as_uint8) NIfTI-1 with sform geometry.
void WriteNifti(const NiftiImage& image, const std::string& path,
                bool as_uint8 = false);

}  // namespace vnet
