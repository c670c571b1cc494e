#include "nifti_io.h"

#include <zlib.h>

#include <cmath>
#include <cstring>
#include <fstream>
#include <stdexcept>

namespace vnet {
namespace {

bool EndsWith(const std::string& s, const std::string& suffix) {
  return s.size() >= suffix.size() &&
         s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
}

std::vector<char> ReadAll(const std::string& path) {
  if (EndsWith(path, ".gz")) {
    gzFile f = gzopen(path.c_str(), "rb");
    if (!f) throw std::runtime_error("cannot open " + path);
    std::vector<char> out;
    char buf[1 << 16];
    int n;
    while ((n = gzread(f, buf, sizeof(buf))) > 0) {
      out.insert(out.end(), buf, buf + n);
    }
    gzclose(f);
    return out;
  }
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  return std::vector<char>((std::istreambuf_iterator<char>(f)),
                           std::istreambuf_iterator<char>());
}

void WriteAll(const std::string& path, const std::vector<char>& bytes) {
  if (EndsWith(path, ".gz")) {
    gzFile f = gzopen(path.c_str(), "wb");
    if (!f) throw std::runtime_error("cannot open " + path);
    if (gzwrite(f, bytes.data(), (unsigned)bytes.size()) !=
        (int)bytes.size()) {
      gzclose(f);
      throw std::runtime_error("short gz write " + path);
    }
    gzclose(f);
    return;
  }
  std::ofstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  f.write(bytes.data(), (std::streamsize)bytes.size());
}

template <typename T>
T Get(const std::vector<char>& b, size_t off) {
  T v;
  std::memcpy(&v, b.data() + off, sizeof(T));
  return v;
}

template <typename T>
void Put(std::vector<char>& b, size_t off, T v) {
  std::memcpy(b.data() + off, &v, sizeof(T));
}

template <typename Src>
void ConvertTo(const std::vector<char>& raw, size_t offset, int64_t count,
               std::vector<float>* out) {
  out->resize((size_t)count);
  const Src* src = reinterpret_cast<const Src*>(raw.data() + offset);
  for (int64_t i = 0; i < count; ++i) (*out)[i] = (float)src[i];
}

}  // namespace

NiftiImage ReadNifti(const std::string& path) {
  std::vector<char> raw = ReadAll(path);
  if (raw.size() < 352) throw std::runtime_error(path + ": truncated NIfTI");
  if (Get<int32_t>(raw, 0) != 348) {
    throw std::runtime_error(path + ": not little-endian NIfTI-1");
  }
  int16_t dim[8];
  std::memcpy(dim, raw.data() + 40, sizeof(dim));
  const int ndim = dim[0];
  if (ndim < 2 || ndim > 4) {
    throw std::runtime_error(path + ": unsupported ndim");
  }
  NiftiImage img;
  img.shape = {dim[1], (int64_t)(ndim >= 2 ? dim[2] : 1),
               (int64_t)(ndim >= 3 ? dim[3] : 1)};
  if (ndim == 4 && dim[4] != 1) {
    throw std::runtime_error(path + ": 4D volumes unsupported");
  }
  const int16_t datatype = Get<int16_t>(raw, 70);
  float pixdim[8];
  std::memcpy(pixdim, raw.data() + 76, sizeof(pixdim));
  const size_t vox_offset = (size_t)Get<float>(raw, 108);
  const float scl_slope = Get<float>(raw, 112);
  const float scl_inter = Get<float>(raw, 116);
  const int16_t sform_code = Get<int16_t>(raw, 254);

  const int64_t count = img.size();
  switch (datatype) {
    case 2:  ConvertTo<uint8_t>(raw, vox_offset, count, &img.data); break;
    case 4:  ConvertTo<int16_t>(raw, vox_offset, count, &img.data); break;
    case 8:  ConvertTo<int32_t>(raw, vox_offset, count, &img.data); break;
    case 16: ConvertTo<float>(raw, vox_offset, count, &img.data); break;
    case 64: ConvertTo<double>(raw, vox_offset, count, &img.data); break;
    case 256: ConvertTo<int8_t>(raw, vox_offset, count, &img.data); break;
    case 512: ConvertTo<uint16_t>(raw, vox_offset, count, &img.data); break;
    default:
      throw std::runtime_error(path + ": unsupported datatype");
  }
  if (scl_slope != 0.0f && (scl_slope != 1.0f || scl_inter != 0.0f)) {
    for (auto& v : img.data) v = v * scl_slope + scl_inter;
  }

  // NIfTI stores x-fastest (Fortran); convert to C-contiguous [x][y][z].
  {
    std::vector<float> c(img.data.size());
    const int64_t X = img.shape[0], Y = img.shape[1], Z = img.shape[2];
    for (int64_t z = 0; z < Z; ++z)
      for (int64_t y = 0; y < Y; ++y)
        for (int64_t x = 0; x < X; ++x)
          c[(x * Y + y) * Z + z] = img.data[(z * Y + y) * X + x];
    img.data.swap(c);
  }

  if (sform_code > 0) {
    float srow[12];
    std::memcpy(srow, raw.data() + 280, sizeof(srow));
    // RAS -> LPS: negate first two rows.
    double lps[12];
    for (int i = 0; i < 12; ++i) {
      lps[i] = (i < 8) ? -srow[i] : srow[i];
    }
    for (int c = 0; c < 3; ++c) {
      const double sx = std::sqrt(lps[c] * lps[c] + lps[4 + c] * lps[4 + c] +
                                  lps[8 + c] * lps[8 + c]);
      img.spacing[c] = sx > 0 ? sx : 1.0;
      img.direction[0 * 3 + c] = lps[c] / img.spacing[c];
      img.direction[1 * 3 + c] = lps[4 + c] / img.spacing[c];
      img.direction[2 * 3 + c] = lps[8 + c] / img.spacing[c];
    }
    img.origin = {lps[3], lps[7], lps[11]};
  } else {
    img.spacing = {pixdim[1] ? pixdim[1] : 1.0, pixdim[2] ? pixdim[2] : 1.0,
                   pixdim[3] ? pixdim[3] : 1.0};
  }
  return img;
}

void WriteNifti(const NiftiImage& image, const std::string& path,
                bool as_uint8) {
  const int64_t X = image.shape[0], Y = image.shape[1], Z = image.shape[2];
  const int64_t count = image.size();
  const size_t elem = as_uint8 ? 1 : 4;
  std::vector<char> out(352 + (size_t)count * elem, 0);

  Put<int32_t>(out, 0, 348);
  int16_t dim[8] = {3, (int16_t)X, (int16_t)Y, (int16_t)Z, 1, 1, 1, 1};
  std::memcpy(out.data() + 40, dim, sizeof(dim));
  Put<int16_t>(out, 70, as_uint8 ? 2 : 16);          // datatype
  Put<int16_t>(out, 72, as_uint8 ? 8 : 32);          // bitpix
  float pixdim[8] = {1.f, (float)image.spacing[0], (float)image.spacing[1],
                     (float)image.spacing[2], 1.f, 1.f, 1.f, 1.f};
  std::memcpy(out.data() + 76, pixdim, sizeof(pixdim));
  Put<float>(out, 108, 352.0f);  // vox_offset
  Put<float>(out, 112, 1.0f);    // scl_slope
  Put<int16_t>(out, 252, 0);     // qform none
  Put<int16_t>(out, 254, 2);     // sform aligned
  // LPS -> RAS sform rows
  for (int r = 0; r < 3; ++r) {
    const double sign = r < 2 ? -1.0 : 1.0;
    float row[4];
    for (int c = 0; c < 3; ++c) {
      row[c] = (float)(sign * image.direction[r * 3 + c] * image.spacing[c]);
    }
    row[3] = (float)(sign * image.origin[r]);
    std::memcpy(out.data() + 280 + r * 16, row, sizeof(row));
  }
  std::memcpy(out.data() + 344, "n+1\0", 4);

  // C-contiguous [x][y][z] -> Fortran (x fastest)
  for (int64_t z = 0; z < Z; ++z) {
    for (int64_t y = 0; y < Y; ++y) {
      for (int64_t x = 0; x < X; ++x) {
        const float v = image.data[(size_t)((x * Y + y) * Z + z)];
        const size_t off = 352 + (size_t)((z * Y + y) * X + x) * elem;
        if (as_uint8) {
          out[off] = (char)(uint8_t)std::lround(v);
        } else {
          std::memcpy(out.data() + off, &v, 4);
        }
      }
    }
  }
  WriteAll(path, out);
}

}  // namespace vnet
