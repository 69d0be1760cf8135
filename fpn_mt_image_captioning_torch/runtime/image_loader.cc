// Native image-loading runtime: PNG decode (zlib) + bilinear resize +
// MobileNetV2 normalization, multi-threaded batch API.
//
// The PyTorch port's copy of fpn_mt_image_captioning_tpu/runtime/image_loader.cc
// (same code; the port imports nothing of the JAX package). The reference's
// input pipeline is tf.data's C++ runtime under a thin Python veneer
// (decode_jpeg/resize/preprocess_input in its dataset.py). This is the
// framework's native equivalent: a dependency-free PNG
// decoder (IHDR/PLTE/IDAT parse, zlib inflate, per-scanline unfiltering for all
// five filter types), a separable bilinear resampler, and [-1, 1] scaling — so
// the host never round-trips pixels through Python objects. Exposed to Python
// via ctypes (see native_loader.py); PIL remains the fallback when the shared
// object is unavailable.
//
// Supported: 8-bit PNG in gray / gray+alpha / RGB / RGBA / palette formats,
// plus binary PPM (P6) and PGM (P5). Output: float32 HWC RGB in [-1, 1].

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> pixels;  // interleaved, 8-bit
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  std::vector<uint8_t> buf(1 << 18);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = static_cast<uInt>(buf.size());
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

bool decode_png(const uint8_t* data, size_t len, Image* img) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(data, kSig, 8) != 0) return false;

  size_t off = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  std::vector<uint8_t> trns;

  while (off + 8 <= len) {
    uint32_t clen = read_be32(data + off);
    const char* ctype = reinterpret_cast<const char*>(data + off + 4);
    const uint8_t* cdata = data + off + 8;
    if (off + 12 + clen > len) return false;
    if (memcmp(ctype, "IHDR", 4) == 0) {
      // the reads below touch 13 bytes of chunk payload; the bounds check
      // above only guarantees clen of them
      if (clen < 13) return false;
      w = static_cast<int>(read_be32(cdata));
      h = static_cast<int>(read_be32(cdata + 4));
      bit_depth = cdata[8];
      color_type = cdata[9];
      interlace = cdata[12];
      if (bit_depth != 8 || interlace != 0) return false;  // out of scope
    } else if (memcmp(ctype, "PLTE", 4) == 0) {
      palette.assign(cdata, cdata + clen);
    } else if (memcmp(ctype, "tRNS", 4) == 0) {
      trns.assign(cdata, cdata + clen);
    } else if (memcmp(ctype, "IDAT", 4) == 0) {
      idat.insert(idat.end(), cdata, cdata + clen);
    } else if (memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    off += 12 + clen;
  }
  if (w <= 0 || h <= 0) return false;

  int src_ch;
  switch (color_type) {
    case 0: src_ch = 1; break;   // gray
    case 2: src_ch = 3; break;   // RGB
    case 3: src_ch = 1; break;   // palette index
    case 4: src_ch = 2; break;   // gray+alpha
    case 6: src_ch = 4; break;   // RGBA
    default: return false;
  }

  std::vector<uint8_t> raw;
  if (!inflate_all(idat, raw)) return false;
  const size_t stride = static_cast<size_t>(w) * src_ch;
  if (raw.size() < (stride + 1) * h) return false;

  std::vector<uint8_t> recon(stride * h);
  const int bpp = src_ch;
  for (int y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = raw.data() + y * (stride + 1) + 1;
    uint8_t* dst = recon.data() + y * stride;
    const uint8_t* prev = y > 0 ? recon.data() + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }

  // expand to RGB
  img->w = w;
  img->h = h;
  img->channels = 3;
  img->pixels.resize(static_cast<size_t>(w) * h * 3);
  uint8_t* out = img->pixels.data();
  for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
    const uint8_t* p = recon.data() + i * src_ch;
    uint8_t r, g, b;
    switch (color_type) {
      case 0: case 4: r = g = b = p[0]; break;
      case 2: case 6: r = p[0]; g = p[1]; b = p[2]; break;
      case 3: {
        size_t idx = static_cast<size_t>(p[0]) * 3;
        if (idx + 2 >= palette.size()) return false;
        r = palette[idx]; g = palette[idx + 1]; b = palette[idx + 2];
        break;
      }
      default: return false;
    }
    out[i * 3] = r; out[i * 3 + 1] = g; out[i * 3 + 2] = b;
  }
  return true;
}

bool decode_pnm(const uint8_t* data, size_t len, Image* img) {
  if (len < 2 || data[0] != 'P' || (data[1] != '5' && data[1] != '6'))
    return false;
  int ch = data[1] == '6' ? 3 : 1;
  size_t off = 2;
  int vals[3], vi = 0;
  while (vi < 3 && off < len) {
    while (off < len && (data[off] == ' ' || data[off] == '\n' ||
                         data[off] == '\t' || data[off] == '\r'))
      ++off;
    if (off < len && data[off] == '#') {
      while (off < len && data[off] != '\n') ++off;
      continue;
    }
    int v = 0;
    bool any = false;
    while (off < len && data[off] >= '0' && data[off] <= '9') {
      v = v * 10 + (data[off] - '0');
      ++off;
      any = true;
    }
    if (!any) return false;
    vals[vi++] = v;
  }
  if (vi != 3 || vals[2] != 255) return false;
  ++off;  // single whitespace after maxval
  int w = vals[0], h = vals[1];
  // zero-dimension headers pass the size check below (0 bytes needed) but
  // would send resize_normalize's clamp to index -1 on an empty pixel vector
  if (w <= 0 || h <= 0) return false;
  if (off + static_cast<size_t>(w) * h * ch > len) return false;
  img->w = w;
  img->h = h;
  img->channels = 3;
  img->pixels.resize(static_cast<size_t>(w) * h * 3);
  for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
    const uint8_t* p = data + off + i * ch;
    uint8_t r = p[0], g = ch == 3 ? p[1] : p[0], b = ch == 3 ? p[2] : p[0];
    img->pixels[i * 3] = r;
    img->pixels[i * 3 + 1] = g;
    img->pixels[i * 3 + 2] = b;
  }
  return true;
}

// Bilinear resize (align_corners=false, half-pixel centers — matches
// tf.image.resize defaults) + scale to [-1, 1].
void resize_normalize(const Image& img, int size, float* out) {
  const float sy = static_cast<float>(img.h) / size;
  const float sx = static_cast<float>(img.w) / size;
  for (int y = 0; y < size; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > img.h - 1) y0 = img.h - 1;
    int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < size; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > img.w - 1) x0 = img.w - 1;
      int x1 = x0 + 1 < img.w ? x0 + 1 : img.w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = img.pixels[(static_cast<size_t>(y0) * img.w + x0) * 3 + c];
        float v01 = img.pixels[(static_cast<size_t>(y0) * img.w + x1) * 3 + c];
        float v10 = img.pixels[(static_cast<size_t>(y1) * img.w + x0) * 3 + c];
        float v11 = img.pixels[(static_cast<size_t>(y1) * img.w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        out[(static_cast<size_t>(y) * size + x) * 3 + c] = v / 127.5f - 1.0f;
      }
    }
  }
}

bool load_one(const char* path, int size, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    fclose(f);
    return false;
  }
  std::vector<uint8_t> data(static_cast<size_t>(len));
  size_t got = fread(data.data(), 1, data.size(), f);
  fclose(f);
  if (got != data.size()) return false;

  Image img;
  if (!decode_png(data.data(), data.size(), &img) &&
      !decode_pnm(data.data(), data.size(), &img))
    return false;
  resize_normalize(img, size, out);
  return true;
}

}  // namespace

extern "C" {

// Decode + resize + normalize a batch of image files into out[n, size, size, 3]
// float32. Returns the number of successfully decoded images; rows for failed
// paths are zero-filled and reported via ok[i] = 0.
int fpnmt_decode_batch(const char** paths, int n, int size, float* out,
                       uint8_t* ok, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> workers;
  std::vector<int> success(num_threads, 0);
  const size_t plane = static_cast<size_t>(size) * size * 3;

  auto work = [&](int tid) {
    for (int i = tid; i < n; i += num_threads) {
      bool good = load_one(paths[i], size, out + plane * i);
      if (!good) memset(out + plane * i, 0, plane * sizeof(float));
      ok[i] = good ? 1 : 0;
      if (good) ++success[tid];
    }
  };
  if (num_threads == 1) {
    work(0);
  } else {
    for (int t = 0; t < num_threads; ++t) workers.emplace_back(work, t);
    for (auto& w : workers) w.join();
  }
  int total = 0;
  for (int s : success) total += s;
  return total;
}

}  // extern "C"
