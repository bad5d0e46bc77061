// Native host-side image frontend of the port (a copy of the reference's
// native/frontend.cc; the decode, resize and crop arithmetic is unchanged,
// so both libraries give the same pixels from the same compiler).
//
// JPEG/PNG decode, shorter-side bilinear resize, center crop and batch
// assembly on a std::thread pool, so a multi-core host decodes many images
// in parallel while the card computes (Python's GIL serializes the cv2
// path).
//
// C ABI (ctypes-friendly), no Python.h dependency:
//   isf_load_batch(paths, n, size, out, ok, n_threads) -> number decoded
//     out: uint8 [n, size, size, 3] caller-allocated
//     ok:  uint8 [n] 1 = decoded, 0 = corrupt/missing (quarantine)
//
// Built at first use by instsearch_torch/data/native_frontend.py:
//   g++ -O3 -fPIC -std=c++17 -Wall -shared frontend.cc -o ... -ljpeg -lpng -pthread

#include <cstddef>
#include <cstdio>
#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB HWC
  int h = 0, w = 0;
  bool valid() const { return h > 0 && w > 0; }
};

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg with longjmp error recovery: corrupt files must not
// kill the process)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

Image decode_jpeg(FILE* f, int target_short) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return {};
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return {};
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain prescale: decode at the smallest 1/n (n = 1,2,4,8) that
  // keeps the shorter side >= target — decoding a 4032x3024 photo straight
  // to ~1/8 size is ~10x cheaper than full decode + resize.
  if (target_short > 0) {
    const int short_side = std::min(cinfo.image_width, cinfo.image_height);
    int denom = 1;
    while (denom < 8 && short_side / (denom * 2) >= target_short) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.data.resize(size_t(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data.data() + size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return img;
}

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

Image decode_png(FILE* f) {
  Image img;
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return {};
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return {};
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return {};
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return {};
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  // normalize everything to 8-bit RGB
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  img.data.resize(size_t(img.w) * img.h * 3);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; y++)
    rows[y] = img.data.data() + size_t(y) * img.w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return img;
}

Image decode_file(const char* path, int target_short) {
  FILE* f = fopen(path, "rb");
  if (!f) return {};
  int c0 = fgetc(f), c1 = fgetc(f);
  rewind(f);
  Image img;
  if (c0 == 0xFF && c1 == 0xD8) img = decode_jpeg(f, target_short);
  else if (c0 == 0x89 && c1 == 'P') img = decode_png(f);
  fclose(f);
  return img;
}

// ---------------------------------------------------------------------------
// Separable bilinear shorter-side resize + center crop into a square
// (pixel-center convention matching cv2.INTER_LINEAR). Two passes with
// precomputed fixed-point coefficient tables: horizontal u8 -> u16 rows,
// then vertical u16 -> u8 — float math only in table setup.
// ---------------------------------------------------------------------------

struct Taps {
  std::vector<int> i0, i1;       // source indices
  std::vector<int32_t> w1;       // weight of i1 in Q15 (w0 = 1 - w1)
};

Taps make_taps(int src_n, int dst_n, double scale, int offset) {
  Taps t;
  t.i0.resize(dst_n);
  t.i1.resize(dst_n);
  t.w1.resize(dst_n);
  for (int d = 0; d < dst_n; d++) {
    const double f = (d + offset + 0.5) * scale - 0.5;
    int i0 = std::clamp(int(std::floor(f)), 0, src_n - 1);
    int i1 = std::min(i0 + 1, src_n - 1);
    double w = std::clamp(f - i0, 0.0, 1.0);
    t.i0[d] = i0;
    t.i1[d] = i1;
    t.w1[d] = int32_t(std::lround(w * 32768.0));
  }
  return t;
}

void resize_crop(const Image& src, int size, uint8_t* out) {
  const double scale = double(size) / std::min(src.h, src.w);
  // round-half-EVEN to match Python round() in data/frontend.py:45 —
  // lround's half-away-from-zero gives a different canvas (and thus a
  // shifted center crop + different descriptors) on exact-.5 long sides
  const int nh = std::max<int>(1, int(std::nearbyint(src.h * scale)));
  const int nw = std::max<int>(1, int(std::nearbyint(src.w * scale)));
  const int y0 = std::max(0, (nh - size) / 2);
  const int x0 = std::max(0, (nw - size) / 2);
  const Taps tx = make_taps(src.w, size, double(src.w) / nw, x0);
  const Taps ty = make_taps(src.h, size, double(src.h) / nh, y0);

  // horizontal pass over the needed source rows only (union of ty taps)
  const int sy_lo = ty.i0[0], sy_hi = ty.i1[size - 1];
  const int rows = sy_hi - sy_lo + 1;
  std::vector<uint16_t> tmp(size_t(rows) * size * 3);  // Q? values 0..255<<0, stored as blended u16
  for (int sy = 0; sy < rows; sy++) {
    const uint8_t* srow = src.data.data() + size_t(sy + sy_lo) * src.w * 3;
    uint16_t* trow = tmp.data() + size_t(sy) * size * 3;
    for (int x = 0; x < size; x++) {
      const uint8_t* p0 = srow + tx.i0[x] * 3;
      const uint8_t* p1 = srow + tx.i1[x] * 3;
      const int32_t w1 = tx.w1[x], w0 = 32768 - w1;
      // result in [0, 255 << 7] (Q7) to keep vertical-pass precision
      trow[x * 3 + 0] = uint16_t((p0[0] * w0 + p1[0] * w1) >> 8);
      trow[x * 3 + 1] = uint16_t((p0[1] * w0 + p1[1] * w1) >> 8);
      trow[x * 3 + 2] = uint16_t((p0[2] * w0 + p1[2] * w1) >> 8);
    }
  }
  // vertical pass
  for (int y = 0; y < size; y++) {
    const uint16_t* r0 = tmp.data() + size_t(ty.i0[y] - sy_lo) * size * 3;
    const uint16_t* r1 = tmp.data() + size_t(ty.i1[y] - sy_lo) * size * 3;
    const int32_t w1 = ty.w1[y], w0 = 32768 - w1;
    uint8_t* orow = out + size_t(y) * size * 3;
    for (int i = 0; i < size * 3; i++) {
      // (Q7 * Q15) >> 22 -> u8 with rounding
      orow[i] = uint8_t(std::min<int32_t>(
          (int32_t(r0[i]) * w0 + int32_t(r1[i]) * w1 + (1 << 21)) >> 22, 255));
    }
  }
}

}  // namespace

extern "C" {

// Decode one image into out[size*size*3]; returns 1 on success, 0 on failure.
int isf_load_one(const char* path, int size, uint8_t* out) {
  Image img = decode_file(path, size);
  if (!img.valid()) return 0;
  resize_crop(img, size, out);
  return 1;
}

// Threaded batch load. out: [n, size, size, 3]; ok: [n]. Returns #decoded.
int isf_load_batch(const char** paths, int n, int size, uint8_t* out,
                   uint8_t* ok, int n_threads) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, n);
  std::atomic<int> next(0), good(0);
  const size_t stride = size_t(size) * size * 3;
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      ok[i] = uint8_t(isf_load_one(paths[i], size, out + stride * i));
      if (ok[i]) good.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return good.load();
}

}  // extern "C"
