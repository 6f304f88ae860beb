// Native data-loading backend: JPEG/PNG decode + short-side resize + crop +
// [-1,1] normalize, parallelized with a std::thread pool.
//
// The reference feeds its trainer through torch DataLoader worker processes
// (test_fatezero.py:143-149 — num_workers=4|16, all native decode inside
// torchvision/PIL). This is the framework's equivalent: one .so, C ABI,
// ctypes-bound (no pybind11 in the image), used by
// fatezero_tpu/data/dataset.py when built, PIL fallback otherwise.
//
// Build: fatezero_tpu/native/build.sh  (g++ -O3 -shared -ljpeg -lpng)
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved RGB
};

// ----------------------------------------------------------------- decode
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);
  // normalize to 8-bit RGB
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->w = int(w);
  out->h = int(h);
  out->c = 3;
  out->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 i = 0; i < h; ++i) rows[i] = out->data.data() + size_t(i) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && !png_sig_cmp(magic, 0, 8)) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// ------------------------------------------------- resize / crop / normalize
// Area-average (box-filter) resample for downscale — the antialiased path,
// matching torch's antialias=True bilinear closely. Each destination pixel
// averages the exactly-covered source box.
void resize_area(const Image& src, int dst_w, int dst_h, std::vector<float>* out) {
  out->resize(size_t(dst_w) * dst_h * 3);
  const double sx = double(src.w) / dst_w;
  const double sy = double(src.h) / dst_h;
  for (int y = 0; y < dst_h; ++y) {
    double y_lo = y * sy, y_hi = (y + 1) * sy;
    int iy0 = int(y_lo), iy1 = std::min(src.h, int(std::ceil(y_hi)));
    for (int x = 0; x < dst_w; ++x) {
      double x_lo = x * sx, x_hi = (x + 1) * sx;
      int ix0 = int(x_lo), ix1 = std::min(src.w, int(std::ceil(x_hi)));
      double acc[3] = {0, 0, 0}, wsum = 0;
      for (int yy = iy0; yy < iy1; ++yy) {
        double wy = std::min<double>(yy + 1, y_hi) - std::max<double>(yy, y_lo);
        for (int xx = ix0; xx < ix1; ++xx) {
          double wx = std::min<double>(xx + 1, x_hi) - std::max<double>(xx, x_lo);
          double w = wx * wy;
          const uint8_t* p = &src.data[(size_t(yy) * src.w + xx) * 3];
          acc[0] += w * p[0];
          acc[1] += w * p[1];
          acc[2] += w * p[2];
          wsum += w;
        }
      }
      float* d = &(*out)[(size_t(y) * dst_w + x) * 3];
      d[0] = float(acc[0] / wsum);
      d[1] = float(acc[1] / wsum);
      d[2] = float(acc[2] / wsum);
    }
  }
}

// Bilinear resample of RGB u8 -> RGB float (upscale path).
void resize_bilinear(const Image& src, int dst_w, int dst_h, std::vector<float>* out) {
  out->resize(size_t(dst_w) * dst_h * 3);
  const float sx = float(src.w) / dst_w;
  const float sy = float(src.h) / dst_h;
  for (int y = 0; y < dst_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(src.h - 1, int(fy)));
    int y1 = std::min(src.h - 1, y0 + 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dst_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(src.w - 1, int(fx)));
      int x1 = std::min(src.w - 1, x0 + 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int ch = 0; ch < 3; ++ch) {
        float v00 = src.data[(size_t(y0) * src.w + x0) * 3 + ch];
        float v01 = src.data[(size_t(y0) * src.w + x1) * 3 + ch];
        float v10 = src.data[(size_t(y1) * src.w + x0) * 3 + ch];
        float v11 = src.data[(size_t(y1) * src.w + x1) * 3 + ch];
        float v0 = v00 + (v01 - v00) * wx;
        float v1 = v10 + (v11 - v10) * wx;
        (*out)[(size_t(y) * dst_w + x) * 3 + ch] = v0 + (v1 - v0) * wy;
      }
    }
  }
}

// Full per-image pipeline into out[f, S, S, 3] (range [-1, 1]).
bool load_one(const char* path, int image_size, int crop_x, int crop_y, float* out) {
  Image img;
  if (!decode_file(path, &img)) return false;
  // short-side scale
  int short_side = std::min(img.w, img.h);
  float scale = float(image_size) / short_side;
  int nw = std::max(image_size, int(img.w * scale + 0.5f));
  int nh = std::max(image_size, int(img.h * scale + 0.5f));
  std::vector<float> resized;
  if (scale < 1.0f) {
    resize_area(img, nw, nh, &resized);  // antialiased downscale
  } else {
    resize_bilinear(img, nw, nh, &resized);
  }
  // crop: center by default (negative crop coords), explicit offset otherwise
  int cx = crop_x >= 0 ? crop_x : (nw - image_size) / 2;
  int cy = crop_y >= 0 ? crop_y : (nh - image_size) / 2;
  cx = std::max(0, std::min(cx, nw - image_size));
  cy = std::max(0, std::min(cy, nh - image_size));
  for (int y = 0; y < image_size; ++y) {
    const float* srow = resized.data() + (size_t(cy + y) * nw + cx) * 3;
    float* drow = out + size_t(y) * image_size * 3;
    for (int i = 0; i < image_size * 3; ++i) drow[i] = srow[i] / 127.5f - 1.0f;
  }
  return true;
}

}  // namespace

extern "C" {

// Decode+resize+crop `n` images in parallel into out[n, S, S, 3] (-1..1).
// crop_x/crop_y: -1 -> center crop; otherwise top-left of the crop window
// (same for all frames — video clips crop consistently). Returns the number
// of successfully loaded images (== n on full success).
int il_load_batch(const char** paths, int n, int image_size, int crop_x,
                  int crop_y, int num_threads, float* out) {
  if (n <= 0) return 0;
  std::atomic<int> next(0), ok(0);
  int workers = std::max(1, std::min(num_threads, n));
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + size_t(i) * image_size * image_size * 3;
      if (load_one(paths[i], image_size, crop_x, crop_y, dst)) ok.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return ok.load();
}

// Probe an image's dimensions without full decode path (decodes header-cheap).
int il_image_size(const char* path, int* w, int* h) {
  Image img;
  if (!decode_file(path, &img)) return 0;
  *w = img.w;
  *h = img.h;
  return 1;
}

}  // extern "C"
