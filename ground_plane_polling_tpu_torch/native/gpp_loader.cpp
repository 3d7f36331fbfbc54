// Native threaded image loader for the port's training and evaluation
// pipeline (a copy of the JAX package's native/gpp_loader.cpp: the same
// code, built with the same flags, gives the same pixels): PNG/JPEG decode
// (libpng / libjpeg), BGR conversion, bilinear resize, zero-padding into a
// fixed (H, W) canvas, and a std::thread fan-out over the batch, all off
// the Python GIL.
//
// Exposed as a plain C ABI consumed through ctypes
// (ground_plane_polling_tpu_torch/data/native_loader.py), which builds it
// at first use into _build/ with
//   g++ -O3 -shared -fPIC -std=c++17 gpp_loader.cpp -lpng -ljpeg -pthread

#include <png.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cctype>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Image {
  std::vector<unsigned char> bgr;  // H*W*3, BGR
  int h = 0;
  int w = 0;
};

bool decode_png(const char* path, Image* out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_BGR;
  out->h = static_cast<int>(image.height);
  out->w = static_cast<int>(image.width);
  out->bgr.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->bgr.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

// libjpeg's default error_exit calls exit(): a corrupt .jpg would kill
// the whole training/serving process from a worker thread. Standard
// setjmp/longjmp error manager turns any libjpeg error into `return
// false` (the decode-failure contract of gpp_load_batch).
struct JpegErrorJmp {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_longjmp(j_common_ptr cinfo) {
  JpegErrorJmp* err = reinterpret_cast<JpegErrorJmp*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorJmp jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_longjmp;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->bgr.resize(static_cast<size_t>(out->h) * out->w * 3);
  std::vector<unsigned char> row(static_cast<size_t>(out->w) * 3);
  unsigned char* rowp = row.data();
  for (int y = 0; y < out->h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    unsigned char* dst = out->bgr.data() + static_cast<size_t>(y) * out->w * 3;
    for (int x = 0; x < out->w; ++x) {  // RGB -> BGR
      dst[3 * x + 0] = row[3 * x + 2];
      dst[3 * x + 1] = row[3 * x + 1];
      dst[3 * x + 2] = row[3 * x + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

bool decode_image(const char* path, Image* out) {
  // route by extension, case-insensitively (.JPEG/.Jpg/.PNG are common)
  const char* dot = std::strrchr(path, '.');
  if (dot) {
    std::string ext(dot + 1);
    for (char& c : ext) c = static_cast<char>(std::tolower(c));
    if (ext == "jpg" || ext == "jpeg") return decode_jpeg(path, out);
  }
  return decode_png(path, out);
}

// Bilinear resize of BGR uint8 -> float32, written into a zero-padded
// (out_h, out_w, 3) canvas at the top-left. Sample positions use the
// align-corners=false convention ((x + 0.5) / scale - 0.5, clamped).
void resize_into(const Image& src, double scale, float* out, int out_h,
                 int out_w) {
  int dst_h = static_cast<int>(src.h * scale + 0.5);
  int dst_w = static_cast<int>(src.w * scale + 0.5);
  if (dst_h > out_h) dst_h = out_h;
  if (dst_w > out_w) dst_w = out_w;
  const double inv = 1.0 / scale;
  for (int y = 0; y < dst_h; ++y) {
    double sy = (y + 0.5) * inv - 0.5;
    if (sy < 0) sy = 0;
    int y0 = static_cast<int>(sy);
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    const float fy = static_cast<float>(sy - y0);
    float* dst_row = out + (static_cast<size_t>(y) * out_w) * 3;
    const unsigned char* r0 = src.bgr.data() + static_cast<size_t>(y0) * src.w * 3;
    const unsigned char* r1 = src.bgr.data() + static_cast<size_t>(y1) * src.w * 3;
    for (int x = 0; x < dst_w; ++x) {
      double sx = (x + 0.5) * inv - 0.5;
      if (sx < 0) sx = 0;
      int x0 = static_cast<int>(sx);
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      const float fx = static_cast<float>(sx - x0);
      for (int c = 0; c < 3; ++c) {
        const float top = r0[3 * x0 + c] * (1.f - fx) + r0[3 * x1 + c] * fx;
        const float bot = r1[3 * x0 + c] * (1.f - fx) + r1[3 * x1 + c] * fx;
        dst_row[3 * x + c] = top * (1.f - fy) + bot * fy;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode + resize one image into a zero-initialized float32 canvas.
// Returns 0 on success. src_h/src_w report the pre-resize image size.
int gpp_load_image(const char* path, float* out, int out_h, int out_w,
                   double scale, int* src_h, int* src_w) {
  Image img;
  if (!decode_image(path, &img)) return 1;
  if (src_h) *src_h = img.h;
  if (src_w) *src_w = img.w;
  std::memset(out, 0, static_cast<size_t>(out_h) * out_w * 3 * sizeof(float));
  resize_into(img, scale, out, out_h, out_w);
  return 0;
}

// Threaded batch load: paths[i] -> out[i * out_h * out_w * 3].
// scales[i] gives the per-image resize factor. Returns the number of
// images that FAILED to decode (0 == all good).
int gpp_load_batch(const char** paths, int n, float* out, int out_h,
                   int out_w, const double* scales, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int> failures(n_threads, 0);
  std::vector<std::thread> workers;
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([=, &failures]() {
      for (int i = t; i < n; i += n_threads) {
        if (gpp_load_image(paths[i], out + stride * i, out_h, out_w,
                           scales[i], nullptr, nullptr) != 0) {
          failures[t]++;
        }
      }
    });
  }
  int total = 0;
  for (int t = 0; t < n_threads; ++t) {
    workers[t].join();
    total += failures[t];
  }
  return total;
}

// Probe an image's dimensions without a full decode (PNG: header only).
int gpp_image_size(const char* path, int* h, int* w) {
  Image img;  // full decode fallback; PNG header fast-path below
  const char* dot = std::strrchr(path, '.');
  if (!dot || std::strcmp(dot, ".png") == 0) {
    png_image image;
    std::memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (png_image_begin_read_from_file(&image, path)) {
      *h = static_cast<int>(image.height);
      *w = static_cast<int>(image.width);
      png_image_free(&image);
      return 0;
    }
    return 1;
  }
  if (!decode_image(path, &img)) return 1;
  *h = img.h;
  *w = img.w;
  return 0;
}

}  // extern "C"
