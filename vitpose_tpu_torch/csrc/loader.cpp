// Native data-loader core: multi-threaded JPEG decode + canvas paste.
//
// The PyTorch port's own copy of csrc/loader.cpp (the port loads no binary of
// the JAX package). vitpose_tpu_torch/kernels/_build.py compiles it with g++
// and -ljpeg at first use, and vitpose_tpu_torch/data/native.py binds it with
// ctypes. A C++ thread pool decodes inside the host process (no fork, no
// GIL) straight into the loader's static uint8 canvases.
//
// C API (ctypes-friendly):
//   vtp_decode_batch(paths, n, canvas, canvas_size, scales, widths, heights,
//                    n_threads)
//     paths:   array of n C strings (JPEG files)
//     canvas:  n * canvas_size * canvas_size * 3 uint8, zero-filled here
//     scales:  out, n floats — downscale factor applied (<=1.0)
//     widths/heights: out, n ints — post-scale image size on the canvas
//   returns 0 on success, else the (1-based) index of the first failed file.
//
// Decode uses libjpeg DCT scaling (scale_num/8) to land near the canvas
// size cheaply, then a small bilinear resample to the exact target.
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode one JPEG into an RGB buffer, using DCT scaling to get the smallest
// decode whose max side is still >= max_side (or the full image if smaller).
bool decode_jpeg(const char* path, std::vector<uint8_t>& rgb, int* w, int* h,
                 int* full_w, int* full_h, int max_side) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  *full_w = static_cast<int>(cinfo.image_width);
  *full_h = static_cast<int>(cinfo.image_height);
  const int full = *full_w > *full_h ? *full_w : *full_h;
  int num = 8;
  if (max_side > 0 && full > max_side) {
    // largest num/8 scale still covering max_side
    for (num = 8; num > 1; --num) {
      if ((full * (num - 1)) / 8 < max_side) break;
    }
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = *w * cinfo.output_components;
  rgb.resize(static_cast<size_t>(stride) * *h);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) *
                                    stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  if (cinfo.output_components != 3) {
    // expand grayscale to RGB in place
    if (cinfo.output_components == 1) {
      std::vector<uint8_t> gray = rgb;
      rgb.resize(static_cast<size_t>(*w) * *h * 3);
      for (size_t i = 0; i < gray.size(); ++i) {
        rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = gray[i];
      }
    } else {
      return false;
    }
  }
  return true;
}

// Bilinear resample rgb [h, w] -> out [oh, ow] (both 3-channel, rows tight).
void resize_bilinear(const uint8_t* src, int w, int h, uint8_t* dst, int ow,
                     int oh) {
  const float sx = static_cast<float>(w) / ow;
  const float sy = static_cast<float>(h) / oh;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 >= h) y1 = h - 1;
    if (y0 >= h) y0 = h - 1;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 >= w) x1 = w - 1;
      if (x0 >= w) x0 = w - 1;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(static_cast<size_t>(y0) * w + x0) * 3 + c];
        const float v01 = src[(static_cast<size_t>(y0) * w + x1) * 3 + c];
        const float v10 = src[(static_cast<size_t>(y1) * w + x0) * 3 + c];
        const float v11 = src[(static_cast<size_t>(y1) * w + x1) * 3 + c];
        const float top = v00 * (1 - wx) + v01 * wx;
        const float bot = v10 * (1 - wx) + v11 * wx;
        dst[(static_cast<size_t>(y) * ow + x) * 3 + c] =
            static_cast<uint8_t>(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

int vtp_decode_batch(const char** paths, int n, uint8_t* canvas,
                     int canvas_size, float* scales, int* widths,
                     int* heights, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const size_t canvas_stride =
      static_cast<size_t>(canvas_size) * canvas_size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    std::vector<uint8_t> resized;
    int i;
    while ((i = next.fetch_add(1)) < n) {
      int w = 0, h = 0, full_w = 0, full_h = 0;
      if (!decode_jpeg(paths[i], rgb, &w, &h, &full_w, &full_h,
                       canvas_size)) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        continue;
      }
      uint8_t* out = canvas + canvas_stride * i;
      std::memset(out, 0, canvas_stride);
      // final scale so the max side fits the canvas
      float s = 1.0f;
      int ow = w, oh = h;
      const int mx = w > h ? w : h;
      if (mx > canvas_size) {
        s = static_cast<float>(canvas_size) / mx;
        ow = static_cast<int>(std::lround(w * s));
        oh = static_cast<int>(std::lround(h * s));
      }
      const uint8_t* src = rgb.data();
      if (ow != w || oh != h) {
        resized.resize(static_cast<size_t>(ow) * oh * 3);
        resize_bilinear(rgb.data(), w, h, resized.data(), ow, oh);
        src = resized.data();
      }
      for (int y = 0; y < oh; ++y) {
        std::memcpy(out + (static_cast<size_t>(y) * canvas_size) * 3,
                    src + static_cast<size_t>(y) * ow * 3,
                    static_cast<size_t>(ow) * 3);
      }
      // total scale from ORIGINAL image coords (annotations live there):
      // DCT prescale w/full_w times the bilinear fit s.
      scales[i] = s * static_cast<float>(w) / full_w;
      widths[i] = ow;
      heights[i] = oh;
    }
  };

  std::vector<std::thread> threads;
  const int nt = n_threads > 0 ? n_threads : 1;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

}  // extern "C"
