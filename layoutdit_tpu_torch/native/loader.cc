// Native host-side page loader: JPEG decode, and decode + fixed-size
// bilinear resize + CHW float conversion, with an internal thread pool
// (port of layoutdit_tpu/native/loader.cc, the same decode_resize
// semantics and bits).
//
// Decoding and resizing happen in C++ threads (no GIL). The resize uses
// the torch align_corners=False bilinear formula, as the device-side
// resize does (ops/interpolate.py):
//   src = max(0, (dst + 0.5) * in/out - 0.5)
//
// Beside the JAX loader's ld_decode_resize_batch, the port's serving
// engine uses two entries of its own: ld_jpeg_dims reads a JPEG's header
// (its size, for routing a page to a bucket) and ld_decode_batch decodes
// a batch of JPEGs into caller-given uint8 HWC buffers, which the engine
// uploads and resizes on the device.
//
// Exposed as a C ABI for ctypes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG bytes to RGB8 HWC. Returns false on corrupt input.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* height, int* width) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *height = cinfo.output_height;
  *width = cinfo.output_width;
  rgb->resize(static_cast<size_t>(*height) * *width * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
                   static_cast<size_t>(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Decode JPEG bytes to RGB8 HWC into out (cap bytes). Returns false on
// corrupt input or when the image does not fit in cap bytes.
bool decode_jpeg_into(const uint8_t* data, size_t len, uint8_t* out,
                      size_t cap, int* height, int* width) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const size_t row_bytes = static_cast<size_t>(cinfo.output_width) * 3;
  if (row_bytes * cinfo.output_height > cap) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  *height = cinfo.output_height;
  *width = cinfo.output_width;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Run work(i) for i in [0, n) on n_threads threads (inline for <= 1).
template <typename Work>
void parallel_for(int n, int n_threads, Work work) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      work(i);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
}

// 1-D interp taps with torch align_corners=False semantics.
void interp_taps(int in_size, int out_size, std::vector<int>* lo,
                 std::vector<int>* hi, std::vector<float>* frac) {
  lo->resize(out_size);
  hi->resize(out_size);
  frac->resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  for (int d = 0; d < out_size; ++d) {
    double src = (d + 0.5) * scale - 0.5;
    if (src < 0) src = 0;
    int l = static_cast<int>(src);
    if (l > in_size - 1) l = in_size - 1;
    int h = l + 1 < in_size ? l + 1 : in_size - 1;
    (*lo)[d] = l;
    (*hi)[d] = h;
    (*frac)[d] = static_cast<float>(src - l);
  }
}

// RGB8 HWC [h, w] -> float CHW [3, s, s] in [0, 1], bilinear.
void resize_normalize(const uint8_t* rgb, int h, int w, int s, float* out) {
  std::vector<int> ylo, yhi, xlo, xhi;
  std::vector<float> yf, xf;
  interp_taps(h, s, &ylo, &yhi, &yf);
  interp_taps(w, s, &xlo, &xhi, &xf);

  // horizontal pass into [h, s, 3]
  std::vector<float> tmp(static_cast<size_t>(h) * s * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * s * 3;
    for (int x = 0; x < s; ++x) {
      const uint8_t* a = row + xlo[x] * 3;
      const uint8_t* b = row + xhi[x] * 3;
      const float f = xf[x];
      for (int c = 0; c < 3; ++c) {
        trow[x * 3 + c] = (1.0f - f) * a[c] + f * b[c];
      }
    }
  }
  // vertical pass + CHW + /255
  const float inv = 1.0f / 255.0f;
  for (int y = 0; y < s; ++y) {
    const float* a = tmp.data() + static_cast<size_t>(ylo[y]) * s * 3;
    const float* b = tmp.data() + static_cast<size_t>(yhi[y]) * s * 3;
    const float f = yf[y];
    for (int x = 0; x < s; ++x) {
      for (int c = 0; c < 3; ++c) {
        out[(static_cast<size_t>(c) * s + y) * s + x] =
            ((1.0f - f) * a[x * 3 + c] + f * b[x * 3 + c]) * inv;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode+resize one image. Returns 0 on success, nonzero on decode error.
int ld_decode_resize(const uint8_t* jpeg, long len, int out_size, float* out,
                     float* orig_hw) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg(jpeg, static_cast<size_t>(len), &rgb, &h, &w)) return 1;
  orig_hw[0] = static_cast<float>(h);
  orig_hw[1] = static_cast<float>(w);
  resize_normalize(rgb.data(), h, w, out_size, out);
  return 0;
}

// Batched, thread-pooled variant. bufs: n pointers; lens: n lengths;
// out: [n, 3, out_size, out_size]; orig_hw: [n, 2]. Returns number of
// decode failures. Failed slots are zero-filled and marked with
// orig_hw = (0, 0) (impossible for a real decode, where height/width
// are always >= 1) so callers can invalidate those slots per-example.
int ld_decode_resize_batch(const uint8_t** bufs, const long* lens, int n,
                           int out_size, float* out, float* orig_hw,
                           int n_threads) {
  std::atomic<int> failures(0);
  const size_t img_elems = 3UL * out_size * out_size;
  parallel_for(n, n_threads, [&](int i) {
    float* dst = out + i * img_elems;
    if (ld_decode_resize(bufs[i], lens[i], out_size, dst, orig_hw + 2 * i) !=
        0) {
      std::memset(dst, 0, img_elems * sizeof(float));
      orig_hw[2 * i] = 0.0f;
      orig_hw[2 * i + 1] = 0.0f;
      failures.fetch_add(1);
    }
  });
  return failures.load();
}

// A JPEG's size from its header alone (no pixel decode). Returns 0 and
// sets *height, *width, or nonzero for input that is not a readable
// JPEG header.
int ld_jpeg_dims(const uint8_t* jpeg, long len, int* height, int* width) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, static_cast<size_t>(len));
  jpeg_read_header(&cinfo, TRUE);
  *height = cinfo.image_height;
  *width = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Batched, thread-pooled decode without resize. bufs: n pointers; lens:
// n lengths; outs: n caller buffers of caps[i] bytes, each filled with
// the page as RGB8 HWC; hw: [n, 2] (h, w) out. Returns the number of
// failures: a page that does not decode, or does not fit its buffer,
// gets hw = (0, 0) (impossible for a real decode), and what its buffer
// holds is undefined.
int ld_decode_batch(const uint8_t** bufs, const long* lens, int n,
                    uint8_t** outs, const long* caps, int* hw,
                    int n_threads) {
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    int h = 0, w = 0;
    if (!decode_jpeg_into(bufs[i], static_cast<size_t>(lens[i]), outs[i],
                          static_cast<size_t>(caps[i]), &h, &w)) {
      h = w = 0;
      failures.fetch_add(1);
    }
    hw[2 * i] = h;
    hw[2 * i + 1] = w;
  });
  return failures.load();
}

}  // extern "C"
