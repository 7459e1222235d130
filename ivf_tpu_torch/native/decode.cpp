// ivf_native — batched parallel JPEG decode for the clip loader (copy of
// ivf_tpu/native/decode.cpp; the host side of the data path, not a device
// kernel).
//
// The reference decodes frames one-by-one through PIL / tf.map_fn
// (data_loader_jpg.py:28-31, train_kth.py:75-80). Feeding a device the
// full smth-smth validation set (24k clips x 16 frames) makes host JPEG
// decode the wall-clock bottleneck, so the hot path is native: libjpeg
// decode fanned out over a std::thread pool, writing straight into one
// caller-provided (n, h, w, 3) buffer — no per-image Python objects, GIL
// released for the whole batch.
//
// C ABI (ctypes-friendly):
//   ivf_decode_batch(ptrs, lens, n, out, h, w, n_threads) -> 0 on success,
//     else the 1-based index of the first image that failed or whose
//     dimensions mismatched.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG into out (h*w*3, RGB). Returns true on success.
bool decode_one(const uint8_t* data, size_t len, uint8_t* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + stride * cinfo.output_scanline;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

int ivf_decode_batch(const uint8_t** ptrs, const size_t* lens, int n,
                     uint8_t* out, int h, int w, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  const size_t img_bytes = static_cast<size_t>(h) * w * 3;
  std::atomic<int> next(0);
  std::atomic<int> first_fail(0);  // 0 = none

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (!decode_one(ptrs[i], lens[i], out + img_bytes * i, h, w)) {
        int expected = 0;
        first_fail.compare_exchange_strong(expected, i + 1);
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return first_fail.load();
}

// Probe a JPEG's dimensions without a full decode.
int ivf_jpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
