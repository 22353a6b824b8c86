// JPEG decode and encode on the host with libjpeg, the decode threaded over
// a batch. The host route of the data path: it runs in forked loader
// workers, and its decode equals Pillow's (which links the same libjpeg
// API) bit for bit.
//
// Counterpart of the decoder in transplat_tpu/native/dataloader.cpp. The
// decode is stricter: a stream that libjpeg decodes only with a warning
// (truncated or corrupt data) counts as a failure, as Pillow raises on it.
// Built with the host compiler at first use, linked with -ljpeg.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "parallel.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void quiet(j_common_ptr) {}  // warnings are counted (num_warnings), not printed

// Decode one JPEG into interleaved RGB of shape (out_h, out_w). 0 on success.
int decode_one(const uint8_t* data, size_t size, uint8_t* out, int out_h, int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  if (h != out_h || w != out_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rows[1] = {out + static_cast<size_t>(cinfo.output_scanline) * w * 3};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  const long warnings = jerr.pub.num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings > 0 ? 4 : 0;
}

}  // namespace

extern "C" {

// Decode n JPEGs (concatenated in `data` at `offsets`, `sizes` bytes each)
// into out[n, h, w, 3] u8. Returns 0, or 1 + the index of the first image
// that failed (not a JPEG, another shape, or a corrupt stream).
int tp_jpeg_decode_batch(const uint8_t* data, const int64_t* offsets, const int64_t* sizes, int n, uint8_t* out, int h,
                         int w, int num_threads) {
  std::atomic<int> first_failure{n};
  tp::parallel_for(n, num_threads, [&](int i) {
    uint8_t* dst = out + static_cast<size_t>(i) * h * w * 3;
    if (decode_one(data + offsets[i], static_cast<size_t>(sizes[i]), dst, h, w) != 0) {
      int cur = first_failure.load();
      while (i < cur && !first_failure.compare_exchange_weak(cur, i)) {
      }
    }
  });
  const int f = first_failure.load();
  return f == n ? 0 : f + 1;
}

// Encode one (h, w, 3) u8 RGB image at `quality` (4:2:0, libjpeg's
// defaults). On success returns 0 and sets *out (free with tp_jpeg_free) and
// *out_size.
int tp_jpeg_encode(const uint8_t* image, int h, int w, int quality, unsigned char** out, unsigned long* out_size) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = quiet;
  *out = nullptr;
  *out_size = 0;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::free(*out);
    *out = nullptr;
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, out, out_size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row[1] = {const_cast<uint8_t*>(image) + static_cast<size_t>(cinfo.next_scanline) * w * 3};
    jpeg_write_scanlines(&cinfo, row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

void tp_jpeg_free(unsigned char* p) { std::free(p); }

}  // extern "C"
