// JPEG decode and encode on the card with nvJPEG (CUDA toolkit). The card
// route of the data path, for machines whose host has no libjpeg: images are
// decoded into device memory on the caller's stream, then copied to the
// host for the resizes. It holds a CUDA context, so it runs in the process
// that owns the card, never in a forked loader worker.
//
// nvJPEG's chroma upsampling is not libjpeg's, so a decode does not equal
// Pillow's bit for bit; it is held against the source pixels of the images
// it encodes (tests/test_torch_cuda.py). Built with the host
// compiler at first use, linked with -lnvjpeg -lcudart.

#include <cstdint>
#include <cstdlib>
#include <new>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
};

}  // namespace

extern "C" {

// A decoder and encoder for `stream`; *status is 0 or the failing nvJPEG status.
void* tp_nvjpeg_create(void* stream, int* status) {
  Context* ctx = new (std::nothrow) Context();
  if (ctx == nullptr) {
    *status = -1;
    return nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t st = nvjpegCreateSimple(&ctx->handle);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(ctx->handle, &ctx->state);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncoderStateCreate(ctx->handle, &ctx->enc_state, s);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncoderParamsCreate(ctx->handle, &ctx->enc_params, s);
  *status = static_cast<int>(st);
  return ctx;
}

void tp_nvjpeg_destroy(void* p) {
  Context* ctx = static_cast<Context*>(p);
  if (ctx == nullptr) return;
  if (ctx->enc_params) nvjpegEncoderParamsDestroy(ctx->enc_params);
  if (ctx->enc_state) nvjpegEncoderStateDestroy(ctx->enc_state);
  if (ctx->state) nvjpegJpegStateDestroy(ctx->state);
  if (ctx->handle) nvjpegDestroy(ctx->handle);
  delete ctx;
}

// Decode n JPEGs (concatenated in host `data` at `offsets`, `sizes` bytes
// each) into device out[n, h, w, 3] u8 (interleaved RGB) on `stream`.
// Returns 0, or 1 + the index of the first image that failed (not a JPEG,
// another shape, or an nvJPEG error).
int tp_nvjpeg_decode_batch(void* p, const uint8_t* data, const int64_t* offsets, const int64_t* sizes, int n,
                           uint8_t* out, int h, int w, void* stream) {
  Context* ctx = static_cast<Context*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const unsigned char* src = data + offsets[i];
    const size_t size = static_cast<size_t>(sizes[i]);
    int components = 0;
    nvjpegChromaSubsampling_t subsampling;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    if (nvjpegGetImageInfo(ctx->handle, src, size, &components, &subsampling, widths, heights) !=
            NVJPEG_STATUS_SUCCESS ||
        widths[0] != w || heights[0] != h) {
      return i + 1;
    }
    nvjpegImage_t dst = {};
    dst.channel[0] = out + static_cast<size_t>(i) * h * w * 3;
    dst.pitch[0] = static_cast<size_t>(w) * 3;
    if (nvjpegDecode(ctx->handle, ctx->state, src, size, NVJPEG_OUTPUT_RGBI, &dst, s) != NVJPEG_STATUS_SUCCESS) {
      return i + 1;
    }
  }
  return 0;
}

// Encode one device (h, w, 3) u8 RGB image at `quality`, 4:2:0, into the
// host buffer `out` of *size bytes. Returns 0 and sets *size to the stream's
// length; returns -2 and sets *size to the length needed if `out` is too
// small; else the failing nvJPEG or CUDA status. Synchronises `stream`.
int tp_nvjpeg_encode(void* p, const uint8_t* image, int h, int w, int quality, uint8_t* out, size_t* size,
                     void* stream) {
  Context* ctx = static_cast<Context*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t st = nvjpegEncoderParamsSetQuality(ctx->enc_params, quality, s);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncoderParamsSetSamplingFactors(ctx->enc_params, NVJPEG_CSS_420, s);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncoderParamsSetOptimizedHuffman(ctx->enc_params, 0, s);
  nvjpegImage_t src = {};
  src.channel[0] = const_cast<uint8_t*>(image);
  src.pitch[0] = static_cast<size_t>(w) * 3;
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncodeImage(ctx->handle, ctx->enc_state, ctx->enc_params, &src, NVJPEG_INPUT_RGBI, w, h, s);
  size_t length = 0;
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, nullptr, &length, s);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  cudaError_t err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return 1000 + static_cast<int>(err);
  if (length > *size) {
    *size = length;
    return -2;
  }
  st = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, out, &length, s);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return 1000 + static_cast<int>(err);
  *size = length;
  return 0;
}

}  // extern "C"
