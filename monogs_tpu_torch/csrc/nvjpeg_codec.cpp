// JPEG decode into, and encode from, device memory with nvJPEG (part of
// the CUDA toolkit), for the Replica loader's colour frames and for the
// fixtures written on the card.
//
// Replaces cv2.imread / cv2.imwrite of JPEG files in the JAX package
// (monogs_tpu/data/datasets.py, native/frame_loader.cpp's libjpeg path); a
// library call, as cv2.imread is in the reference. Decoding is nvJPEG's
// hybrid path: Huffman on the host, the inverse DCT on the card, straight
// into the caller's device planes at the stream's own subsampling; the
// chroma upsampling and colour conversion are libjpeg's, in the kernel
// csrc/ycc_rgb.cu (nvJPEG's own differ from libjpeg's by up to 12 LSB on
// the mean on sharp 4:2:0 chroma).
//
// One handle, one decoder state and one encoder state serve every call,
// under a mutex. Each call runs on the library's own stream after waiting
// for the caller's stream (the buffers may be in use there), and returns
// once its work is done: the decoded buffer is ready, and the state's
// pinned staging memory is free for the next call.

#include <cstddef>
#include <cstring>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

std::mutex mu;
nvjpegHandle_t handle = nullptr;
nvjpegJpegState_t dec_state = nullptr;
nvjpegEncoderState_t enc_state = nullptr;
nvjpegEncoderParams_t enc_params = nullptr;
cudaStream_t own = nullptr;
cudaEvent_t ready = nullptr;

constexpr int CUDA_ERR = 1000;   // + cudaError_t
constexpr int NVJPEG_ERR = 2000;  // + nvjpegStatus_t

int init() {
  if (handle) return 0;
  cudaError_t ce = cudaStreamCreateWithFlags(&own, cudaStreamNonBlocking);
  if (ce != cudaSuccess) return CUDA_ERR + ce;
  ce = cudaEventCreateWithFlags(&ready, cudaEventDisableTiming);
  if (ce != cudaSuccess) return CUDA_ERR + ce;
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t st = nvjpegCreateSimple(&h);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(h, &dec_state);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderStateCreate(h, &enc_state, own);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsCreate(h, &enc_params, own);
  if (st != NVJPEG_STATUS_SUCCESS) return NVJPEG_ERR + st;
  handle = h;
  return 0;
}

// the library's stream waits for the work queued so far on ``caller``
int follow(cudaStream_t caller) {
  cudaError_t ce = cudaEventRecord(ready, caller);
  if (ce == cudaSuccess) ce = cudaStreamWaitEvent(own, ready, 0);
  return ce == cudaSuccess ? 0 : CUDA_ERR + ce;
}

int finish() {
  const cudaError_t ce = cudaStreamSynchronize(own);
  return ce == cudaSuccess ? 0 : CUDA_ERR + ce;
}

}  // namespace

extern "C" {

// Per-component widths and heights (3 each) and component count of a JPEG
// stream.
int jpeg_info(const unsigned char* data, size_t len, int* widths,
              int* heights, int* components) {
  std::lock_guard<std::mutex> guard(mu);
  int rc = init();
  if (rc) return rc;
  int n = 0;
  nvjpegChromaSubsampling_t ss;
  int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
  const nvjpegStatus_t st =
      nvjpegGetImageInfo(handle, data, len, &n, &ss, w, h);
  if (st != NVJPEG_STATUS_SUCCESS) return NVJPEG_ERR + st;
  for (int i = 0; i < 3; ++i) {
    widths[i] = i < n ? w[i] : 0;
    heights[i] = i < n ? h[i] : 0;
  }
  *components = n;
  return 0;
}

// Decode into the planes y [heights[0], widths[0]] and, for a colour
// stream, cb and cr at their subsampled sizes (jpeg_info's), each
// contiguous uint8 on the device; cb and cr null for a grey stream.
int jpeg_decode(const unsigned char* data, size_t len, unsigned char* y,
                unsigned char* cb, unsigned char* cr, const int* widths,
                cudaStream_t caller) {
  std::lock_guard<std::mutex> guard(mu);
  int rc = init();
  if (!rc) rc = follow(caller);
  if (rc) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof img);
  unsigned char* planes[3] = {y, cb, cr};
  for (int i = 0; i < 3; ++i) {
    img.channel[i] = planes[i];
    img.pitch[i] = planes[i] ? (size_t)widths[i] : 0;
  }
  const nvjpegStatus_t st = nvjpegDecode(
      handle, dec_state, data, len,
      cb ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img, own);
  if (st != NVJPEG_STATUS_SUCCESS) return NVJPEG_ERR + st;
  return finish();
}

// Encode src [height, width, 3] uint8 interleaved RGB on the device as a
// baseline JPEG (4:2:0) of ``quality`` into out (``cap`` bytes); *len gets
// the stream's length. Returns 3 if cap is too small (nothing written).
int jpeg_encode(const unsigned char* src, int width, int height, int quality,
                unsigned char* out, size_t cap, size_t* len,
                cudaStream_t caller) {
  std::lock_guard<std::mutex> guard(mu);
  int rc = init();
  if (!rc) rc = follow(caller);
  if (rc) return rc;
  nvjpegStatus_t st = nvjpegEncoderParamsSetQuality(enc_params, quality, own);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetSamplingFactors(enc_params, NVJPEG_CSS_420,
                                               own);
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof img);
  img.channel[0] = const_cast<unsigned char*>(src);
  img.pitch[0] = (size_t)width * 3;
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncodeImage(handle, enc_state, enc_params, &img,
                           NVJPEG_INPUT_RGBI, width, height, own);
  size_t n = 0;
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncodeRetrieveBitstream(handle, enc_state, nullptr, &n, own);
  if (st != NVJPEG_STATUS_SUCCESS) return NVJPEG_ERR + st;
  if ((rc = finish())) return rc;
  *len = n;
  if (n > cap) return 3;
  st = nvjpegEncodeRetrieveBitstream(handle, enc_state, out, &n, own);
  if (st != NVJPEG_STATUS_SUCCESS) return NVJPEG_ERR + st;
  *len = n;
  return finish();
}

}  // extern "C"
