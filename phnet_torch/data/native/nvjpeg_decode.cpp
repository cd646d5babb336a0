// JPEG decode on the card with nvJPEG, for the port's dataset readers.
//
// The card's machine has the CUDA toolkit's nvJPEG and no libjpeg, so the
// readers decode there with this library (phnet_torch/data/native_loader.py
// loads it with ctypes; phnet_torch/ops/_build.py builds it with g++ against
// the toolkit's nvjpeg.h and libnvjpeg). Each frame's component planes (Y,
// Cb, Cr at the file's own sampling, after nvJPEG's IDCT) are written
// straight into device memory that the caller allocated (torch tensors),
// on the caller's stream; the chroma upsampling and YCbCr -> RGB
// conversion follow in PyTorch on the card with libjpeg's arithmetic
// (native_loader.ycc_to_rgb: nvJPEG's own RGB output upsamples chroma
// otherwise than libjpeg does), then the crop, the resize in cv2's
// bilinear geometry and the normalization (native_loader.resize_normalize).
// It replaces no TPU kernel: the JAX package decodes on the host
// (phnet_tpu/data/native/clip_loader.cpp).
// Bound: the Huffman decode runs on the host (nvJPEG's default backend),
// the IDCT on the card.
//
// The encoder entries (nvj_encoder_*) write the VIL-100 flow planes
// (phnet_torch/data/flow.py::generate_flow_jpgs) on the card: a gray plane
// in device memory to a baseline one-component JPEG at the given quality
// (cv2.imwrite's 95 for the flow planes), nvJPEG's DCT and quantization
// on the card, the Huffman coding on the host.
//
// Every function returns 0 on success, else the nvjpegStatus_t.

#include <cstddef>

#include <nvjpeg.h>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

struct Encoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

void release(Encoder* e) {
  if (e->params) nvjpegEncoderParamsDestroy(e->params);
  if (e->state) nvjpegEncoderStateDestroy(e->state);
  if (e->handle) nvjpegDestroy(e->handle);
  delete e;
}

}  // namespace

extern "C" {

int nvj_create(void** out) {
  Decoder* d = new Decoder;
  nvjpegStatus_t st = nvjpegCreateSimple(&d->handle);
  if (st != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return static_cast<int>(st);
  }
  st = nvjpegJpegStateCreate(d->handle, &d->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(d->handle);
    delete d;
    return static_cast<int>(st);
  }
  *out = d;
  return 0;
}

void nvj_destroy(void* p) {
  Decoder* d = static_cast<Decoder*>(p);
  if (d == nullptr) return;
  nvjpegJpegStateDestroy(d->state);
  nvjpegDestroy(d->handle);
  delete d;
}

// The component count of the image in data[0:len) and each component's
// plane height and width (heights, widths: NVJPEG_MAX_COMPONENT ints).
int nvj_image_info(void* p, const unsigned char* data, size_t len,
                   int* n_components, int* heights, int* widths) {
  Decoder* d = static_cast<Decoder*>(p);
  nvjpegChromaSubsampling_t subsampling;
  return static_cast<int>(nvjpegGetImageInfo(d->handle, data, len,
                                             n_components, &subsampling,
                                             widths, heights));
}

// Decode data[0:len) to its component planes: Y alone for one component,
// else Y, Cb, Cr at the file's sampling, each at planes[c] (device memory,
// rows of pitches[c] bytes), on `stream` (a cudaStream_t).
int nvj_decode_planes(void* p, const unsigned char* data, size_t len,
                      int n_planes, unsigned char** planes,
                      const int* pitches, void* stream) {
  Decoder* d = static_cast<Decoder*>(p);
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = c < n_planes ? planes[c] : nullptr;
    img.pitch[c] = c < n_planes ? static_cast<size_t>(pitches[c]) : 0;
  }
  return static_cast<int>(nvjpegDecode(
      d->handle, d->state, data, len,
      n_planes == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img,
      static_cast<cudaStream_t>(stream)));
}

// An encoder of gray JPEGs at `quality` (baseline, standard Huffman
// tables), its state made on `stream`.
int nvj_encoder_create(int quality, void* stream, void** out) {
  Encoder* e = new Encoder;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t st = nvjpegCreateSimple(&e->handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderStateCreate(e->handle, &e->state, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsCreate(e->handle, &e->params, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetQuality(e->params, quality, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetSamplingFactors(e->params, NVJPEG_CSS_GRAY, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetOptimizedHuffman(e->params, 0, s);
  if (st != NVJPEG_STATUS_SUCCESS) {
    release(e);
    return static_cast<int>(st);
  }
  *out = e;
  return 0;
}

void nvj_encoder_destroy(void* p) {
  if (p != nullptr) release(static_cast<Encoder*>(p));
}

// Encode the gray plane at `plane` (device memory, h rows of `pitch`
// bytes, w wide) on `stream`; *len receives the JPEG's byte count. The
// caller synchronizes the stream, then fetches the bytes with
// nvj_encoder_fetch.
int nvj_encoder_encode(void* p, const unsigned char* plane, int pitch, int w,
                       int h, void* stream, size_t* len) {
  Encoder* e = static_cast<Encoder*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = const_cast<unsigned char*>(plane);
  img.pitch[0] = static_cast<size_t>(pitch);
  nvjpegStatus_t st = nvjpegEncodeYUV(e->handle, e->state, e->params, &img,
                                      NVJPEG_CSS_GRAY, w, h, s);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  return static_cast<int>(
      nvjpegEncodeRetrieveBitstream(e->handle, e->state, nullptr, len, s));
}

// The last encoded JPEG's bytes into out[0:*len) (*len its size, from
// nvj_encoder_encode).
int nvj_encoder_fetch(void* p, unsigned char* out, size_t* len) {
  Encoder* e = static_cast<Encoder*>(p);
  return static_cast<int>(
      nvjpegEncodeRetrieveBitstream(e->handle, e->state, out, len, nullptr));
}

}  // extern "C"
