// Clip decoder of the PyTorch port: JPEG decode -> top crop -> bilinear
// resize -> ImageNet normalize, OpenMP-parallel over the frames of a clip.
//
// Own copy of decode_clip_rgb in phnet_tpu/data/native/clip_loader.cpp
// (the evaluation readers' path; the space-to-depth and grayscale entries
// of that file are not copied). One C call turns a clip's JPEG files into
// the float32 NHWC tensor the model takes, without Python in the
// per-frame loop; loaded with ctypes (phnet_torch/data/native_loader.py),
// built with g++ and -ljpeg by phnet_torch/ops/_build.py.
//
// decode_clip_rgb_u8, jpeg_planes and encode_gray_jpeg are the port's own:
// the same libjpeg decode as uint8 RGB, uncropped (the reference that the
// card's nvJPEG decode, nvjpeg_decode.cpp, is held against), the component
// planes before upsampling and colour conversion (which the port's PyTorch
// conversion, native_loader.ycc_to_rgb, is held against; a gray JPEG's one
// plane is what cv2.imread(..., IMREAD_GRAYSCALE) reads), and the gray
// JPEG writer of the VIL-100 flow planes (phnet_torch/data/flow.py), with
// cv2.imwrite's settings.
//
// Resize follows cv2.INTER_LINEAR's geometry: src = (dst + 0.5)*scale - 0.5
// with edge clamping (float arithmetic; cv2's 11-bit fixed point agrees to
// ~1/2048 per sample).

#include <cstddef>
#include <cstdio>  // FILE, before jpeglib.h

#include <jpeglib.h>

#include <cmath>
#include <csetjmp>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG file into an RGB (or grayscale) byte image. Returns true
// on success; the buffer is resized to h*w*channels.
bool decode_jpeg(const char* path, std::vector<unsigned char>& buf, int& w,
                 int& h, int channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  const int row_stride = w * channels;
  buf.resize(static_cast<size_t>(h) * row_stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = buf.data() +
        static_cast<size_t>(cinfo.output_scanline) * row_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// Bilinear sample helpers (cv2 geometry).
inline void lin_coef(int dst, double scale, int src_max, int& i0, int& i1,
                     float& w1) {
  double s = (dst + 0.5) * scale - 0.5;
  if (s < 0) s = 0;
  if (s > src_max) s = src_max;
  i0 = static_cast<int>(s);
  i1 = i0 + 1 > src_max ? src_max : i0 + 1;
  w1 = static_cast<float>(s - i0);
}

}  // namespace

extern "C" {

// Decode n JPEG frames, crop cut_px rows off the top, resize to
// (out_h, out_w), normalize (x/255 - mean)/std per channel, write float32
// NHWC into out (n*out_h*out_w*3). Returns 0 on success, 1-based index of
// the first failing frame otherwise.
int decode_clip_rgb(const char** paths, int n, int cut_px, int out_h,
                    int out_w, const float* mean, const float* std_,
                    float* out) {
  int failed = 0;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    std::vector<unsigned char> img;
    int w = 0, h = 0;
    if (!decode_jpeg(paths[i], img, w, h, 3) || h <= cut_px) {
#pragma omp critical
      if (!failed || i + 1 < failed) failed = i + 1;
      continue;
    }
    const unsigned char* src = img.data() +
        static_cast<size_t>(cut_px) * w * 3;
    const int src_h = h - cut_px;
    const double sy = static_cast<double>(src_h) / out_h;
    const double sx = static_cast<double>(w) / out_w;
    float* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;

    std::vector<int> x0(out_w), x1(out_w);
    std::vector<float> wx(out_w);
    for (int x = 0; x < out_w; ++x) lin_coef(x, sx, w - 1, x0[x], x1[x], wx[x]);

    const float inv255 = 1.0f / 255.0f;
    float cmul[3], cadd[3];
    for (int c = 0; c < 3; ++c) {
      cmul[c] = inv255 / std_[c];
      cadd[c] = -mean[c] / std_[c];
    }

    for (int y = 0; y < out_h; ++y) {
      int y0, y1;
      float wy;
      lin_coef(y, sy, src_h - 1, y0, y1, wy);
      const unsigned char* r0 = src + static_cast<size_t>(y0) * w * 3;
      const unsigned char* r1 = src + static_cast<size_t>(y1) * w * 3;
      float* drow = dst + static_cast<size_t>(y) * out_w * 3;
      for (int x = 0; x < out_w; ++x) {
        const int a = x0[x] * 3, b = x1[x] * 3;
        const float fx = wx[x];
        for (int c = 0; c < 3; ++c) {
          const float top = r0[a + c] + fx * (r0[b + c] - r0[a + c]);
          const float bot = r1[a + c] + fx * (r1[b + c] - r1[a + c]);
          const float v = top + wy * (bot - top);
          drow[x * 3 + c] = v * cmul[c] + cadd[c];
        }
      }
    }
  }
  return failed;
}

// The component planes of one JPEG after the IDCT, at their own sampling
// (libjpeg's raw data output). info (7 ints): height, width, components,
// then each of up to 3 components' plane height and width in info[3 + 2c],
// info[4 + 2c] (the chroma planes of a 4:2:0 file are ceil(h/2) x
// ceil(w/2)). With out == NULL only info is filled; else out receives the
// planes one after another, row-major. Returns 0 on success, 1 if the file
// does not decode, 2 if it has more than 3 components.
int jpeg_planes(const char* path, int* info, unsigned char* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<std::vector<unsigned char>> padded;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  const int nc = cinfo.num_components;
  if (nc > 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  info[0] = static_cast<int>(cinfo.image_height);
  info[1] = static_cast<int>(cinfo.image_width);
  info[2] = nc;
  for (int c = 0; c < 3; ++c) {
    info[3 + 2 * c] = 0;
    info[4 + 2 * c] = 0;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  for (int c = 0; c < nc; ++c) {
    info[3 + 2 * c] = static_cast<int>(cinfo.comp_info[c].downsampled_height);
    info[4 + 2 * c] = static_cast<int>(cinfo.comp_info[c].downsampled_width);
  }
  if (out == nullptr) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
  }
  // padded planes: whole blocks wide, whole iMCU rows high
  std::vector<int> rows_per_imcu(nc), stride(nc);
  padded.resize(nc);
  for (int c = 0; c < nc; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    rows_per_imcu[c] = comp.v_samp_factor * DCTSIZE;
    stride[c] = static_cast<int>(comp.width_in_blocks) * DCTSIZE;
    padded[c].assign(static_cast<size_t>(stride[c]) * rows_per_imcu[c] *
                         cinfo.total_iMCU_rows, 0);
  }
  std::vector<std::vector<JSAMPROW>> rows(nc);
  std::vector<JSAMPARRAY> planes(nc);
  for (JDIMENSION imcu = 0; imcu < cinfo.total_iMCU_rows; ++imcu) {
    for (int c = 0; c < nc; ++c) {
      rows[c].resize(rows_per_imcu[c]);
      for (int r = 0; r < rows_per_imcu[c]; ++r)
        rows[c][r] = padded[c].data() +
            (static_cast<size_t>(imcu) * rows_per_imcu[c] + r) * stride[c];
      planes[c] = rows[c].data();
    }
    jpeg_read_raw_data(&cinfo, planes.data(),
                       cinfo.max_v_samp_factor * DCTSIZE);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  unsigned char* dst = out;
  for (int c = 0; c < nc; ++c) {
    const int h = info[3 + 2 * c], w = info[4 + 2 * c];
    for (int r = 0; r < h; ++r, dst += w)
      std::memcpy(dst, padded[c].data() + static_cast<size_t>(r) * stride[c],
                  w);
  }
  return 0;
}

// Decode n JPEG frames of h x w pixels to uint8 RGB, NHWC, into out
// (n*h*w*3). Returns 0 on success, else the 1-based index of the first
// frame that fails to decode or has another size.
int decode_clip_rgb_u8(const char** paths, int n, int h, int w,
                       unsigned char* out) {
  int failed = 0;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    std::vector<unsigned char> img;
    int fw = 0, fh = 0;
    if (!decode_jpeg(paths[i], img, fw, fh, 3) || fw != w || fh != h) {
#pragma omp critical
      if (!failed || i + 1 < failed) failed = i + 1;
      continue;
    }
    std::memcpy(out + static_cast<size_t>(i) * h * w * 3, img.data(),
                img.size());
  }
  return failed;
}

// Write the gray image gray[0:h*w) (rows of w bytes) to `path` as a
// baseline one-component JPEG at `quality`, as cv2.imwrite writes one:
// libjpeg's defaults, jpeg_set_quality(quality, TRUE), no optimized
// Huffman tables. Returns 0 on success, 1 if the file cannot be opened, 2
// if libjpeg fails.
int encode_gray_jpeg(const char* path, const unsigned char* gray, int h,
                     int w, int quality) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 1;
  cinfo.in_color_space = JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        gray + static_cast<size_t>(cinfo.next_scanline) * w);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(f);
  return 0;
}

}  // extern "C"
