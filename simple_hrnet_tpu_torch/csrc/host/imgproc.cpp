// Native host-side image pipeline for the training data loader.
//
// The reference's data path runs inside torch DataLoader's native workers
// (cv2 decode + warpAffine per sample). This library provides the same hot
// path as three C calls — JPEG probe, and a FUSED decode -> affine warp ->
// ImageNet normalize that produces the network-ready float32 HWC tensor in
// one pass with no intermediate Python arrays:
//
//   int  jpeg_dims(const uint8_t* buf, int len, int* w, int* h);
//   int  jpeg_decode_rgb(const uint8_t* buf, int len, uint8_t* out);
//   void warp_affine_bilinear(const float* src, int h, int w,
//                             const float* m_inv,  // 2x3 dst->src map
//                             float* dst, int oh, int ow);
//   int  decode_warp_normalize(const uint8_t* jpeg, int len,
//                              const float* m_inv, int oh, int ow,
//                              const float* mean255, const float* scale,
//                              float* out);  // (oh, ow, 3) float32
//
// Interpolation is bilinear with constant-0 border (cv2.INTER_LINEAR +
// BORDER_CONSTANT semantics). Exposed via ctypes
// (simple_hrnet_tpu_torch/data/native.py). The port's own copy of the JAX
// package's native/imgproc.cpp, built at first use (with -ljpeg) by
// simple_hrnet_tpu_torch/ops/cuda/build.py::host_library.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

}  // namespace

extern "C" {

int jpeg_dims(const uint8_t* buf, int len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to RGB8 (out must hold w*h*3). Returns 0 on success.
int jpeg_decode_rgb(const uint8_t* buf, int len, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int stride = cinfo.output_width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// dst(y, x) = src(m_inv * (x, y, 1)), bilinear, 0 outside. 3-channel f32.
void warp_affine_bilinear(const float* src, int h, int w, const float* m_inv,
                          float* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const float sx = m_inv[0] * x + m_inv[1] * y + m_inv[2];
      const float sy = m_inv[3] * x + m_inv[4] * y + m_inv[5];
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const float fx = sx - x0;
      const float fy = sy - y0;
      float acc[3] = {0.f, 0.f, 0.f};
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= h) continue;
        const float wy = dy ? fy : 1.f - fy;
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= w) continue;
          const float wgt = wy * (dx ? fx : 1.f - fx);
          const float* p = src + (yy * w + xx) * 3;
          acc[0] += wgt * p[0];
          acc[1] += wgt * p[1];
          acc[2] += wgt * p[2];
        }
      }
      float* o = dst + (y * ow + x) * 3;
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }
}

// Fused: JPEG -> RGB -> warp -> (x_255 - mean255)*scale. out is
// (oh, ow, 3) f32. The caller passes the framework's shared pre-merged
// f32 constants (ops/image.py MEAN255 / INV255_STD): subtract-then-
// multiply is the ONE normalize convention every subsystem uses because
// it is immune to both XLA's x/const strength reduction and to FMA
// contraction (a*b - c fuses into one rounding under both XLA and C
// -ffp-contract, while sub-then-mul cannot fuse) — so host numpy, this
// kernel, and in-graph jit agree bitwise
// (tests/test_normalize_convention.py). mean255 = 0, scale = 1 emits the
// raw warp accumulator (device_targets mode raw tail).
int decode_warp_normalize(const uint8_t* jpeg, int len, const float* m_inv,
                          int oh, int ow, const float* mean255,
                          const float* scale, float* out) {
  int w = 0, h = 0;
  if (jpeg_dims(jpeg, len, &w, &h) != 0) return -1;
  std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
  if (jpeg_decode_rgb(jpeg, len, rgb.data()) != 0) return -1;
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const float sx = m_inv[0] * x + m_inv[1] * y + m_inv[2];
      const float sy = m_inv[3] * x + m_inv[4] * y + m_inv[5];
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const float fx = sx - x0;
      const float fy = sy - y0;
      float acc[3] = {0.f, 0.f, 0.f};
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= h) continue;
        const float wy = dy ? fy : 1.f - fy;
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= w) continue;
          const float wgt = wy * (dx ? fx : 1.f - fx);
          const uint8_t* p = rgb.data() + (static_cast<size_t>(yy) * w + xx) * 3;
          acc[0] += wgt * p[0];
          acc[1] += wgt * p[1];
          acc[2] += wgt * p[2];
        }
      }
      float* o = out + (static_cast<size_t>(y) * ow + x) * 3;
      o[0] = (acc[0] - mean255[0]) * scale[0];
      o[1] = (acc[1] - mean255[1]) * scale[1];
      o[2] = (acc[2] - mean255[2]) * scale[2];
    }
  }
  return 0;
}

}  // extern "C"
