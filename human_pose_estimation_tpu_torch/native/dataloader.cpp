// Native batch image decoder for the TF-free input pipeline (the port's
// copy of the JAX package's native/dataloader.cpp; the code is unchanged).
//
// Role: the reference leans on tf.data's C++ runtime for record IO +
// JPEG decode (ref train.py:35-40, src/data_loader.py:87-93); this is
// the rebuilt framework's own native equivalent for the host half of
// the pipeline: multithreaded JPEG (libjpeg) / PNG (libpng) decode and
// bilinear fit-to-canvas into preallocated batch buffers, so the Python
// layer only moves pointers. The device half (augmentation, silhouette
// extraction) stays on the device (data/augment.py).
//
// Geometry contract (must match data/npz_dataset._fit_to_canvas_np and
// data/pipeline._fit_to_canvas):
//   scale = min(1, canvas / max(h, w));  new_h = floor(h*scale);
//   new_w = floor(w*scale);  bilinear resize with half-pixel centers
//   (cv2.INTER_LINEAR convention);  paste at top-left of a zeroed
//   canvas;  report (new_h, new_w) and (fy, fx) = (new_h/h, new_w/w).
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- JPEG
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode an encoded JPEG into an RGB8 buffer. Returns false on failure.
bool decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* out,
                 int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  out->resize(static_cast<size_t>(*h) * *w * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG
struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + count > s->size) {
    png_error(png, "png: read past end");
  }
  std::memcpy(out, s->data + s->pos, count);
  s->pos += count;
}

// Decode an encoded PNG into a GRAY8 buffer. Returns false on failure.
bool decode_png_gray(const uint8_t* data, size_t size,
                     std::vector<uint8_t>* out, int* h, int* w) {
  if (size < 8 || png_sig_cmp(data, 0, 8) != 0) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{data, size, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    // Integer BT.601, same as cv2 IMREAD_GRAYSCALE for 8-bit input.
    png_set_rgb_to_gray(png, PNG_ERROR_ACTION_NONE, -1, -1);
  }
  png_read_update_info(png, info);

  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  out->resize(static_cast<size_t>(*h) * *w);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = out->data() + static_cast<size_t>(y) * *w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ------------------------------------------------------------- resize
// Bilinear resize with half-pixel-center sampling (cv2.INTER_LINEAR
// convention: src = (dst + 0.5) * (in / out) - 0.5), clamped borders.
// Channels interleaved; float accumulation, round-to-nearest store.
void resize_bilinear(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * ch);
    return;
  }
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> wx(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int ix = static_cast<int>(fx);
    if (ix > sw - 2) ix = sw - 2;
    if (ix < 0) ix = 0;  // sw == 1
    x0[x] = ix;
    x1[x] = (sw > 1) ? ix + 1 : ix;
    wx[x] = (sw > 1) ? fx - ix : 0.0f;
    if (wx[x] < 0) wx[x] = 0;
    if (wx[x] > 1) wx[x] = 1;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int iy = static_cast<int>(fy);
    if (iy > sh - 2) iy = sh - 2;
    if (iy < 0) iy = 0;
    float dy = (sh > 1) ? fy - iy : 0.0f;
    if (dy < 0) dy = 0;
    if (dy > 1) dy = 1;
    const uint8_t* r0 = src + static_cast<size_t>(iy) * sw * ch;
    const uint8_t* r1 = src + static_cast<size_t>((sh > 1) ? iy + 1 : iy) * sw * ch;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      const int a = x0[x] * ch, b = x1[x] * ch;
      const float tx = wx[x];
      for (int c = 0; c < ch; ++c) {
        const float top = r0[a + c] + tx * (r0[b + c] - r0[a + c]);
        const float bot = r1[a + c] + tx * (r1[b + c] - r1[a + c]);
        const float v = top + dy * (bot - top);
        drow[x * ch + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

struct Example {
  const uint8_t* jpeg;
  size_t jpeg_size;
  const uint8_t* png;
  size_t png_size;
};

// Crop [y0, y1) x [x0, x1) in place (interleaved channels).
void crop_rows(std::vector<uint8_t>* buf, int w, int ch, int x0, int y0,
               int x1, int y1) {
  const int ww = x1 - x0, wh = y1 - y0;
  std::vector<uint8_t> out(static_cast<size_t>(wh) * ww * ch);
  for (int y = 0; y < wh; ++y) {
    std::memcpy(out.data() + static_cast<size_t>(y) * ww * ch,
                buf->data() + (static_cast<size_t>(y0 + y) * w + x0) * ch,
                static_cast<size_t>(ww) * ch);
  }
  buf->swap(out);
}

// Decode + fit one example into the batch buffers. Returns 0 ok, else
// an error bit mask (1 = jpeg failed, 2 = png failed, 4 = seg mismatch).
//
// window_half > 0: crop a +-window_half window around (cx, cy) at SOURCE
// resolution BEFORE the canvas fit (same geometry as
// data/pipeline._fit_to_canvas / npz_dataset._fit_to_canvas_np), so a
// small person in a large frame keeps full detail. The window offset is
// reported in out_hw[4..5] for label/center shifting.
int process_one(const Example& ex, int canvas, int cx, int cy,
                int window_half, uint8_t* out_img, uint8_t* out_seg,
                int32_t* out_hw, float* out_scale) {
  std::memset(out_img, 0, static_cast<size_t>(canvas) * canvas * 3);
  std::memset(out_seg, 0, static_cast<size_t>(canvas) * canvas);
  for (int k = 0; k < 6; ++k) out_hw[k] = 0;
  out_scale[0] = out_scale[1] = 0.0f;

  std::vector<uint8_t> img, seg;
  int h = 0, w = 0, gh = 0, gw = 0;
  int err = 0;
  if (!decode_jpeg(ex.jpeg, ex.jpeg_size, &img, &h, &w)) err |= 1;
  if (ex.png_size > 0) {
    if (!decode_png_gray(ex.png, ex.png_size, &seg, &gh, &gw)) err |= 2;
  }
  if (err) return err;
  if (ex.png_size > 0 && (gh != h || gw != w)) err |= 4;
  if (err) return err;

  int off_x = 0, off_y = 0;
  if (window_half > 0) {
    int x0 = cx - window_half;
    if (x0 < 0) x0 = 0;
    if (x0 > w - 1) x0 = w - 1;
    int y0 = cy - window_half;
    if (y0 < 0) y0 = 0;
    if (y0 > h - 1) y0 = h - 1;
    int x1 = cx + window_half;
    if (x1 > w) x1 = w;
    if (x1 < x0 + 1) x1 = x0 + 1;
    int y1 = cy + window_half;
    if (y1 > h) y1 = h;
    if (y1 < y0 + 1) y1 = y0 + 1;
    if (x0 > 0 || y0 > 0 || x1 < w || y1 < h) {
      crop_rows(&img, w, 3, x0, y0, x1, y1);
      if (ex.png_size > 0) crop_rows(&seg, w, 1, x0, y0, x1, y1);
      off_x = x0;
      off_y = y0;
      h = y1 - y0;
      w = x1 - x0;
    }
  }

  // Double-precision fit scale: floor(h * scale) must agree bit-for-bit
  // with the Python float64 geometry (float32 flips the floor at
  // near-integer products, shifting the whole crop by a pixel).
  const double scale =
      std::min(1.0, static_cast<double>(canvas) / std::max(h, w));
  const int new_h = static_cast<int>(std::floor(h * scale));
  const int new_w = static_cast<int>(std::floor(w * scale));

  std::vector<uint8_t> rimg(static_cast<size_t>(new_h) * new_w * 3);
  resize_bilinear(img.data(), h, w, 3, rimg.data(), new_h, new_w);
  for (int y = 0; y < new_h; ++y) {
    std::memcpy(out_img + static_cast<size_t>(y) * canvas * 3,
                rimg.data() + static_cast<size_t>(y) * new_w * 3,
                static_cast<size_t>(new_w) * 3);
  }
  if (ex.png_size > 0) {
    std::vector<uint8_t> rseg(static_cast<size_t>(new_h) * new_w);
    resize_bilinear(seg.data(), h, w, 1, rseg.data(), new_h, new_w);
    for (int y = 0; y < new_h; ++y) {
      std::memcpy(out_seg + static_cast<size_t>(y) * canvas,
                  rseg.data() + static_cast<size_t>(y) * new_w,
                  static_cast<size_t>(new_w));
    }
  }
  out_hw[0] = new_h;
  out_hw[1] = new_w;
  out_hw[2] = h;  // window (== source when no crop) dims pre-fit
  out_hw[3] = w;
  out_hw[4] = off_y;
  out_hw[5] = off_x;
  out_scale[0] = static_cast<float>(new_h) / h;
  out_scale[1] = static_cast<float>(new_w) / w;
  return 0;
}

}  // namespace

extern "C" {

// Decode a batch of (JPEG image, optional PNG segmentation) pairs into
// fixed uint8 canvases, multithreaded over examples.
//
//   jpeg_ptrs/jpeg_sizes, png_ptrs/png_sizes : n encoded buffers
//       (png_sizes[i] == 0 -> no segmentation; out_seg stays zeroed)
//   canvas    : output side length
//   centers   : n * 2 int32 person centers (x, y) in source coords, or
//               nullptr; with window_half > 0 a +-window_half window is
//               cropped around the center at source resolution first
//   window_half : 0 disables the pre-crop
//   out_img   : n * canvas * canvas * 3 uint8 (zero-padded)
//   out_seg   : n * canvas * canvas     uint8 (zero-padded)
//   out_hw    : n * 6 int32  (new_h, new_w, win_h, win_w, off_y, off_x)
//   out_scale : n * 2 float  (fy, fx) for label/center rescaling
//   out_err   : n int32 error masks (0 = ok)
//   num_threads <= 0 -> hardware_concurrency
// Returns the number of failed examples.
int hpe_decode_fit_batch(const uint8_t** jpeg_ptrs, const int64_t* jpeg_sizes,
                         const uint8_t** png_ptrs, const int64_t* png_sizes,
                         int64_t n, int canvas, const int32_t* centers,
                         int window_half, uint8_t* out_img,
                         uint8_t* out_seg, int32_t* out_hw, float* out_scale,
                         int32_t* out_err, int num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  if (num_threads > n) num_threads = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  const size_t img_stride = static_cast<size_t>(canvas) * canvas * 3;
  const size_t seg_stride = static_cast<size_t>(canvas) * canvas;

  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      Example ex{jpeg_ptrs[i], static_cast<size_t>(jpeg_sizes[i]),
                 png_ptrs ? png_ptrs[i] : nullptr,
                 png_sizes ? static_cast<size_t>(png_sizes[i]) : 0};
      const int cx = centers ? centers[i * 2] : 0;
      const int cy = centers ? centers[i * 2 + 1] : 0;
      const int err =
          process_one(ex, canvas, cx, cy, centers ? window_half : 0,
                      out_img + i * img_stride, out_seg + i * seg_stride,
                      out_hw + i * 6, out_scale + i * 2);
      out_err[i] = err;
      if (err) failures.fetch_add(1);
    }
  };

  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

}  // extern "C"
