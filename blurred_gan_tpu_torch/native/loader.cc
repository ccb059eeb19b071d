// Host image decoder of the PyTorch port: multithreaded JPEG / PNG decode,
// centre crop and antialiased resize.
//
// A batch of image files is decoded in parallel on a small thread pool,
// centre-cropped to the largest square and resized with PIL's BILINEAR
// (triangle-filter) semantics to the target resolution, straight into a
// caller-provided uint8 NHWC buffer. The train step moves that buffer to the
// card and normalises it there. The code below is the JAX package's loader,
// unchanged, so both packages decode the same files to the same bytes.
//
// C ABI (ctypes-friendly), no global state, no Python dependency:
//   bgt_decode_batch(paths, n, resolution, out, n_threads) -> 0 | first error
//   bgt_gather_batch(src, indices, n, item_bytes, out, n_threads)
//
// Build: blurred_gan_tpu_torch/native/__init__.py compiles this at first use
// (g++ -O3 -fPIC -shared -std=c++17 -pthread, linking libjpeg and libpng)
// into blurred_gan_tpu_torch/_build/.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB, row-major
  int w = 0, h = 0;
};

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG ----

bool decode_png(FILE* f, Image* out) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
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
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  // Normalise everything to 8-bit RGB.
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int c0 = fgetc(f);
  int c1 = fgetc(f);
  rewind(f);
  bool ok = false;
  if (c0 == 0xFF && c1 == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (c0 == 0x89 && c1 == 'P') {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// ---------------------------------------- crop + antialiased resize --------

// Triangle-filter (BILINEAR) resampling with PIL's semantics: when
// downscaling, the filter support scales with the reduction factor, so the
// result is antialiased area-weighted averaging, not 2×2 point sampling.
// Separable: one coefficient table per output coordinate, reused across rows.
struct ResampleCoeffs {
  std::vector<int> xmin, xlen;   // first source index / tap count per output
  std::vector<float> weights;    // taps, max_len stride
  int max_len = 0;
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = double(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle support = 1
  rc.max_len = int(2 * support + 2);
  rc.xmin.resize(out_size);
  rc.xlen.resize(out_size);
  rc.weights.assign(size_t(out_size) * rc.max_len, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int lo = int(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = int(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    double sum = 0.0;
    std::vector<double> w(hi - lo);
    for (int k = lo; k < hi; ++k) {
      double x = (k + 0.5 - center) / filterscale;
      double v = x < 0 ? 1.0 + x : 1.0 - x;  // triangle
      if (v < 0) v = 0;
      w[k - lo] = v;
      sum += v;
    }
    rc.xmin[xx] = lo;
    rc.xlen[xx] = hi - lo;
    for (int k = 0; k < hi - lo; ++k)
      rc.weights[size_t(xx) * rc.max_len + k] =
          float(sum > 0 ? w[k] / sum : 0.0);
  }
  return rc;
}

// Centre-crop the largest square, then PIL-BILINEAR-resize to res×res RGB.
// Matches the Python fallback path (ImageFolderDataset._decode: PIL
// Image.BILINEAR) to within rounding.
void crop_resize(const Image& img, int res, uint8_t* dst) {
  const int side = img.w < img.h ? img.w : img.h;
  const int x0 = (img.w - side) / 2;
  const int y0 = (img.h - side) / 2;
  const ResampleCoeffs rc = triangle_coeffs(side, res);

  // Horizontal pass: (side, side, 3) -> (side, res, 3) in float.
  std::vector<float> tmp(size_t(side) * res * 3);
  for (int y = 0; y < side; ++y) {
    const uint8_t* src_row =
        img.data.data() + (size_t(y0 + y) * img.w + x0) * 3;
    float* tmp_row = tmp.data() + size_t(y) * res * 3;
    for (int xx = 0; xx < res; ++xx) {
      const float* w = &rc.weights[size_t(xx) * rc.max_len];
      const int lo = rc.xmin[xx], len = rc.xlen[xx];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < len; ++k) {
        const uint8_t* p = src_row + size_t(lo + k) * 3;
        acc0 += w[k] * p[0];
        acc1 += w[k] * p[1];
        acc2 += w[k] * p[2];
      }
      tmp_row[size_t(xx) * 3 + 0] = acc0;
      tmp_row[size_t(xx) * 3 + 1] = acc1;
      tmp_row[size_t(xx) * 3 + 2] = acc2;
    }
  }
  // Vertical pass: (side, res, 3) -> (res, res, 3) uint8.
  for (int yy = 0; yy < res; ++yy) {
    const float* w = &rc.weights[size_t(yy) * rc.max_len];
    const int lo = rc.xmin[yy], len = rc.xlen[yy];
    uint8_t* out_row = dst + size_t(yy) * res * 3;
    for (int xx = 0; xx < res * 3; ++xx) {
      float acc = 0;
      for (int k = 0; k < len; ++k)
        acc += w[k] * tmp[size_t(lo + k) * res * 3 + xx];
      int v = int(acc + 0.5f);
      out_row[xx] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

void run_parallel(int n_items, int n_threads,
                  const std::function<void(int)>& fn) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n_items; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads && t < n_items; ++t)
    threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Decode n image files into out (n, res, res, 3) uint8. Returns 0 on success
// or 1-based index of the first file that failed to decode.
int bgt_decode_batch(const char** paths, int n, int res, uint8_t* out,
                     int n_threads) {
  std::atomic<int> first_err(0);
  run_parallel(n, n_threads, [&](int i) {
    Image img;
    if (!decode_file(paths[i], &img) || img.w < 1 || img.h < 1) {
      int expected = 0;
      first_err.compare_exchange_strong(expected, i + 1);
      return;
    }
    crop_resize(img, res, out + size_t(i) * res * res * 3);
  });
  return first_err.load();
}

// Parallel gather: out[i] = src[indices[i]] for item_bytes-sized rows.
void bgt_gather_batch(const uint8_t* src, const int64_t* indices, int n,
                      int64_t item_bytes, uint8_t* out, int n_threads) {
  run_parallel(n, n_threads, [&](int i) {
    memcpy(out + size_t(i) * item_bytes,
           src + size_t(indices[i]) * item_bytes, size_t(item_bytes));
  });
}

}  // extern "C"
