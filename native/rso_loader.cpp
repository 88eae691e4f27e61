// rso native data-loader: image decode + threaded in-order prefetch ring.
//
// The reference's data-loading layer is native C++ (MRPT CCameraSensor /
// rawlog playback / CImage file decode feeding the engine,
// demo-stereo-odometry/demo-main.cpp:110-146); this library is the JAX
// build's equivalent host runtime piece: grayscale decode of the dataset
// image formats (PNG via libpng, JPEG via libjpeg, PGM) and a bounded
// multi-threaded prefetch ring that overlaps decode with device compute
// (the host half of the pipeline-parallel design, SURVEY.md section 2.5).
//
// Exposed via plain C symbols for ctypes (no pybind11 in this toolchain).
// Built separately from librso_native.so so the dependency-free kernel
// oracles stay loadable even if libpng/libjpeg are absent at runtime.
// Build: native/build.sh

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <png.h>

#include <csetjmp>
extern "C" {
#include <jpeglib.h>
}

namespace {

// ---------------------------------------------------------------------------
// decoders: all produce 8-bit grayscale into a caller buffer of capacity cap.
// Return 0 on success, negative on failure.  *h/*w receive the decoded dims.

enum {
  RSO_OK = 0,
  RSO_ERR_OPEN = -1,
  RSO_ERR_FORMAT = -2,
  RSO_ERR_DECODE = -3,
  RSO_ERR_TOO_BIG = -4,
  RSO_ERR_DIMS = -5,  // frame dims differ from the ring's probed dims
  RSO_END = 1,
};

int decode_png_gray(const char* path, uint8_t* out, long cap, int* h, int* w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return RSO_ERR_DECODE;
  long need = long(image.width) * image.height;
  if (need > cap) {
    png_image_free(&image);
    return RSO_ERR_TOO_BIG;
  }
  bool color = (image.format & PNG_FORMAT_FLAG_COLOR) != 0;
  if (!color) {
    image.format = PNG_FORMAT_GRAY;
    if (!png_image_finish_read(&image, nullptr, out, 0 /*packed rows*/,
                               nullptr)) {
      png_image_free(&image);
      return RSO_ERR_DECODE;
    }
  } else {
    // Color sources: decode RGB and convert with BT.601 fixed-point weights
    // (identical to OpenCV's cvtColor, so gray values are bit-stable no
    // matter which host decoder a run used), instead of libpng's
    // linear-light BT.709 grayscale.
    image.format = PNG_FORMAT_RGB;
    std::vector<uint8_t> rgb(size_t(need) * 3);
    if (!png_image_finish_read(&image, nullptr, rgb.data(), 0, nullptr)) {
      png_image_free(&image);
      return RSO_ERR_DECODE;
    }
    for (long i = 0; i < need; ++i) {
      const uint8_t* p = rgb.data() + 3 * i;
      out[i] = uint8_t((4899u * p[0] + 9617u * p[1] + 1868u * p[2] + 8192u) >>
                       14);
    }
  }
  *w = int(image.width);
  *h = int(image.height);
  return RSO_OK;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jump, 1);
}

int decode_jpeg_gray(const char* path, uint8_t* out, long cap, int* h,
                     int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return RSO_ERR_OPEN;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return RSO_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  long need = long(cinfo.output_width) * cinfo.output_height;
  if (need > cap) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return RSO_ERR_TOO_BIG;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + size_t(cinfo.output_scanline) * cinfo.output_width;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  *w = int(cinfo.output_width);
  *h = int(cinfo.output_height);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return RSO_OK;
}

// P5 (binary) / P2 (ascii) PGM, maxval up to 65535 (16-bit scaled down >>8).
int decode_pgm_gray(FILE* f, uint8_t* out, long cap, int* h, int* w) {
  auto next_int = [&](long* v) -> bool {
    int c;
    for (;;) {  // skip whitespace + '#' comments
      c = std::fgetc(f);
      if (c == '#') {
        while (c != '\n' && c != EOF) c = std::fgetc(f);
      } else if (c == EOF) {
        return false;
      } else if (!std::isspace(c)) {
        break;
      }
    }
    long acc = 0;
    bool any = false;
    while (c != EOF && std::isdigit(c)) {
      acc = acc * 10 + (c - '0');
      any = true;
      c = std::fgetc(f);
    }
    *v = acc;
    return any;
  };
  int c0 = std::fgetc(f), c1 = std::fgetc(f);
  if (c0 != 'P' || (c1 != '5' && c1 != '2')) return RSO_ERR_FORMAT;
  bool binary = (c1 == '5');
  long W, H, maxval;
  if (!next_int(&W) || !next_int(&H) || !next_int(&maxval)) {
    return RSO_ERR_DECODE;
  }
  if (W <= 0 || H <= 0 || maxval <= 0 || maxval > 65535) return RSO_ERR_DECODE;
  if (W * H > cap) return RSO_ERR_TOO_BIG;
  long n = W * H;
  if (binary) {
    if (maxval < 256) {
      if (long(std::fread(out, 1, n, f)) != n) return RSO_ERR_DECODE;
    } else {
      std::vector<uint8_t> raw(size_t(n) * 2);
      if (long(std::fread(raw.data(), 1, raw.size(), f)) != long(raw.size())) {
        return RSO_ERR_DECODE;
      }
      for (long i = 0; i < n; ++i) out[i] = raw[2 * i];  // big-endian >>8
    }
  } else {
    for (long i = 0; i < n; ++i) {
      long v;
      if (!next_int(&v)) return RSO_ERR_DECODE;
      out[i] = uint8_t(maxval < 256 ? v : v >> 8);
    }
  }
  *w = int(W);
  *h = int(H);
  return RSO_OK;
}

int decode_gray_impl(const char* path, uint8_t* out, long cap, int* h,
                     int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return RSO_ERR_OPEN;
  uint8_t magic[2] = {0, 0};
  size_t got = std::fread(magic, 1, 2, f);
  if (got != 2) {
    std::fclose(f);
    return RSO_ERR_FORMAT;
  }
  if (magic[0] == 0x89 && magic[1] == 'P') {
    std::fclose(f);
    return decode_png_gray(path, out, cap, h, w);
  }
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    std::fclose(f);
    return decode_jpeg_gray(path, out, cap, h, w);
  }
  if (magic[0] == 'P' && (magic[1] == '5' || magic[1] == '2')) {
    std::rewind(f);
    int rc = decode_pgm_gray(f, out, cap, h, w);
    std::fclose(f);
    return rc;
  }
  std::fclose(f);
  return RSO_ERR_FORMAT;
}

// ---------------------------------------------------------------------------
// prefetch ring: workers decode stereo pairs in claim order into depth slots;
// the consumer pops frames strictly in order.  Slot i%depth is reusable once
// the consumer has advanced past frame i-depth, so at most `depth` frames are
// in flight and memory is bounded at 2*depth*H*W.

struct Slot {
  std::vector<uint8_t> left, right;
  int status = 0;  // 0 empty, 1 ready
  int err = RSO_OK;
};

struct Loader {
  std::vector<std::string> lp, rp;
  int H = 0, W = 0, depth = 0;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  size_t next_in = 0;   // next frame index a worker will claim
  size_t next_out = 0;  // next frame index the consumer will pop
  bool closed = false;
  std::vector<std::thread> workers;

  void work() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (closed || next_in >= lp.size()) return;
        idx = next_in++;
        cv_free.wait(lk, [&] { return closed || idx < next_out + depth; });
        if (closed) return;
      }
      Slot& s = slots[idx % depth];
      long cap = long(H) * W;
      int h = 0, w = 0;
      int rc = decode_gray_impl(lp[idx].c_str(), s.left.data(), cap, &h, &w);
      if (rc == RSO_OK && (h != H || w != W)) rc = RSO_ERR_DIMS;
      if (rc == RSO_OK) {
        rc = decode_gray_impl(rp[idx].c_str(), s.right.data(), cap, &h, &w);
        if (rc == RSO_OK && (h != H || w != W)) rc = RSO_ERR_DIMS;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        s.err = rc;
        s.status = 1;
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// One-shot decode of any supported image to 8-bit grayscale.  out has
// capacity cap bytes; *h/*w receive the dims.  Returns 0 or a negative error.
int rso_decode_gray(const char* path, uint8_t* out, long cap, int* h, int* w) {
  return decode_gray_impl(path, out, cap, h, w);
}

// Probe the dimensions of an image without keeping the pixels.
int rso_probe_image(const char* path, int* h, int* w) {
  // PNG/JPEG headers carry dims, but a probe via full decode keeps one code
  // path; datasets call this once per sequence so the cost is irrelevant.
  std::vector<uint8_t> buf(size_t(1) << 26);  // 64 MiB ceiling
  return decode_gray_impl(path, buf.data(), long(buf.size()), h, w);
}

// Open a prefetch ring over n stereo pairs.  Probes pair 0 for the frame
// dims (all frames must match).  Returns an opaque handle or null.
void* rso_loader_open(const char** left_paths, const char** right_paths,
                      int n, int depth, int n_threads, int* h, int* w) {
  if (n <= 0 || depth <= 0 || n_threads <= 0) return nullptr;
  int H = 0, W = 0;
  if (rso_probe_image(left_paths[0], &H, &W) != RSO_OK) return nullptr;
  auto* L = new Loader();
  L->lp.reserve(n);
  L->rp.reserve(n);
  for (int i = 0; i < n; ++i) {
    L->lp.emplace_back(left_paths[i]);
    L->rp.emplace_back(right_paths[i]);
  }
  L->H = H;
  L->W = W;
  L->depth = depth;
  L->slots.resize(depth);
  for (auto& s : L->slots) {
    s.left.resize(size_t(H) * W);
    s.right.resize(size_t(H) * W);
  }
  int nt = n_threads < depth ? n_threads : depth;
  for (int t = 0; t < nt; ++t) {
    L->workers.emplace_back([L] { L->work(); });
  }
  *h = H;
  *w = W;
  return L;
}

// Pop the next frame in order, copying into caller buffers of H*W bytes.
// Returns 0 on success, 1 at end-of-sequence, negative decode error codes
// (the ring keeps advancing after an error, so callers may skip bad frames).
int rso_loader_next(void* handle, uint8_t* left, uint8_t* right, int* index) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_out >= L->lp.size()) return RSO_END;
  size_t idx = L->next_out;
  Slot& s = L->slots[idx % L->depth];
  L->cv_ready.wait(lk, [&] { return L->closed || s.status == 1; });
  if (L->closed) return RSO_END;
  int rc = s.err;
  if (rc == RSO_OK) {
    std::memcpy(left, s.left.data(), s.left.size());
    std::memcpy(right, s.right.data(), s.right.size());
  }
  *index = int(idx);
  s.status = 0;
  s.err = RSO_OK;
  L->next_out++;
  L->cv_free.notify_all();
  return rc;
}

void rso_loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closed = true;
    L->cv_free.notify_all();
    L->cv_ready.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
