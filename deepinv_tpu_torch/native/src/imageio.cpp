// Native image decode + threaded batch loader for deepinv_tpu_torch (a copy
// of the JAX package's deepinv_tpu/native/src/imageio.cpp, kept in the port's
// tree so that the port builds it itself).
//
// Decoding (libpng, libjpeg) and batch assembly happen in C++ worker THREADS
// (no fork, no pickling, no GIL during decode), writing directly into a
// caller-owned float32 NCHW buffer: a torch tensor, in pinned memory when the
// batch goes on to the GPU, from which one asynchronous copy ships it.
//
// Exposed as a plain C ABI consumed via ctypes.

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cmath>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, 8-bit (16-bit PNG downshifted)
};

// ---------------------------------------------------------------- PNG ----
bool decode_png(const char* path, Image& out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  out.w = (int)w;
  out.h = (int)h;
  out.c = channels;
  out.data.resize((size_t)w * h * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out.data.data() + (size_t)y * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// --------------------------------------------------------------- JPEG ----
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->jmp, 1);
}

bool decode_jpeg(const char* path, Image& out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  out.w = cinfo.output_width;
  out.h = cinfo.output_height;
  out.c = cinfo.output_components;
  out.data.resize((size_t)out.w * out.h * out.c);
  while ((int)cinfo.output_scanline < out.h) {
    uint8_t* row = out.data.data() + (size_t)cinfo.output_scanline * out.w * out.c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

bool decode_any(const char* path, Image& out) {
  const char* dot = std::strrchr(path, '.');
  std::string ext = dot ? dot + 1 : "";
  for (auto& ch : ext) ch = (char)std::tolower(ch);
  if (ext == "png") return decode_png(path, out);
  if (ext == "jpg" || ext == "jpeg") return decode_jpeg(path, out);
  // sniff
  return decode_png(path, out) || decode_jpeg(path, out);
}

// Separable triangle-filter resize HWC uint8 -> CHW float in [0,1].
// Support scales with the downscale ratio (antialiased), matching PIL's
// convolution-based resize semantics (align_corners=False grid).
void resize_bilinear(const Image& img, int H, int W, int C, float* dst) {
  const float sy = (float)img.h / H, sx = (float)img.w / W;
  const float supy = sy > 1.f ? sy : 1.f, supx = sx > 1.f ? sx : 1.f;

  // horizontal pass: (img.h, W) per channel, float intermediate
  std::vector<float> tmp((size_t)img.h * W * img.c);
  for (int x = 0; x < W; ++x) {
    float center = (x + 0.5f) * sx;
    int x0 = (int)std::floor(center - supx);
    int x1 = (int)std::ceil(center + supx);
    if (x0 < 0) x0 = 0;
    if (x1 > img.w) x1 = img.w;
    float wsum = 0.f;
    float wbuf[512];
    int taps = x1 - x0;
    if (taps > 512) taps = 512;
    for (int t = 0; t < taps; ++t) {
      float d = ((x0 + t) + 0.5f - center) / supx;
      float wgt = d < 0 ? 1.f + d : 1.f - d;
      if (wgt < 0) wgt = 0;
      wbuf[t] = wgt;
      wsum += wgt;
    }
    for (int t = 0; t < taps; ++t) wbuf[t] /= (wsum > 0 ? wsum : 1.f);
    for (int y = 0; y < img.h; ++y)
      for (int ch = 0; ch < img.c; ++ch) {
        float acc = 0.f;
        for (int t = 0; t < taps; ++t)
          acc += wbuf[t] * img.data[((size_t)y * img.w + x0 + t) * img.c + ch];
        tmp[((size_t)y * W + x) * img.c + ch] = acc;
      }
  }
  // vertical pass -> CHW output
  for (int y = 0; y < H; ++y) {
    float center = (y + 0.5f) * sy;
    int y0 = (int)std::floor(center - supy);
    int y1 = (int)std::ceil(center + supy);
    if (y0 < 0) y0 = 0;
    if (y1 > img.h) y1 = img.h;
    float wsum = 0.f;
    float wbuf[512];
    int taps = y1 - y0;
    if (taps > 512) taps = 512;
    for (int t = 0; t < taps; ++t) {
      float d = ((y0 + t) + 0.5f - center) / supy;
      float wgt = d < 0 ? 1.f + d : 1.f - d;
      if (wgt < 0) wgt = 0;
      wbuf[t] = wgt;
      wsum += wgt;
    }
    for (int t = 0; t < taps; ++t) wbuf[t] /= (wsum > 0 ? wsum : 1.f);
    for (int x = 0; x < W; ++x)
      for (int ch = 0; ch < C; ++ch) {
        int cs = ch < img.c ? ch : img.c - 1;  // gray -> broadcast
        float acc = 0.f;
        for (int t = 0; t < taps; ++t)
          acc += wbuf[t] * tmp[((size_t)(y0 + t) * W + x) * img.c + cs];
        dst[((size_t)ch * H + y) * W + x] = acc / 255.0f;
      }
  }
}

// Center-crop (or pad-crop) to (H, W) with no interpolation.
void center_crop(const Image& img, int H, int W, int C, float* dst) {
  int oy = (img.h - H) / 2, ox = (img.w - W) / 2;
  for (int ch = 0; ch < C; ++ch) {
    int cs = ch < img.c ? ch : img.c - 1;
    for (int y = 0; y < H; ++y) {
      int sy = y + oy;
      for (int x = 0; x < W; ++x) {
        int sx = x + ox;
        float v = 0.0f;
        if (sy >= 0 && sy < img.h && sx >= 0 && sx < img.w)
          v = img.data[((size_t)sy * img.w + sx) * img.c + cs] / 255.0f;
        dst[((size_t)ch * H + y) * W + x] = v;
      }
    }
  }
}

// ---------------------------------------------------------- thread pool ----
class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace

extern "C" {

// Decode one image; returns 0 on success. Caller passes a float32 buffer of
// size C*H*W. mode: 0 = resize (bilinear), 1 = center-crop.
int dtpu_decode(const char* path, float* dst, int C, int H, int W, int mode) {
  Image img;
  if (!decode_any(path, img)) return 1;
  if (mode == 1)
    center_crop(img, H, W, C, dst);
  else
    resize_bilinear(img, H, W, C, dst);
  return 0;
}

// Probe image dimensions without full decode of pixels (PNG header / JPEG
// header). Returns 0 on success.
int dtpu_probe(const char* path, int* h, int* w, int* c) {
  Image img;  // full decode fallback — simple and always correct
  if (!decode_any(path, img)) return 1;
  *h = img.h;
  *w = img.w;
  *c = img.c;
  return 0;
}

// Decode a batch of images in parallel into dst (N, C, H, W) float32.
// paths: array of N C-strings. Returns number of failures.
int dtpu_decode_batch(const char** paths, int n, float* dst, int C, int H,
                      int W, int mode, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::atomic<int> fails{0};
  std::atomic<int> next{0};
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t)
    ts.emplace_back([&] {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        if (dtpu_decode(paths[i], dst + (size_t)i * C * H * W, C, H, W, mode))
          fails.fetch_add(1);
      }
    });
  for (auto& t : ts) t.join();
  return fails.load();
}

// ------------------------------------------------------- prefetcher -------
// Double-buffered background batch loader: the host decodes batch k+1 while
// the GPU consumes batch k (the reference gets this from DataLoader worker
// processes; here it is one C++ thread pool and two pinned buffers).
struct Prefetcher {
  std::vector<std::string> paths;
  int C, H, W, mode, batch, n_threads;
  std::vector<float> buf[2];
  int buf_batch[2] = {-1, -1};
  std::atomic<int> ready[2];
  Pool pool{1};  // orchestration thread; decode fans out internally

  Prefetcher(int nt) : pool(1), n_threads(nt) {
    ready[0] = -1;
    ready[1] = -1;
  }

  void schedule(int batch_idx, int slot) {
    ready[slot] = -1;
    buf_batch[slot] = batch_idx;
    pool.submit([this, batch_idx, slot] {
      int start = batch_idx * batch;
      int count = (int)paths.size() - start;
      if (count > batch) count = batch;
      if (count <= 0) {
        ready[slot] = -2;
        return;
      }
      std::vector<const char*> ps(count);
      for (int i = 0; i < count; ++i) ps[i] = paths[start + i].c_str();
      buf[slot].assign((size_t)batch * C * H * W, 0.0f);
      dtpu_decode_batch(ps.data(), count, buf[slot].data(), C, H, W, mode,
                        n_threads);
      ready[slot] = count;
    });
  }
};

void* dtpu_prefetcher_new(const char** paths, int n, int C, int H, int W,
                          int mode, int batch, int n_threads) {
  auto* p = new Prefetcher(n_threads);
  p->paths.assign(paths, paths + n);
  p->C = C;
  p->H = H;
  p->W = W;
  p->mode = mode;
  p->batch = batch;
  p->schedule(0, 0);
  if ((n + batch - 1) / batch > 1) p->schedule(1, 1);
  return p;
}

// Blocks until batch_idx is decoded; copies it into dst and kicks off the
// next batch. Returns the number of valid samples in the batch (0 at end).
int dtpu_prefetcher_get(void* h, int batch_idx, float* dst) {
  auto* p = static_cast<Prefetcher*>(h);
  int slot = batch_idx % 2;
  if (p->buf_batch[slot] != batch_idx) p->schedule(batch_idx, slot);
  while (p->ready[slot] == -1) std::this_thread::yield();
  int count = p->ready[slot];
  if (count <= 0) return 0;
  std::memcpy(dst, p->buf[slot].data(),
              sizeof(float) * (size_t)p->batch * p->C * p->H * p->W);
  int nb = ((int)p->paths.size() + p->batch - 1) / p->batch;
  if (batch_idx + 2 < nb) p->schedule(batch_idx + 2, slot);
  return count;
}

void dtpu_prefetcher_free(void* h) { delete static_cast<Prefetcher*>(h); }

}  // extern "C"
