// host_loader: the native (C++17) data-loading core of ddti_tpu_torch,
// copied from the JAX package's runtime/host_loader.cpp with its libjpeg
// half behind a macro.
//
// The reference hides its data-path parallelism inside DataLoader worker
// processes (fork + pickle + pipe a batch). Here the decoded uint8 dataset
// store is mmap'd, and a pool of C++ threads assembles shuffled batches
// into a bounded ring of buffers while the card computes. Python talks to
// it through ctypes (no pybind11): ddti_tpu_torch/runtime/native.py.
//
// Store format: a raw uint8 array of shape (N, H, W) in C order, one file
// for the images and one for the masks (the shape travels on the Python
// side).
//
// Build (native.py does it, into build/ddti_tpu_torch/):
//   g++ -O3 -std=c++17 -fPIC -pthread -shared -o lib.so host_loader.cpp -ljpeg
// Where jpeglib.h is absent, -DDDTI_NO_JPEG builds the mmap loader alone:
// the decode entry points are then missing and host_loader_has_jpeg()
// returns 0.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

#ifndef DDTI_NO_JPEG
#include <jpeglib.h>
#endif

namespace {

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path, size_t expect) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < expect) {
      ::close(fd);
      fd = -1;
      return false;
    }
    size = st.st_size;
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      fd = -1;
      return false;
    }
    data = static_cast<const uint8_t*>(p);
    ::madvise(const_cast<uint8_t*>(data), size, MADV_WILLNEED);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

struct Batch {
  std::vector<uint8_t> imgs;
  std::vector<uint8_t> masks;
  long epoch = 0;
};

class Loader {
 public:
  Loader(int n, int h, int w, int batch, uint64_t seed, int threads,
         int queue_depth, bool drop_last)
      : n_(n), item_(static_cast<size_t>(h) * w), batch_(batch),
        seed_(seed), queue_depth_(queue_depth), drop_last_(drop_last),
        num_threads_(threads < 1 ? 1 : threads) {}

  bool open(const char* imgs, const char* masks) {
    if (n_ <= 0 || batch_ <= 0 || steps_per_epoch() <= 0)
      return false;  // drop_last with n < batch, or an empty store
    size_t expect = static_cast<size_t>(n_) * item_;
    if (!imgs_.open(imgs, expect) || !masks_.open(masks, expect))
      return false;
    // start workers only once the mappings are live
    for (int t = 0; t < num_threads_; ++t)
      workers_.emplace_back([this] { this->work(0); });
    return true;
  }

  // Blocks until THE NEXT batch (in ticket order) is ready; copies it into
  // the caller buffers. Delivery is strictly sequential — (epoch 0, step
  // 0), (0, 1), ... — regardless of which worker finished first, so the
  // documented deterministic per-epoch shuffle is what the consumer sees.
  // Returns the epoch index of the batch, or -1 after destroy().
  long next(uint8_t* imgs_out, uint8_t* masks_out) {
    std::unique_lock<std::mutex> lk(mu_);
    ready_cv_.wait(lk, [this] {
      return stop_ || done_.count(next_pop_) != 0;
    });
    auto it = done_.find(next_pop_);
    if (it == done_.end()) return -1;  // stopped with nothing pending
    Batch b = std::move(it->second);
    done_.erase(it);
    ++next_pop_;
    lk.unlock();
    space_cv_.notify_all();
    std::memcpy(imgs_out, b.imgs.data(), b.imgs.size());
    std::memcpy(masks_out, b.masks.data(), b.masks.size());
    return b.epoch;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    ready_cv_.notify_all();
    space_cv_.notify_all();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
  }

  ~Loader() { stop(); }

 private:
  // Each claim hands a worker one batch slot (epoch, step); epochs are
  // reshuffled deterministically from (seed, epoch). Claiming waits until
  // fewer than queue_depth_ tickets are in flight (claimed but not yet
  // popped), so host memory is bounded at queue_depth_ batches total —
  // built or building — with no over-push race between workers. Returns
  // false on stop.
  bool claim(long& ticket, long& epoch, long& step) {
    std::unique_lock<std::mutex> lk(mu_);
    space_cv_.wait(lk, [this] {
      return stop_ ||
             next_ticket_ - next_pop_ < static_cast<long>(queue_depth_);
    });
    if (stop_) return false;
    ticket = next_ticket_++;
    long steps = steps_per_epoch();
    epoch = ticket / steps;
    step = ticket % steps;
    return true;
  }

  long steps_per_epoch() const {
    return drop_last_ ? n_ / batch_ : (n_ + batch_ - 1) / batch_;
  }

  void fill_perm(std::vector<int>& perm, long epoch) {
    perm.resize(n_);
    for (int i = 0; i < n_; ++i) perm[i] = i;
    std::mt19937_64 rng(seed_ ^ (0x9e3779b97f4a7c15ULL * (epoch + 1)));
    for (int i = n_ - 1; i > 0; --i) {
      std::uniform_int_distribution<int> d(0, i);
      std::swap(perm[i], perm[d(rng)]);
    }
  }

  void work(int /*tid*/) {
    std::vector<int> perm;
    long cached_epoch = -1;
    while (true) {
      long ticket, epoch, step;
      if (!claim(ticket, epoch, step)) return;
      if (epoch != cached_epoch) {
        fill_perm(perm, epoch);
        cached_epoch = epoch;
      }
      Batch b;
      b.epoch = epoch;
      b.imgs.resize(static_cast<size_t>(batch_) * item_);
      b.masks.resize(static_cast<size_t>(batch_) * item_);
      for (int j = 0; j < batch_; ++j) {
        // wrap-pad the final short batch (static batch shapes)
        int pos = static_cast<int>((step * batch_ + j) % n_);
        int idx = perm[pos];
        std::memcpy(b.imgs.data() + static_cast<size_t>(j) * item_,
                    imgs_.data + static_cast<size_t>(idx) * item_, item_);
        std::memcpy(b.masks.data() + static_cast<size_t>(j) * item_,
                    masks_.data + static_cast<size_t>(idx) * item_, item_);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (stop_) return;
        done_.emplace(ticket, std::move(b));
      }
      ready_cv_.notify_all();
    }
  }

  const int n_;
  const size_t item_;
  const int batch_;
  const uint64_t seed_;
  const int queue_depth_;
  const bool drop_last_;
  const int num_threads_;

  MappedFile imgs_, masks_;
  std::vector<std::thread> workers_;
  std::map<long, Batch> done_;  // finished batches keyed by ticket
  std::mutex mu_;
  std::condition_variable ready_cv_, space_cv_;
  long next_ticket_ = 0;  // next slot to claim (guarded by mu_)
  long next_pop_ = 0;     // next ticket the consumer delivers
  bool stop_ = false;
};

#ifndef DDTI_NO_JPEG
// ---------------------------------------------------------------------------
// Native JPEG ingestion: decode grayscale + PIL-convention triangle-filter
// resize, parallel across threads. Replaces the PIL cold-start loop in
// ddti_tpu_torch.data.dataset.decode_to_store (the only remaining host hot path
// that wasn't native). libjpeg grayscale output takes the Y channel of
// YCbCr JPEGs directly — the same thing PIL's convert("L") yields for the
// grayscale-stored DDTI frames.

struct JpegErrorMgr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErrorMgr*>(cinfo->err)->jb, 1);
}

// Separable triangle-filter resample, matching PIL BILINEAR semantics:
// the filter support scales with the downscale factor (area-averaging),
// unlike naive bilinear sampling. float accumulation, round-half-up.
// Weight windows for one axis: bounds[o] = {xmin, count}, normalized.
struct ResampleWeights {
  std::vector<int> xmin, count;
  std::vector<float> w;  // ragged, offsets[o] indexes into it
  std::vector<size_t> off;

  void build(int len_in, int len_out) {
    const double scale = static_cast<double>(len_in) / len_out;
    const double fscale = scale < 1.0 ? 1.0 : scale;
    xmin.resize(len_out);
    count.resize(len_out);
    off.resize(len_out);
    w.clear();
    for (int o = 0; o < len_out; ++o) {
      const double center = (o + 0.5) * scale;
      int lo = static_cast<int>(center - fscale + 0.5);
      int hi = static_cast<int>(center + fscale + 0.5);
      if (lo < 0) lo = 0;
      if (hi > len_in) hi = len_in;
      off[o] = w.size();
      double total = 0.0;
      for (int x = lo; x < hi; ++x) {
        const double t = std::abs((x + 0.5 - center) / fscale);
        const double wgt = t < 1.0 ? 1.0 - t : 0.0;
        w.push_back(static_cast<float>(wgt));
        total += wgt;
      }
      if (total <= 0.0) {  // degenerate window: nearest sample
        w.resize(off[o]);
        int x = static_cast<int>(center);
        if (x >= len_in) x = len_in - 1;
        lo = x;
        hi = x + 1;
        w.push_back(1.0f);
        total = 1.0;
      }
      for (size_t k = off[o]; k < w.size(); ++k)
        w[k] = static_cast<float>(w[k] / total);
      xmin[o] = lo;
      count[o] = hi - lo;
    }
  }
};

static void resize_pil_bilinear(const std::vector<float>& src, int sh, int sw,
                                uint8_t* dst, int dh, int dw) {
  ResampleWeights wx, wy;
  wx.build(sw, dw);
  wy.build(sh, dh);
  // horizontal: contiguous tap reads per row
  std::vector<float> tmp(static_cast<size_t>(sh) * dw);
  for (int j = 0; j < sh; ++j) {
    const float* s = src.data() + static_cast<size_t>(j) * sw;
    float* d = tmp.data() + static_cast<size_t>(j) * dw;
    for (int o = 0; o < dw; ++o) {
      const float* wp = wx.w.data() + wx.off[o];
      const float* sp = s + wx.xmin[o];
      float acc = 0.f;
      for (int k = 0; k < wx.count[o]; ++k) acc += wp[k] * sp[k];
      d[o] = acc;
    }
  }
  // vertical: row-wise AXPY (vectorizes over the full output row)
  std::vector<float> row(dw);
  for (int o = 0; o < dh; ++o) {
    std::memset(row.data(), 0, sizeof(float) * dw);
    const float* wp = wy.w.data() + wy.off[o];
    for (int k = 0; k < wy.count[o]; ++k) {
      const float wk = wp[k];
      const float* s = tmp.data() +
          static_cast<size_t>(wy.xmin[o] + k) * dw;
      for (int x = 0; x < dw; ++x) row[x] += wk * s[x];
    }
    uint8_t* d = dst + static_cast<size_t>(o) * dw;
    for (int x = 0; x < dw; ++x) {
      float v = row[x] + 0.5f;
      if (v < 0.f) v = 0.f;
      if (v > 255.f) v = 255.f;
      d[x] = static_cast<uint8_t>(v);
    }
  }
}

// Decode one JPEG file to grayscale at native size; true on success.
static bool decode_one_jpeg(const char* path, std::vector<float>& pixels,
                            int& h, int& w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  // `row` is constructed BEFORE setjmp: a longjmp from mid-decode must not
  // jump over a live object's initialization (UB + leaked buffer); landing
  // back here with `row` already constructed lets its destructor run on
  // the normal error-return path below.
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  h = cinfo.output_height;
  w = cinfo.output_width;
  pixels.resize(static_cast<size_t>(h) * w);
  row.resize(w);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* out = pixels.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) out[x] = row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// Decode one in-memory JPEG to grayscale at native size; true on success.
static bool decode_one_jpeg_mem(const uint8_t* buf, size_t len,
                                std::vector<float>& pixels, int& h, int& w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  std::vector<uint8_t> row;  // constructed before setjmp (see file variant)
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  h = cinfo.output_height;
  w = cinfo.output_width;
  pixels.resize(static_cast<size_t>(h) * w);
  row.resize(w);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* out = pixels.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) out[x] = row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // DDTI_NO_JPEG

}  // namespace

extern "C" {

// 1 when the decode entry points below were built (libjpeg found), else 0.
int host_loader_has_jpeg() {
#ifdef DDTI_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

#ifndef DDTI_NO_JPEG
// Decode ONE in-memory JPEG to grayscale and resize to (h, w) with
// PIL-BILINEAR semantics (the serving daemon's per-request hot path —
// skips PIL entirely). Writes h*w bytes to ``out`` and the source
// dimensions to ``orig_h``/``orig_w``. Returns 1 on success, 0 on failure.
long decode_jpeg_mem(const uint8_t* buf, long len, int h, int w,
                     uint8_t* out, int* orig_h, int* orig_w) {
  std::vector<float> pixels;
  int sh = 0, sw = 0;
  if (!decode_one_jpeg_mem(buf, static_cast<size_t>(len), pixels, sh, sw))
    return 0;
  resize_pil_bilinear(pixels, sh, sw, out, h, w);
  *orig_h = sh;
  *orig_w = sw;
  return 1;
}

// Decode ``n`` NUL-separated JPEG paths to grayscale, resize each to
// (h, w) with PIL-BILINEAR semantics, and write them contiguously into
// ``out`` (n*h*w bytes). Parallel across ``num_threads``. Returns the
// number of successfully decoded images (== n on full success); failed
// slots are zero-filled.
long decode_jpegs(const char* paths, int n, int h, int w, uint8_t* out,
                  int num_threads) {
  std::vector<const char*> files;
  files.reserve(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files.push_back(p);
    p += std::strlen(p) + 1;
  }
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next{0}, ok{0};
  const size_t item = static_cast<size_t>(h) * w;
  auto worker = [&] {
    std::vector<float> pixels;
    int sh, sw;
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + static_cast<size_t>(i) * item;
      if (decode_one_jpeg(files[i], pixels, sh, sw)) {
        resize_pil_bilinear(pixels, sh, sw, dst, h, w);
        ok.fetch_add(1);
      } else {
        std::memset(dst, 0, item);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

#endif  // DDTI_NO_JPEG

void* loader_create(const char* imgs_path, const char* masks_path, int n,
                    int h, int w, int batch, uint64_t seed, int num_threads,
                    int queue_depth, int drop_last) {
  auto* l = new Loader(n, h, w, batch, seed, num_threads,
                       queue_depth < 1 ? 2 : queue_depth, drop_last != 0);
  if (!l->open(imgs_path, masks_path)) {
    delete l;
    return nullptr;
  }
  return l;
}

long loader_next(void* l, uint8_t* imgs_out, uint8_t* masks_out) {
  return static_cast<Loader*>(l)->next(imgs_out, masks_out);
}

void loader_destroy(void* l) { delete static_cast<Loader*>(l); }

}  // extern "C"
