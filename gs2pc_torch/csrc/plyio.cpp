// Native PLY expand-writer -- the port's copy of the JAX package's
// gs2pc/native/plyio.cpp (gs2pc_write_ply_expand and what it uses).
//
// Interleaves float positions (and per-Gaussian normals) with per-Gaussian
// uint8 colours into PLY vertex records and streams them to disk with a
// dedicated writer thread, so packing and writing overlap.  Layout is
// byte-identical to the numpy writer of gs2pc_torch/io/ply.py.  Built with
// g++ at first use (gs2pc_torch/ops/cuda_build.py::load_plyio) and called
// through ctypes; no pybind11 dependency.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Direct-IO sink: a large file written through the page cache can be
// throttled by dirty-page writeback, so bytes are staged in an aligned
// buffer and flushed with O_DIRECT in aligned block writes (plain writes
// where O_DIRECT is refused); the final tail is written after clearing
// O_DIRECT.
class DirectSink {
 public:
  static constexpr size_t kAlign = 4096;
  static constexpr size_t kBuf = 8 << 20;

  explicit DirectSink(const char* path) : fd_(-1), fill_(0), buf_(nullptr) {
#ifdef O_DIRECT
    fd_ = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_DIRECT, 0644);
    direct_ = fd_ >= 0;
#endif
    if (fd_ < 0) {
      fd_ = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
      direct_ = false;
    }
    if (fd_ >= 0 && posix_memalign(&buf_, kAlign, kBuf) != 0) buf_ = nullptr;
    if (fd_ >= 0 && buf_ == nullptr) {
      ::close(fd_);
      fd_ = -1;
    }
  }

  ~DirectSink() {
    if (buf_ != nullptr) free(buf_);
    if (fd_ >= 0) ::close(fd_);
  }

  bool ok() const { return fd_ >= 0; }

  bool Write(const char* data, size_t n) {
    while (n > 0) {
      const size_t take = n < kBuf - fill_ ? n : kBuf - fill_;
      std::memcpy(static_cast<char*>(buf_) + fill_, data, take);
      fill_ += take;
      data += take;
      n -= take;
      if (fill_ == kBuf) {
        if (::write(fd_, buf_, kBuf) != static_cast<ssize_t>(kBuf))
          return false;
        fill_ = 0;
      }
    }
    return true;
  }

  bool Close() {
    if (fd_ < 0) return false;
    bool ok = true;
    const size_t aligned = fill_ - (fill_ % kAlign);
    if (aligned > 0) {
      ok = ::write(fd_, buf_, aligned) == static_cast<ssize_t>(aligned);
    }
    const size_t rem = fill_ - aligned;
    if (ok && rem > 0) {
#ifdef O_DIRECT
      if (direct_) {
        const int fl = fcntl(fd_, F_GETFL);
        fcntl(fd_, F_SETFL, fl & ~O_DIRECT);
      }
#endif
      ok = ::write(fd_, static_cast<char*>(buf_) + aligned, rem) ==
           static_cast<ssize_t>(rem);
    }
    ok = (::close(fd_) == 0) && ok;
    fd_ = -1;
    return ok;
  }

 private:
  int fd_;
  size_t fill_;
  void* buf_;
  bool direct_;
};

struct Chunk {
  std::vector<char> data;
};

class StreamWriter {
 public:
  explicit StreamWriter(DirectSink* f) : f_(f), done_(false), error_(false) {
    worker_ = std::thread([this] { this->Run(); });
  }

  ~StreamWriter() { Finish(); }

  void Push(std::vector<char>&& data) {
    std::unique_lock<std::mutex> lock(mu_);
    // Bound the queue so we never hold more than ~4 chunks in flight.
    cv_space_.wait(lock, [this] { return queue_.size() < 4 || error_; });
    queue_.push_back(Chunk{std::move(data)});
    cv_data_.notify_one();
  }

  bool Finish() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      if (done_) return !error_;
      done_ = true;
      cv_data_.notify_one();
    }
    worker_.join();
    return !error_;
  }

 private:
  void Run() {
    for (;;) {
      Chunk chunk;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_data_.wait(lock, [this] { return !queue_.empty() || done_; });
        if (queue_.empty() && done_) return;
        chunk = std::move(queue_.front());
        queue_.erase(queue_.begin());
        cv_space_.notify_one();
      }
      if (!error_ && !f_->Write(chunk.data.data(), chunk.data.size())) {
        error_ = true;
      }
    }
  }

  DirectSink* f_;
  std::vector<Chunk> queue_;
  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::thread worker_;
  bool done_;
  std::atomic<bool> error_;
};

// The PLY header of `total` vertices, with or without normals.
bool WriteHeader(DirectSink* sink, int64_t total, bool with_normals) {
  char header[512];
  int hlen;
  if (with_normals) {
    hlen = snprintf(header, sizeof(header),
                    "ply\nformat binary_little_endian 1.0\n"
                    "element vertex %lld\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property float nx\nproperty float ny\nproperty float nz\n"
                    "property uchar red\nproperty uchar green\nproperty uchar "
                    "blue\nend_header\n",
                    static_cast<long long>(total));
  } else {
    hlen = snprintf(header, sizeof(header),
                    "ply\nformat binary_little_endian 1.0\n"
                    "element vertex %lld\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\nproperty uchar "
                    "blue\nend_header\n",
                    static_cast<long long>(total));
  }
  return sink->Write(header, static_cast<size_t>(hlen));
}

// Vertex records of rows [lo, hi): positions from `pts` (row `lo` first),
// colours and normals of each row's Gaussian, the last g with
// offs[g] <= row.  The pack threads are joined before it returns, so `pts`
// is no longer read once it has.
std::vector<char> PackRows(const float* pts, int64_t lo, int64_t hi,
                           const int64_t* offs /* (P + 1,) */, int64_t P,
                           const uint8_t* cols, const float* normals) {
  const size_t stride = (normals != nullptr) ? 27 : 15;
  std::vector<char> buf(static_cast<size_t>(hi - lo) * stride);
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t n_pack_threads = hw > 2 ? hw - 1 : 1;
  const int64_t rows = hi - lo;
  const int64_t per = (rows + n_pack_threads - 1) / n_pack_threads;
  std::vector<std::thread> packers;
  for (int64_t t = 0; t < n_pack_threads; ++t) {
    const int64_t a = lo + t * per;
    const int64_t b = (a + per < hi) ? a + per : hi;
    if (a >= b) break;
    packers.emplace_back([&, a, b] {
      int64_t g = std::upper_bound(offs, offs + P + 1, a) - offs - 1;
      for (int64_t i = a; i < b; ++i) {
        while (g + 1 <= P && offs[g + 1] <= i) ++g;
        char* rec = buf.data() + (i - lo) * stride;
        std::memcpy(rec, pts + 3 * (i - lo), 12);
        size_t off = 12;
        if (normals != nullptr) {
          std::memcpy(rec + off, normals + 3 * g, 12);
          off += 12;
        }
        std::memcpy(rec + off, cols + 3 * g, 3);
      }
    });
  }
  for (auto& th : packers) th.join();
  return buf;
}

// A chunked write: the header at open, rows in order by chunk, the writer
// thread draining packed chunks to the sink meanwhile.
struct Session {
  explicit Session(const char* path) : sink(path) {}
  DirectSink sink;
  StreamWriter* writer = nullptr;
  int64_t total = 0;
  int64_t written = 0;
  bool with_normals = false;
  bool ok = true;
};

}  // namespace

extern "C" {

// Expand-and-write: points are per-POINT rows, colours/normals are
// per-GAUSSIAN planes repeated by `counts` (the point cloud's
// row-repeat semantics -- slot-major sampler order).  Doing the expansion
// inside the pack threads removes the host gather/pack that otherwise
// sits serially before the write (numpy writer:
// gs2pc_torch/io/ply.py::save_point_cloud_ply).  Returns 0 on success,
// a negative code otherwise.
int gs2pc_write_ply_expand(const char* path, int64_t total,
                           const float* pts /* (total, 3) */,
                           const int64_t* counts /* (P,) */, int64_t P,
                           const uint8_t* cols /* (P, 3) */,
                           const float* normals /* (P, 3), nullable */,
                           int64_t chunk_size) {
  if (total < 0 || pts == nullptr || counts == nullptr || cols == nullptr)
    return -1;
  DirectSink sink(path);
  if (!sink.ok()) return -2;
  if (!WriteHeader(&sink, total, normals != nullptr)) return -3;

  // Prefix offsets so each pack thread can binary-search its start row.
  std::vector<int64_t> offs(static_cast<size_t>(P) + 1);
  offs[0] = 0;
  for (int64_t i = 0; i < P; ++i) offs[i + 1] = offs[i] + counts[i];

  if (chunk_size <= 0) chunk_size = 1 << 20;

  bool ok = true;
  {
    StreamWriter writer(&sink);
    for (int64_t lo = 0; lo < total; lo += chunk_size) {
      const int64_t hi = lo + chunk_size < total ? lo + chunk_size : total;
      writer.Push(PackRows(pts + 3 * lo, lo, hi, offs.data(), P, cols, normals));
    }
    ok = writer.Finish();
  }
  ok = sink.Close() && ok;
  return ok ? 0 : -4;
}

// The same records written chunk by chunk, for points that reach the host
// a chunk at a time (gs2pc_torch/pipeline.py::LazyPointCloud): open writes
// the header and returns a handle (NULL on failure); each write_chunk packs
// rows [lo, hi), which must follow the rows written before, and queues
// them on the writer thread; close waits for the writes, checks that all
// `total` rows came, frees the handle and returns 0 or a negative code.
void* gs2pc_ply_open(const char* path, int64_t total, int with_normals) {
  if (total < 0) return nullptr;
  Session* s = new Session(path);
  if (!s->sink.ok() || !WriteHeader(&s->sink, total, with_normals != 0)) {
    delete s;
    return nullptr;
  }
  s->total = total;
  s->with_normals = with_normals != 0;
  s->writer = new StreamWriter(&s->sink);
  return s;
}

// Returns only after it has read every row of `pts` (rows lo..hi-1, row lo
// first), so the caller may then reuse that buffer.  0 on success, a
// negative code otherwise (the session then stays failed).
int gs2pc_ply_write_chunk(void* handle, const float* pts, int64_t lo, int64_t hi,
                          const int64_t* offs /* (P + 1,) */, int64_t P,
                          const uint8_t* cols /* (P, 3) */,
                          const float* normals /* (P, 3), nullable */) {
  Session* s = static_cast<Session*>(handle);
  if (s == nullptr || !s->ok) return -1;
  if (pts == nullptr || offs == nullptr || cols == nullptr || lo != s->written ||
      hi < lo || hi > s->total || (normals != nullptr) != s->with_normals) {
    s->ok = false;
    return -1;
  }
  if (hi > lo) s->writer->Push(PackRows(pts, lo, hi, offs, P, cols, normals));
  s->written = hi;
  return 0;
}

int gs2pc_ply_close(void* handle) {
  Session* s = static_cast<Session*>(handle);
  if (s == nullptr) return -1;
  bool ok = s->writer->Finish() && s->ok && s->written == s->total;
  delete s->writer;
  ok = s->sink.Close() && ok;
  delete s;
  return ok ? 0 : -4;
}

}  // extern "C"
