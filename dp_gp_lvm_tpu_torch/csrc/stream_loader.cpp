// Native streaming minibatch loader: mmap'd row-major float32 matrix
// plus an asynchronous gather worker.
//
// The big-N training paths (models/svi_gplvm.py) consume O(batch) rows
// a step, so a dataset only needs to be host-addressable, not resident on
// the card or even in the process's memory. This loader mmaps the data
// file (the kernel pages rows in on demand and may drop them under
// pressure) and gathers the next chunk's minibatch rows on a C++ worker
// thread that runs without the GIL, overlapping the host gather with the
// card's work. The caller's buffer may be pinned host memory, from which
// the copy to the card is asynchronous. Python bindings:
// dp_gp_lvm_tpu_torch/data/stream.py (ctypes); built there by g++ at
// first use.
//
// Plain C ABI, one outstanding request per handle (the Python side
// double-buffers):
//   sl_open(path, n, d)            -> handle (NULL on failure)
//   sl_request(h, idx, count, out) -> 0, starts async gather of rows
//                                     idx[0..count) into out (count*d
//                                     floats, caller-owned)
//   sl_wait(h)                     -> 0 ok / <0 error; blocks until the
//                                     outstanding gather completes
//   sl_rows(h), sl_dims(h)         -> matrix shape
//   sl_close(h)                    -> joins the worker, unmaps, frees
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
  const float* data = nullptr;   // mmap'd n*d float32, row-major
  size_t map_bytes = 0;
  int64_t n = 0;
  int64_t d = 0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;
  bool job_pending = false;      // a request is queued or running
  bool job_done = false;         // last request finished
  int job_status = 0;            // 0 ok, <0 error (bad index)
  std::vector<int32_t> idx;      // queued request: indices copy
  float* out = nullptr;          // queued request: caller buffer

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return stop || job_pending; });
      if (stop) return;
      // take the job, release the lock for the gather itself
      std::vector<int32_t> local_idx;
      local_idx.swap(idx);
      float* local_out = out;
      lk.unlock();

      int status = 0;
      const size_t row_bytes = static_cast<size_t>(d) * sizeof(float);
      for (size_t i = 0; i < local_idx.size(); ++i) {
        const int64_t r = local_idx[i];
        if (r < 0 || r >= n) { status = -2; break; }
        std::memcpy(local_out + i * static_cast<size_t>(d),
                    data + r * d, row_bytes);
      }

      lk.lock();
      job_pending = false;
      job_done = true;
      job_status = status;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* sl_open(const char* path, int64_t n, int64_t d) {
  if (n <= 0 || d <= 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  const size_t need = static_cast<size_t>(n) * d * sizeof(float);
  if (static_cast<size_t>(st.st_size) < need) { ::close(fd); return nullptr; }
  void* p = ::mmap(nullptr, need, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);  // mapping keeps its own reference
  if (p == MAP_FAILED) return nullptr;
  // rows are gathered in random order — disable kernel readahead runs
  ::madvise(p, need, MADV_RANDOM);

  Loader* h = new Loader();
  h->data = static_cast<const float*>(p);
  h->map_bytes = need;
  h->n = n;
  h->d = d;
  h->worker = std::thread([h] { h->run(); });
  return h;
}

int sl_request(void* vh, const int32_t* idx, int64_t count, float* out) {
  Loader* h = static_cast<Loader*>(vh);
  if (!h || count < 0) return -1;
  std::unique_lock<std::mutex> lk(h->mu);
  if (h->job_pending) return -3;   // protocol: one outstanding request
  h->idx.assign(idx, idx + count);
  h->out = out;
  h->job_pending = true;
  h->job_done = false;
  h->cv.notify_all();
  return 0;
}

int sl_wait(void* vh) {
  Loader* h = static_cast<Loader*>(vh);
  if (!h) return -1;
  std::unique_lock<std::mutex> lk(h->mu);
  h->cv.wait(lk, [&] { return h->job_done || !h->job_pending; });
  return h->job_done ? h->job_status : 0;
}

int64_t sl_rows(void* vh) { return static_cast<Loader*>(vh)->n; }
int64_t sl_dims(void* vh) { return static_cast<Loader*>(vh)->d; }

void sl_close(void* vh) {
  Loader* h = static_cast<Loader*>(vh);
  if (!h) return;
  {
    std::unique_lock<std::mutex> lk(h->mu);
    h->stop = true;
    h->cv.notify_all();
  }
  if (h->worker.joinable()) h->worker.join();
  if (h->data) ::munmap(const_cast<float*>(h->data), h->map_bytes);
  delete h;
}

}  // extern "C"
