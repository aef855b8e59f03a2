// Native data-pipeline runtime: threaded batch gather + bounded prefetch
// queue.
//
// Role in the framework: the input pipeline is the usual bottleneck for DP
// scaling efficiency (SURVEY.md §7 "hard parts" — per-host sharded input),
// and the reference's data path (a pure index remap, reference
// src/data.jl:24-26) leaves batch assembly to the host language. Here batch
// assembly — gathering scattered sample rows into one contiguous host
// buffer ready for device transfer — is done by a C++ thread pool, with a
// bounded producer/consumer queue so the next batches are being assembled
// while the device runs the current step.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image):
//   fm_gather        — one multithreaded gather of rows into a buffer
//   fm_prefetch_*    — bounded-queue prefetcher over an epoch's index order
//
// All pointers reference caller-owned numpy buffers; the library never
// allocates Python-visible memory.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

void gather_range(const uint8_t* src, uint64_t row_bytes, const int64_t* idx,
                  uint64_t begin, uint64_t end, uint8_t* dst) {
  for (uint64_t i = begin; i < end; ++i) {
    std::memcpy(dst + i * row_bytes, src + static_cast<uint64_t>(idx[i]) * row_bytes,
                row_bytes);
  }
}

void gather_mt(const uint8_t* src, uint64_t row_bytes, const int64_t* idx,
               uint64_t n, uint8_t* dst, int n_threads) {
  if (n_threads <= 1 || n < 64) {
    gather_range(src, row_bytes, idx, 0, n, dst);
    return;
  }
  std::vector<std::thread> workers;
  uint64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    uint64_t begin = static_cast<uint64_t>(t) * chunk;
    if (begin >= n) break;
    uint64_t end = begin + chunk < n ? begin + chunk : n;
    workers.emplace_back(gather_range, src, row_bytes, idx, begin, end, dst);
  }
  for (auto& w : workers) w.join();
}

struct Batch {
  std::vector<uint8_t> data;
  int64_t batch_index;
};

// Persistent worker pool: the per-batch gather cost must be the memcpy, not
// thread create/join churn — with small batches transient threads would
// dominate.
class GatherPool {
 public:
  explicit GatherPool(int n_workers) : n_(n_workers > 1 ? n_workers : 0) {
    for (int i = 0; i < n_; ++i) {
      workers_.emplace_back([this, i] { worker_loop(i); });
    }
  }

  ~GatherPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      shutdown_ = true;
      ++generation_;
    }
    cv_work_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void gather(const uint8_t* src, uint64_t row_bytes, const int64_t* idx,
              uint64_t n, uint8_t* dst) {
    if (n_ == 0 || n < 64) {
      gather_range(src, row_bytes, idx, 0, n, dst);
      return;
    }
    {
      std::lock_guard<std::mutex> lock(mu_);
      src_ = src;
      row_bytes_ = row_bytes;
      idx_ = idx;
      n_rows_ = n;
      dst_ = dst;
      remaining_ = n_;
      ++generation_;
    }
    cv_work_.notify_all();
    std::unique_lock<std::mutex> lock(mu_);
    cv_done_.wait(lock, [&] { return remaining_ == 0; });
  }

 private:
  void worker_loop(int me) {
    uint64_t seen = 0;
    while (true) {
      std::unique_lock<std::mutex> lock(mu_);
      cv_work_.wait(lock, [&] { return generation_ != seen; });
      seen = generation_;
      if (shutdown_) return;
      const uint8_t* src = src_;
      uint64_t row_bytes = row_bytes_;
      const int64_t* idx = idx_;
      uint64_t n = n_rows_;
      uint8_t* dst = dst_;
      lock.unlock();

      uint64_t chunk = (n + n_ - 1) / n_;
      uint64_t begin = static_cast<uint64_t>(me) * chunk;
      uint64_t end = begin + chunk < n ? begin + chunk : n;
      if (begin < n) gather_range(src, row_bytes, idx, begin, end, dst);

      lock.lock();
      if (--remaining_ == 0) cv_done_.notify_all();
    }
  }

  const int n_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  uint64_t generation_ = 0;
  bool shutdown_ = false;
  const uint8_t* src_ = nullptr;
  uint64_t row_bytes_ = 0;
  const int64_t* idx_ = nullptr;
  uint64_t n_rows_ = 0;
  uint8_t* dst_ = nullptr;
  int remaining_ = 0;
};

struct Prefetcher {
  const uint8_t* src;
  uint64_t row_bytes;
  std::vector<int64_t> order;   // epoch index order (copied in)
  uint64_t batch_rows;
  uint64_t n_batches;
  int gather_threads;
  std::unique_ptr<GatherPool> pool;

  std::deque<Batch> queue;
  uint64_t next_batch = 0;      // next batch index the producer will build
  uint64_t completed = 0;       // batches fully built and enqueued
  std::mutex mu;
  std::condition_variable cv_can_produce;
  std::condition_variable cv_can_consume;
  uint64_t capacity;
  std::atomic<bool> stop{false};
  std::thread producer;

  void run() {
    while (true) {
      uint64_t b;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_can_produce.wait(lock, [&] {
          return stop.load() || (queue.size() < capacity && next_batch < n_batches);
        });
        if (stop.load() || next_batch >= n_batches) return;
        b = next_batch++;
      }
      Batch batch;
      batch.batch_index = static_cast<int64_t>(b);
      batch.data.resize(batch_rows * row_bytes);
      pool->gather(src, row_bytes, order.data() + b * batch_rows, batch_rows,
                   batch.data.data());
      {
        std::lock_guard<std::mutex> lock(mu);
        queue.push_back(std::move(batch));
        ++completed;
      }
      cv_can_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// One-shot multithreaded gather: dst[i] = src[idx[i]] for row-sized rows.
void fm_gather(const uint8_t* src, uint64_t row_bytes, const int64_t* idx,
               uint64_t n, uint8_t* dst, int n_threads) {
  gather_mt(src, row_bytes, idx, n, dst, n_threads);
}

// Bounded-queue prefetcher over a fixed epoch order.
void* fm_prefetch_create(const uint8_t* src, uint64_t row_bytes,
                         const int64_t* order, uint64_t n_rows,
                         uint64_t batch_rows, uint64_t queue_capacity,
                         int gather_threads) {
  if (batch_rows == 0 || row_bytes == 0) return nullptr;
  auto* p = new Prefetcher();
  p->src = src;
  p->row_bytes = row_bytes;
  p->order.assign(order, order + n_rows);
  p->batch_rows = batch_rows;
  p->n_batches = n_rows / batch_rows;  // drop_last semantics
  p->capacity = queue_capacity ? queue_capacity : 2;
  p->gather_threads = gather_threads > 0 ? gather_threads : 1;
  p->pool.reset(new GatherPool(p->gather_threads));
  p->producer = std::thread(&Prefetcher::run, p);
  return p;
}

// Blocks until the next batch is ready; copies it into dst and returns its
// batch index, or -1 when the epoch is exhausted.
int64_t fm_prefetch_next(void* handle, uint8_t* dst) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv_can_consume.wait(lock, [&] {
    return !p->queue.empty() || p->completed == p->n_batches ||
           p->stop.load();
  });
  if (p->queue.empty()) return -1;
  Batch batch = std::move(p->queue.front());
  p->queue.pop_front();
  lock.unlock();
  p->cv_can_produce.notify_one();
  std::memcpy(dst, batch.data.data(), batch.data.size());
  return batch.batch_index;
}

void fm_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    // Set under the mutex: a producer between its predicate check and its
    // wait would otherwise miss this wake-up and the join below would hang.
    std::lock_guard<std::mutex> lock(p->mu);
    p->stop.store(true);
  }
  p->cv_can_produce.notify_all();
  p->cv_can_consume.notify_all();
  if (p->producer.joinable()) p->producer.join();
  delete p;
}

}  // extern "C"
