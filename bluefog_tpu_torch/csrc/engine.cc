// Async host-op engine: tensor queue + background thread + handle manager.
//
// Reference parity:
//   * bluefog/common/tensor_queue.{h,cc} — mutex-protected FIFO between
//     frontend threads and the engine thread;
//   * bluefog/common/operations.cc BackgroundThreadLoop/RunLoopOnce — drain
//     the queue, execute, fire callbacks;
//   * bluefog/torch/handle_manager.{h,cc} — handle → status table with
//     PollHandle / WaitAndClear.
//
// Here the engine carries host async work: checkpoint IO, metric flushes,
// prefetch.  Callbacks are C function pointers; from Python they are ctypes
// trampolines (ctypes re-acquires the GIL on the engine thread, so Python
// callbacks are safe).

#include "bf_runtime.h"

#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace {

struct OpEntry {
  int handle;
  std::string op;
  std::string name;
  bf_callback cb;
  void* arg;
};

// Handle → status.  kPending marks in-flight ops.
constexpr int kPending = INT32_MIN;

class Engine {
 public:
  // Start/Shutdown are serialized on lifecycle_mu_ (held across the join):
  // a Start racing an in-progress Shutdown must block until the old Loop
  // thread has fully exited, else resetting shutdown_ would strand that
  // thread on queue_cv_ forever and Shutdown's join would never return.
  int Start() {
    std::lock_guard<std::mutex> lc(lifecycle_mu_);
    std::lock_guard<std::mutex> lock(mu_);
    if (running_) return 0;
    shutdown_ = false;
    running_ = true;
    thread_ = std::thread(&Engine::Loop, this);
    return 0;
  }

  int Shutdown() {
    std::lock_guard<std::mutex> lc(lifecycle_mu_);
    std::thread t;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (!running_) return 0;
      running_ = false;
      shutdown_ = true;
      t = std::move(thread_);
    }
    queue_cv_.notify_all();
    if (t.joinable()) t.join();
    return 0;
  }

  bool Running() {
    std::lock_guard<std::mutex> lock(mu_);
    return running_;
  }

  int Enqueue(const char* op, const char* name, bf_callback cb, void* arg) {
    std::lock_guard<std::mutex> lock(mu_);
    if (!running_ || shutdown_) return -1;
    int handle = next_handle_++;
    status_[handle] = kPending;
    queue_.push_back(OpEntry{handle, op ? op : "", name ? name : "", cb, arg});
    queue_cv_.notify_one();
    return handle;
  }

  int Poll(int handle) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = status_.find(handle);
    if (it == status_.end()) return -1;
    return it->second == kPending ? 0 : 1;
  }

  int Wait(int handle, int timeout_ms, int* status_out) {
    std::unique_lock<std::mutex> lock(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
    for (;;) {
      auto it = status_.find(handle);
      if (it == status_.end()) return -1;
      if (it->second != kPending) {
        if (status_out != nullptr) *status_out = it->second;
        return 0;
      }
      if (timeout_ms < 0) {
        done_cv_.wait(lock);
      } else if (done_cv_.wait_until(lock, deadline) ==
                 std::cv_status::timeout) {
        return -2;
      }
    }
  }

  void Clear(int handle) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = status_.find(handle);
    if (it != status_.end() && it->second != kPending) status_.erase(it);
  }

  int WaitAll(int timeout_ms) {
    std::unique_lock<std::mutex> lock(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
    for (;;) {
      if (PendingLocked() == 0) return 0;
      if (timeout_ms < 0) {
        done_cv_.wait(lock);
      } else if (done_cv_.wait_until(lock, deadline) ==
                 std::cv_status::timeout) {
        return -2;
      }
    }
  }

  int PendingCount() {
    std::lock_guard<std::mutex> lock(mu_);
    return PendingLocked();
  }

 private:
  // Pending = queued + currently executing (both still hold kPending status).
  int PendingLocked() {
    int n = 0;
    for (const auto& kv : status_) {
      if (kv.second == kPending) ++n;
    }
    return n;
  }

  // RunLoopOnce, looped: pop → timeline span → execute → mark done.
  void Loop() {
    std::unique_lock<std::mutex> lock(mu_);
    for (;;) {
      queue_cv_.wait(lock, [this] { return shutdown_ || !queue_.empty(); });
      if (queue_.empty() && shutdown_) break;  // drain before exit
      OpEntry entry = std::move(queue_.front());
      queue_.pop_front();
      lock.unlock();

      std::string span = entry.op + "/" + entry.name;
      bf_timeline_async_begin(span.c_str(), "host_op", entry.handle);
      int status = 0;
      if (entry.cb != nullptr) status = entry.cb(entry.arg);
      bf_timeline_async_end(span.c_str(), "host_op", entry.handle);

      lock.lock();
      status_[entry.handle] = status == kPending ? kPending + 1 : status;
      done_cv_.notify_all();
    }
  }

  std::mutex lifecycle_mu_;
  std::mutex mu_;
  std::condition_variable queue_cv_;
  std::condition_variable done_cv_;
  std::deque<OpEntry> queue_;
  std::unordered_map<int, int> status_;
  std::thread thread_;
  int next_handle_ = 0;
  bool running_ = false;
  bool shutdown_ = false;
};

Engine& GetEngine() {
  static Engine* e = new Engine();
  return *e;
}

}  // namespace

extern "C" {

int bf_engine_start() { return GetEngine().Start(); }
int bf_engine_shutdown() { return GetEngine().Shutdown(); }
int bf_engine_running() { return GetEngine().Running() ? 1 : 0; }

int bf_enqueue(const char* op, const char* name, bf_callback cb, void* arg) {
  return GetEngine().Enqueue(op, name, cb, arg);
}

int bf_poll(int handle) { return GetEngine().Poll(handle); }
int bf_wait(int handle, int timeout_ms, int* status_out) {
  return GetEngine().Wait(handle, timeout_ms, status_out);
}
void bf_clear(int handle) { GetEngine().Clear(handle); }
int bf_wait_all(int timeout_ms) { return GetEngine().WaitAll(timeout_ms); }
int bf_pending_count() { return GetEngine().PendingCount(); }

}  // extern "C"
