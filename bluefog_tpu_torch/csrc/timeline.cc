// Chrome-trace timeline writer on a dedicated thread.
//
// Reference parity: bluefog/common/timeline.{h,cc} — a writer thread consumes
// queued events and emits chrome://tracing JSON; events are recorded from the
// op engine at state transitions and from user span APIs.
// Same design here: record() is lock-cheap (mutex push onto a vector); the
// writer thread drains every ~100ms and appends serialized events to the file.
// The file is a valid trace-event JSON array; chrome/Perfetto also accept a
// truncated array if the process dies mid-run.

#include "bf_runtime.h"

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Event {
  std::string name;
  std::string cat;
  char ph;         // 'B','E','i','b','e'
  int64_t ts_us;
  int64_t tid;     // thread id or async span id
};

class TimelineWriter {
 public:
  bool Start(const std::string& path) {
    std::lock_guard<std::mutex> lock(mu_);
    if (file_ != nullptr) return false;
    file_ = std::fopen(path.c_str(), "w");
    if (file_ == nullptr) return false;
    std::fputs("[\n", file_);
    first_ = true;
    t0_ = Clock::now();
    stop_ = false;
    thread_ = std::thread(&TimelineWriter::Loop, this);
    return true;
  }

  void Stop() {
    // Move the thread out under the lock: concurrent Stop calls must not
    // both join it (double-join would std::terminate).
    std::thread t;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (file_ == nullptr || stop_) return;
      stop_ = true;
      t = std::move(thread_);
    }
    cv_.notify_all();
    if (t.joinable()) t.join();
    std::lock_guard<std::mutex> lock(mu_);
    if (file_ == nullptr) return;
    Drain();
    std::fputs("\n]\n", file_);
    std::fclose(file_);
    file_ = nullptr;
  }

  bool Active() {
    std::lock_guard<std::mutex> lock(mu_);
    return file_ != nullptr;
  }

  void Record(const char* name, const char* cat, char ph, int64_t tid) {
    std::lock_guard<std::mutex> lock(mu_);
    if (file_ == nullptr) return;
    int64_t ts = std::chrono::duration_cast<std::chrono::microseconds>(
                     Clock::now() - t0_)
                     .count();
    pending_.push_back(Event{name ? name : "", cat ? cat : "", ph, ts, tid});
    if (pending_.size() >= 4096) cv_.notify_all();
  }

 private:
  void Loop() {
    std::unique_lock<std::mutex> lock(mu_);
    while (!stop_) {
      cv_.wait_for(lock, std::chrono::milliseconds(100));
      // Swap the backlog out and release mu_ before serializing/writing so
      // Record() never blocks on disk latency (the op-engine thread records
      // spans on its critical path).  file_/first_ are touched only by this
      // thread while it runs, and by Stop() strictly after joining it.
      std::vector<Event> batch;
      batch.swap(pending_);
      lock.unlock();
      WriteBatch(batch);
      lock.lock();
    }
  }

  // Requires mu_ held; only called from Stop() after the writer thread has
  // been joined (final flush).
  void Drain() {
    std::vector<Event> batch;
    batch.swap(pending_);
    WriteBatch(batch);
  }

  void WriteBatch(const std::vector<Event>& batch) {
    if (file_ == nullptr || batch.empty()) return;
    std::string out;
    out.reserve(batch.size() * 96);
    char buf[64];
    for (const Event& e : batch) {
      if (!first_) out += ",\n";
      first_ = false;
      out += "{\"name\":\"";
      AppendEscaped(&out, e.name);
      out += "\",\"cat\":\"";
      AppendEscaped(&out, e.cat);
      out += "\",\"ph\":\"";
      out += e.ph;
      out += "\",\"ts\":";
      std::snprintf(buf, sizeof(buf), "%lld", (long long)e.ts_us);
      out += buf;
      out += ",\"pid\":0";
      if (e.ph == 'b' || e.ph == 'e') {
        std::snprintf(buf, sizeof(buf), ",\"id\":%lld", (long long)e.tid);
        out += buf;
        out += ",\"tid\":0";
      } else {
        std::snprintf(buf, sizeof(buf), ",\"tid\":%lld", (long long)e.tid);
        out += buf;
      }
      if (e.ph == 'i') out += ",\"s\":\"p\"";
      out += "}";
    }
    std::fputs(out.c_str(), file_);
    std::fflush(file_);
  }

  static void AppendEscaped(std::string* out, const std::string& s) {
    for (char c : s) {
      if (c == '"' || c == '\\') {
        out->push_back('\\');
        out->push_back(c);
      } else if (static_cast<unsigned char>(c) >= 0x20) {
        out->push_back(c);
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::thread thread_;
  std::FILE* file_ = nullptr;
  bool first_ = true;
  bool stop_ = false;
  Clock::time_point t0_;
  std::vector<Event> pending_;
};

TimelineWriter& Writer() {
  static TimelineWriter* w = new TimelineWriter();
  return *w;
}

}  // namespace

extern "C" {

int bf_timeline_start(const char* path) {
  if (path == nullptr) return -1;
  return Writer().Start(path) ? 0 : -1;
}

int bf_timeline_stop() {
  Writer().Stop();
  return 0;
}

int bf_timeline_active() { return Writer().Active() ? 1 : 0; }

void bf_timeline_begin(const char* name, const char* cat, int64_t tid) {
  Writer().Record(name, cat, 'B', tid);
}

void bf_timeline_end(const char* name, const char* cat, int64_t tid) {
  Writer().Record(name, cat, 'E', tid);
}

void bf_timeline_instant(const char* name, const char* cat) {
  Writer().Record(name, cat, 'i', 0);
}

void bf_timeline_async_begin(const char* name, const char* cat, int64_t id) {
  Writer().Record(name, cat, 'b', id);
}

void bf_timeline_async_end(const char* name, const char* cat, int64_t id) {
  Writer().Record(name, cat, 'e', id);
}

}  // extern "C"
