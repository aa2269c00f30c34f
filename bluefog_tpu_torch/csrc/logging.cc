// Leveled logging (reference parity: bluefog/common/logging.{h,cc} —
// BFLOG macros + BLUEFOG_LOG_LEVEL env;).

#include "bf_runtime.h"

#include <atomic>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <mutex>
#include <string>

namespace {

const char* kLevelNames[] = {"TRACE", "DEBUG", "INFO", "WARN", "ERROR", "OFF"};

// Case-insensitive, matching the Python logger's accepted level names
// (utils/logging.py); "fatal" disables everything we emit
// (we log nothing above error), same as "off".
int LevelFromEnv() {
  const char* env = std::getenv("BLUEFOG_TPU_LOG_LEVEL");
  if (env == nullptr) return 3;  // default: warn
  std::string s(env);
  for (char& c : s) c = static_cast<char>(std::tolower(c));
  if (s == "trace") return 0;
  if (s == "debug") return 1;
  if (s == "info") return 2;
  if (s == "warn" || s == "warning") return 3;
  if (s == "error") return 4;
  if (s == "fatal" || s == "off") return 5;
  char* end = nullptr;
  long v = std::strtol(env, &end, 10);
  if (end != env && v >= 0 && v <= 5) return static_cast<int>(v);
  return 3;
}

std::atomic<int> g_level{LevelFromEnv()};
std::mutex g_io_mutex;

}  // namespace

extern "C" {

int bf_log_level() { return g_level.load(std::memory_order_relaxed); }

void bf_set_log_level(int level) {
  if (level < 0) level = 0;
  if (level > 5) level = 5;
  g_level.store(level, std::memory_order_relaxed);
}

void bf_log(int level, const char* msg) {
  if (level < bf_log_level() || level > 4 || msg == nullptr) return;
  std::timespec ts{};
  std::timespec_get(&ts, TIME_UTC);
  std::tm tm_buf{};
  gmtime_r(&ts.tv_sec, &tm_buf);
  std::lock_guard<std::mutex> lock(g_io_mutex);
  std::fprintf(stderr, "[%02d:%02d:%02d.%03ld][BF][%s] %s\n", tm_buf.tm_hour,
               tm_buf.tm_min, tm_buf.tm_sec, ts.tv_nsec / 1000000,
               kLevelNames[level], msg);
}

}  // extern "C"
