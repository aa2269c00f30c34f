// Passive-target window table: host-memory landing buffers for one-sided ops.
//
// Reference parity (upstream-relative):
//   * bluefog/torch/mpi_win_ops.cc WinTorchStorageManager — per-tensor self
//     buffer + one landing buffer per in-neighbor, backed by MPI_Win memory;
//   * bluefog/common/mpi_controller.cc WinPut/WinAccumulate/WinUpdate —
//     MPI_Put/MPI_Accumulate land with NO receiver involvement; the receiver
//     merges whatever has arrived whenever it chooses.
//
// This is the host table of the port's asynchronous runners
// (runtime/async_windows.py): within a process, rank threads deposit into
// each other's entries; across processes on a host the same table rides
// named POSIX shared memory.  Ranks running at different speeds deposit
// into and consume from these buffers with no rendezvous.  The shm names
// carry the prefix "/bftwin_" (the JAX package's table uses "/bfwin_"), so
// the two libraries never attach to each other's segments.
//
// Memory design — ONE segment layout for every backing:
//   [WinHdr | SlotHdr x n_slots | self_buf | slot_buf x n_slots]
//   * process-local windows (bf_win_create) place it in an anonymous
//     private mapping — the rank-*thread* model;
//   * cross-process windows (bf_win_create_shm / bf_win_attach_shm) place
//     the SAME layout in a named shm object (/dev/shm), so a deposit from
//     another OS process lands in the owner's window with no receiver
//     involvement — the MPI_Put-across-process-boundaries semantic.
//
// Concurrency design:
//   * per-slot PROCESS-SHARED ROBUST pthread mutex living inside the
//     segment, held only for the memcpy/add — writers never wait for
//     readers to *run*, only for a bounded copy (MPI implementations
//     serialize accumulates on the target window the same way).  Robustness:
//     if a depositing process dies holding a slot lock, the next locker gets
//     EOWNERDEAD, marks the mutex consistent, and proceeds (the MPI
//     failure-semantics analog; the torn payload, if any, is bounded to one
//     slot and surfaced by the deposit counter);
//   * deposits carry a version count; readers see how many deposits landed
//     since their last consume (staleness is observable, as with
//     MPI_Win_flush bookkeeping);
//   * consume=1 zero-fills after read — push-sum mass is consumed exactly
//     once even when reader and writers race (swap under the slot lock);
//   * the owner publishes the segment by storing a magic word LAST
//     (release); attachers spin until they observe it (acquire), so a
//     concurrent create/attach race never sees half-initialized mutexes.
//
// Dtypes: f32 / f64 accumulate natively.  Low-precision tensors convert on
// the Python side (same disposition as the reference's half.h custom-sum).

#include "bf_runtime.h"

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>

namespace {

constexpr unsigned long long kMagic = 0x62667769'6e646f77ULL;  // "bfwindow"

struct SlotHdr {
  pthread_mutex_t mu;
  long long deposits;  // total deposits ever (version)
  long long fresh;     // deposits since last consume
};

struct WinHdr {
  unsigned long long magic;  // set LAST (release) by the initializer
  int dtype;                 // 0 = f32, 1 = f64
  int n_slots;
  long long n_elems;
  long long nbytes;          // per buffer
  pthread_mutex_t self_mu;
};

size_t ElemSize(int dtype) { return dtype == 1 ? 8 : 4; }

size_t SegmentSize(int n_slots, long long nbytes) {
  return sizeof(WinHdr) + static_cast<size_t>(n_slots) * sizeof(SlotHdr) +
         static_cast<size_t>(n_slots + 1) * static_cast<size_t>(nbytes);
}

SlotHdr* Slots(WinHdr* h) { return reinterpret_cast<SlotHdr*>(h + 1); }

unsigned char* SelfBuf(WinHdr* h) {
  return reinterpret_cast<unsigned char*>(Slots(h) + h->n_slots);
}

unsigned char* SlotBuf(WinHdr* h, int k) {
  return SelfBuf(h) + static_cast<size_t>(k + 1) * h->nbytes;
}

// EOWNERDEAD: a process died holding the lock; mark consistent and proceed
// (our critical sections are idempotent-enough copies — at worst one torn
// deposit, observable through the version counter).
int LockMu(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

void InitHdr(WinHdr* h, int n_slots, long long n_elems, int dtype,
             bool pshared) {
  h->dtype = dtype;
  h->n_slots = n_slots;
  h->n_elems = n_elems;
  h->nbytes = static_cast<long long>(n_elems * ElemSize(dtype));
  pthread_mutexattr_t at;
  pthread_mutexattr_init(&at);
  if (pshared) {
    pthread_mutexattr_setpshared(&at, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&at, PTHREAD_MUTEX_ROBUST);
  }
  pthread_mutex_init(&h->self_mu, &at);
  SlotHdr* slots = Slots(h);
  for (int k = 0; k < n_slots; ++k) {
    pthread_mutex_init(&slots[k].mu, &at);
    slots[k].deposits = 0;
    slots[k].fresh = 0;
  }
  pthread_mutexattr_destroy(&at);
  // buffers are already zero (fresh anonymous mapping / ftruncate'd shm)
  __atomic_store_n(&h->magic, kMagic, __ATOMIC_RELEASE);
}

struct Window {
  WinHdr* hdr = nullptr;
  size_t len = 0;
  bool owner = false;       // unlink/destroy on free
  std::string shm_name;     // empty = anonymous (process-local)

  ~Window() {
    if (hdr == nullptr) return;
    munmap(hdr, len);
    if (owner && !shm_name.empty()) shm_unlink(shm_name.c_str());
  }
};

std::mutex g_table_mu;
std::unordered_map<std::string, std::shared_ptr<Window>> g_table;

std::shared_ptr<Window> Find(const char* name) {
  std::lock_guard<std::mutex> lock(g_table_mu);
  auto it = g_table.find(name ? name : "");
  return it == g_table.end() ? nullptr : it->second;
}

// shm object name: namespaced by uid so two users on a host cannot collide,
// '/'-free (POSIX requires exactly one leading slash).  The escape is
// injective ('_' -> '_u', '/' -> '_s') so distinct window names can never
// map to one shm object ("a/b" vs "a_b").  Names longer than NAME_MAX keep
// a readable prefix and replace the tail with a 64-bit FNV-1a digest of the
// FULL escaped name — a plain truncation would map every long per-rank
// window ("<long job name>:0", ":1", ...) onto ONE segment, silently
// crossing their deposits.
std::string ShmName(const char* name) {
  std::string s = "/bftwin_" + std::to_string(getuid()) + "_";
  for (const char* p = name; *p; ++p) {
    if (*p == '_') {
      s += "_u";
    } else if (*p == '/') {
      s += "_s";
    } else {
      s.push_back(*p);
    }
  }
  if (s.size() > 250) {
    unsigned long long h = 1469598103934665603ULL;  // FNV-1a 64
    for (char c : s) {
      h ^= static_cast<unsigned char>(c);
      h *= 1099511628211ULL;
    }
    char digest[20];
    snprintf(digest, sizeof(digest), "_h%016llx", h);
    s.resize(250 - 18);
    s += digest;
  }
  return s;
}

template <typename T>
void AddInto(unsigned char* dst, const unsigned char* src, long long n) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  for (long long i = 0; i < n; ++i) d[i] += s[i];
}

int Register(const char* name, std::shared_ptr<Window> w) {
  std::lock_guard<std::mutex> lock(g_table_mu);
  if (g_table.count(name)) return -2;  // already exists in this process
  g_table.emplace(name, std::move(w));
  return 0;
}

}  // namespace

extern "C" {

// Process-local window (rank-thread model): anonymous mapping, same layout.
int bf_win_create(const char* name, int n_slots, long long n_elems,
                  int dtype) {
  if (name == nullptr || n_slots < 0 || n_elems <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  size_t len = SegmentSize(n_slots, n_elems * ElemSize(dtype));
  void* map = mmap(nullptr, len, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (map == MAP_FAILED) return -1;
  auto w = std::make_shared<Window>();
  w->hdr = static_cast<WinHdr*>(map);
  w->len = len;
  w->owner = true;
  InitHdr(w->hdr, n_slots, n_elems, dtype, /*pshared=*/false);
  return Register(name, std::move(w));
}

// Cross-process window: named shm segment, process-shared robust mutexes.
// The caller is the OWNER (this rank's landing zone); peers attach.
// Returns 0, -2 if the shm object already exists (stale from a crashed run
// — clean with bf_win_shm_unlink — or a live duplicate), -1 on error.
int bf_win_create_shm(const char* name, int n_slots, long long n_elems,
                      int dtype) {
  if (name == nullptr || n_slots < 0 || n_elems <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  std::string sname = ShmName(name);
  int fd = shm_open(sname.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return errno == EEXIST ? -2 : -1;
  size_t len = SegmentSize(n_slots, n_elems * ElemSize(dtype));
  if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
    close(fd);
    shm_unlink(sname.c_str());
    return -1;
  }
  void* map =
      mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) {
    shm_unlink(sname.c_str());
    return -1;
  }
  auto w = std::make_shared<Window>();
  w->hdr = static_cast<WinHdr*>(map);
  w->len = len;
  w->owner = true;
  w->shm_name = sname;
  InitHdr(w->hdr, n_slots, n_elems, dtype, /*pshared=*/true);
  // on Register failure the moved-in Window's dtor both unmaps and (owner)
  // unlinks — a second unlink here could delete a segment some other
  // process legitimately re-created in between
  return Register(name, std::move(w));
}

// Attach a peer's shm window for depositing.  Spins up to timeout_ms for
// the owner to create AND publish (magic) the segment — creation order
// between processes is thereby free.  Returns 0, -1 on timeout/error, -3 on
// a malformed segment (size/magic mismatch).
int bf_win_attach_shm(const char* name, int timeout_ms) {
  if (name == nullptr) return -1;
  std::string sname = ShmName(name);
  const int step_us = 2000;
  long long waited_us = 0;
  int fd = -1;
  struct stat st;
  for (;;) {
    fd = shm_open(sname.c_str(), O_RDWR, 0600);
    if (fd >= 0 && fstat(fd, &st) == 0 && st.st_size >
        static_cast<off_t>(sizeof(WinHdr))) {
      break;  // owner has ftruncate'd to full size
    }
    if (fd >= 0) close(fd);
    fd = -1;
    if (waited_us / 1000 >= timeout_ms) return -1;
    usleep(step_us);
    waited_us += step_us;
  }
  size_t len = static_cast<size_t>(st.st_size);
  void* map = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -1;
  WinHdr* h = static_cast<WinHdr*>(map);
  while (__atomic_load_n(&h->magic, __ATOMIC_ACQUIRE) != kMagic) {
    if (waited_us / 1000 >= timeout_ms) {
      munmap(map, len);
      return -1;
    }
    usleep(step_us);
    waited_us += step_us;
  }
  if (SegmentSize(h->n_slots, h->nbytes) != len) {
    munmap(map, len);
    return -3;
  }
  auto w = std::make_shared<Window>();
  w->hdr = h;
  w->len = len;
  w->owner = false;  // peers never unlink
  w->shm_name = sname;
  return Register(name, std::move(w));
}

// Remove a (possibly stale) shm object by window name without mapping it.
// Returns 0 if unlinked, 1 if it did not exist, -1 on error.
int bf_win_shm_unlink(const char* name) {
  if (name == nullptr) return -1;
  if (shm_unlink(ShmName(name).c_str()) == 0) return 0;
  return errno == ENOENT ? 1 : -1;
}

int bf_win_exists(const char* name) { return Find(name) ? 1 : 0; }

// Window geometry for attachers: fills n_slots/n_elems/dtype, returns 0.
int bf_win_info(const char* name, int* n_slots, long long* n_elems,
                int* dtype) {
  auto w = Find(name);
  if (!w) return -1;
  if (n_slots) *n_slots = w->hdr->n_slots;
  if (n_elems) *n_elems = w->hdr->n_elems;
  if (dtype) *dtype = w->hdr->dtype;
  return 0;
}

int bf_win_free(const char* name) {
  std::lock_guard<std::mutex> lock(g_table_mu);
  return g_table.erase(name ? name : "") ? 0 : -1;
}

void bf_win_free_all() {
  std::lock_guard<std::mutex> lock(g_table_mu);
  g_table.clear();
}

// Deposit into a landing slot.  accumulate=0 replaces (MPI_Put), =1 adds
// (MPI_Accumulate with MPI_SUM).  Returns the slot's new version, <0 error.
long long bf_win_deposit(const char* name, int slot, const void* data,
                         long long n_elems, int accumulate) {
  auto w = Find(name);
  if (!w || slot < 0 || slot >= w->hdr->n_slots ||
      n_elems != w->hdr->n_elems || data == nullptr) {
    return -1;
  }
  WinHdr* h = w->hdr;
  SlotHdr& s = Slots(h)[slot];
  if (LockMu(&s.mu) != 0) return -1;
  const unsigned char* src = static_cast<const unsigned char*>(data);
  unsigned char* dst = SlotBuf(h, slot);
  if (accumulate) {
    if (h->dtype == 1) {
      AddInto<double>(dst, src, n_elems);
    } else {
      AddInto<float>(dst, src, n_elems);
    }
  } else {
    std::memcpy(dst, src, static_cast<size_t>(h->nbytes));
  }
  ++s.deposits;
  ++s.fresh;
  long long v = s.deposits;
  pthread_mutex_unlock(&s.mu);
  return v;
}

// Read a landing slot into out.  consume=1 zero-fills after the read (and
// resets the freshness counter) so accumulated push-sum mass is consumed
// exactly once.  Returns the number of deposits since the last consuming
// read (0 = nothing new landed; the caller decides how to treat staleness),
// <0 on error.
long long bf_win_read(const char* name, int slot, void* out, long long n_elems,
                      int consume) {
  auto w = Find(name);
  if (!w || slot < 0 || slot >= w->hdr->n_slots ||
      n_elems != w->hdr->n_elems || out == nullptr) {
    return -1;
  }
  WinHdr* h = w->hdr;
  SlotHdr& s = Slots(h)[slot];
  if (LockMu(&s.mu) != 0) return -1;
  unsigned char* buf = SlotBuf(h, slot);
  std::memcpy(out, buf, static_cast<size_t>(h->nbytes));
  long long fresh = s.fresh;
  if (consume) {
    std::memset(buf, 0, static_cast<size_t>(h->nbytes));
    s.fresh = 0;
  }
  pthread_mutex_unlock(&s.mu);
  return fresh;
}

// Deposits since the last consuming read of a slot, without copying its
// buffer (a harvester polls this and reads only slots where mass landed).
// <0 on error.
long long bf_win_fresh(const char* name, int slot) {
  auto w = Find(name);
  if (!w || slot < 0 || slot >= w->hdr->n_slots) return -1;
  SlotHdr& s = Slots(w->hdr)[slot];
  if (LockMu(&s.mu) != 0) return -1;
  long long fresh = s.fresh;
  pthread_mutex_unlock(&s.mu);
  return fresh;
}

int bf_win_set_self(const char* name, const void* data, long long n_elems) {
  auto w = Find(name);
  if (!w || n_elems != w->hdr->n_elems || data == nullptr) return -1;
  WinHdr* h = w->hdr;
  if (LockMu(&h->self_mu) != 0) return -1;
  std::memcpy(SelfBuf(h), data, static_cast<size_t>(h->nbytes));
  pthread_mutex_unlock(&h->self_mu);
  return 0;
}

int bf_win_read_self(const char* name, void* out, long long n_elems) {
  auto w = Find(name);
  if (!w || n_elems != w->hdr->n_elems || out == nullptr) return -1;
  WinHdr* h = w->hdr;
  if (LockMu(&h->self_mu) != 0) return -1;
  std::memcpy(out, SelfBuf(h), static_cast<size_t>(h->nbytes));
  pthread_mutex_unlock(&h->self_mu);
  return 0;
}

int bf_win_num_slots(const char* name) {
  auto w = Find(name);
  return w ? w->hdr->n_slots : -1;
}

}  // extern "C"
