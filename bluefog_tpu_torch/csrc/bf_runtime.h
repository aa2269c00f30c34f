// bluefog_tpu_torch native host runtime — public C API.
//
// The port's own copy of the JAX package's host runtime (csrc/bf_runtime.h
// there), built into bluefog_tpu_torch/_build/ at first use and never
// shared with the JAX package's library.  Host C++ only, no CUDA: the
// device side of the port is the kernels in csrc/*.cu.  What it holds:
//
//   * an async op engine: a mutex-protected FIFO drained by a background
//     thread, firing enqueued host callbacks (checkpoint IO, metric
//     flushes) off the critical path;
//   * a handle manager with poll / wait-and-clear semantics (the reference's
//     nonblocking-op handle table);
//   * a chrome-trace timeline writer on its own thread;
//   * the passive-target window table (windows.cc) the asynchronous runners
//     deposit into, in process memory or in named shared memory;
//   * leveled logging controlled by BLUEFOG_TPU_LOG_LEVEL.
//
// Bound from Python via ctypes (runtime/native.py).

#ifndef BF_RUNTIME_H_
#define BF_RUNTIME_H_

#include <cstdint>

extern "C" {

// ---------------------------------------------------------------- logging --
// Levels: 0=trace 1=debug 2=info 3=warn 4=error 5=fatal(off).
int bf_log_level();
void bf_set_log_level(int level);
void bf_log(int level, const char* msg);

// --------------------------------------------------------------- timeline --
// Chrome trace-event JSON, written incrementally by a dedicated thread.
int bf_timeline_start(const char* path);   // 0 ok, <0 error
int bf_timeline_stop();                    // flush + close
int bf_timeline_active();
void bf_timeline_begin(const char* name, const char* cat, int64_t tid);
void bf_timeline_end(const char* name, const char* cat, int64_t tid);
void bf_timeline_instant(const char* name, const char* cat);
// Async-span helpers keyed by id (for overlapping ops, ph 'b'/'e').
void bf_timeline_async_begin(const char* name, const char* cat, int64_t id);
void bf_timeline_async_end(const char* name, const char* cat, int64_t id);

// ----------------------------------------------------------------- engine --
// Host callback executed on the engine thread; returns a status code
// (0 = OK; nonzero = op-defined error).
typedef int (*bf_callback)(void* arg);

int bf_engine_start();     // idempotent; spawns the background thread
int bf_engine_shutdown();  // drains the queue, joins the thread
int bf_engine_running();

// Enqueue a host op; returns a fresh handle (>=0), or -1 if not running.
int bf_enqueue(const char* op, const char* name, bf_callback cb, void* arg);

// Handle states: -1 = unknown handle, 0 = pending, 1 = done.
int bf_poll(int handle);
// Block until done (timeout_ms < 0 → forever).  Returns 0 and writes the
// callback's status to *status_out on success; -1 on unknown handle; -2 on
// timeout.  Keeping the op status out-of-band means callbacks may return any
// int without colliding with the sentinels.  Does NOT clear.
int bf_wait(int handle, int timeout_ms, int* status_out);
void bf_clear(int handle);      // forget a completed handle
int bf_wait_all(int timeout_ms);  // wait for every pending handle
int bf_pending_count();

// ---------------------------------------------------------------- windows --
// Passive-target landing buffers (windows.cc): the host-memory half of the
// one-sided window story.  A window owns a self buffer plus n_slots landing
// slots (one per in-neighbor, as in the reference's WinTorchStorageManager);
// writers deposit (put/accumulate) without any receiver involvement, and
// readers consume whenever they choose.  dtype: 0 = f32, 1 = f64.
int bf_win_create(const char* name, int n_slots, long long n_elems, int dtype);
// Cross-process variants: the segment lives in named POSIX shared memory
// (uid-namespaced), so a deposit from another OS process lands in the
// owner's window — the MPI_Put-across-process-boundaries semantic.  The
// creator owns (and unlinks on free); peers attach, spinning up to
// timeout_ms for the owner to publish.  bf_win_shm_unlink removes a stale
// segment (e.g. from a crashed run) by window name without mapping it.
int bf_win_create_shm(const char* name, int n_slots, long long n_elems,
                      int dtype);
int bf_win_attach_shm(const char* name, int timeout_ms);
int bf_win_shm_unlink(const char* name);
// Fills the window's geometry (any pointer may be NULL); -1 if unknown.
int bf_win_info(const char* name, int* n_slots, long long* n_elems,
                int* dtype);
int bf_win_exists(const char* name);
int bf_win_free(const char* name);
void bf_win_free_all();
// accumulate=0 replaces (MPI_Put), =1 adds (MPI_Accumulate MPI_SUM).
// Returns the slot's new deposit count, <0 on error.
long long bf_win_deposit(const char* name, int slot, const void* data,
                         long long n_elems, int accumulate);
// Returns deposits since the last consuming read (0 = stale); consume=1
// zero-fills after reading so accumulated mass is consumed exactly once.
long long bf_win_read(const char* name, int slot, void* out, long long n_elems,
                      int consume);
// Deposits since the last consuming read, without copying (<0 on error).
long long bf_win_fresh(const char* name, int slot);
int bf_win_set_self(const char* name, const void* data, long long n_elems);
int bf_win_read_self(const char* name, void* out, long long n_elems);
int bf_win_num_slots(const char* name);

}  // extern "C"

#endif  // BF_RUNTIME_H_
