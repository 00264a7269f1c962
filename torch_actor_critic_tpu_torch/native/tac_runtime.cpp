// tac_runtime: native synchronization core for the host-side runtime.
//
// The reference's host runtime is OpenMPI (process launch + collectives,
// ref sac/mpi.py); on TPU the gradient path rides XLA collectives over
// ICI instead (parallel/dp.py), but the *host* side still needs a fast
// process-parallel substrate to feed the chip: MuJoCo/dm_control physics
// is single-threaded C called from Python (SURVEY.md §7 hard part (e)).
//
// This library provides the low-latency cross-process synchronization
// layer under envs/vec_env.py's ParallelEnvPool: futex wait/wake on
// int32 words living in POSIX shared memory, so a step dispatch to N
// env worker processes costs N futex wakes (~1us each) and one
// futex-parked wait-all — no pipes, no pickling, no GIL handoff on the
// hot path. Observations/actions cross process boundaries through the
// same shared-memory block, written in place as rows of the batched
// arrays the trainer consumes (zero Python-level gathers).
//
// Futexes are SHARED (no FUTEX_PRIVATE_FLAG): the words live in shm
// mapped by multiple processes.
//
// All waits take a timeout; a worker that died mid-step surfaces as a
// timeout the pool turns into a diagnosed RuntimeError — the failure
// detection the reference lacks (its per-step comm.recv deadlocks
// forever on a dead rank, ref sac/algorithm.py:262-271; SURVEY.md §5).

#include <cerrno>
#include <cstdint>
#include <ctime>

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

long sys_futex(volatile int32_t* uaddr, int op, int32_t val,
               const struct timespec* timeout) {
  return syscall(SYS_futex, const_cast<int32_t*>(uaddr), op, val, timeout,
                 nullptr, 0);
}

int64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// Wait until *addr != old_val or the (absolute, CLOCK_MONOTONIC ns)
// deadline passes. deadline_ns < 0 waits forever. 0 = changed, -1 = timeout.
int wait_ne_deadline(volatile int32_t* addr, int32_t old_val,
                     int64_t deadline_ns) {
  while (__atomic_load_n(addr, __ATOMIC_SEQ_CST) == old_val) {
    struct timespec rel;
    struct timespec* relp = nullptr;
    if (deadline_ns >= 0) {
      int64_t remaining = deadline_ns - now_ns();
      if (remaining <= 0) return -1;
      rel.tv_sec = remaining / 1000000000;
      rel.tv_nsec = remaining % 1000000000;
      relp = &rel;
    }
    long r = sys_futex(addr, FUTEX_WAIT, old_val, relp);
    if (r == -1 && errno == ETIMEDOUT) return -1;
    // EAGAIN: value already changed; EINTR: signal — re-check either way.
  }
  return 0;
}

}  // namespace

extern "C" {

// Atomically store val into *addr and wake every futex waiter on it.
void tac_store_wake(volatile int32_t* addr, int32_t val) {
  __atomic_store_n(addr, val, __ATOMIC_SEQ_CST);
  sys_futex(addr, FUTEX_WAKE, INT32_MAX, nullptr);
}

int32_t tac_load(volatile int32_t* addr) {
  return __atomic_load_n(addr, __ATOMIC_SEQ_CST);
}

// Park until *addr != old_val. timeout_ms < 0 waits forever.
// Returns 0 on change, -1 on timeout.
int tac_wait_ne(volatile int32_t* addr, int32_t old_val, int64_t timeout_ms) {
  int64_t deadline = timeout_ms < 0 ? -1 : now_ns() + timeout_ms * 1000000;
  return wait_ne_deadline(addr, old_val, deadline);
}

// Park until words[i*stride] == targets[i*stride] for every i in [0, n).
// One shared deadline across the whole barrier. Returns 0, or -(i+1) for
// the first worker that had not acked at the deadline (its index is the
// diagnosis the pool reports).
int tac_wait_all_eq(volatile int32_t* words, volatile int32_t* targets,
                    int32_t n, int64_t stride, int64_t timeout_ms) {
  int64_t deadline = timeout_ms < 0 ? -1 : now_ns() + timeout_ms * 1000000;
  for (int32_t i = 0; i < n; ++i) {
    volatile int32_t* w = words + i * stride;
    int32_t want = __atomic_load_n(targets + i * stride, __ATOMIC_SEQ_CST);
    for (;;) {
      int32_t got = __atomic_load_n(w, __ATOMIC_SEQ_CST);
      if (got == want) break;
      if (wait_ne_deadline(w, got, deadline) != 0) return -(i + 1);
    }
  }
  return 0;
}

}  // extern "C"
